"""Serving path: a batch of int16 clips -> note events (PyTorch counterpart
of the pipeline that `bench.py:113-167` runs).

    int16 audio --H2D--> float / 32768 on the device -> ReconVAT.transcribe
    -> threshold + bit-pack on the device (32x fewer D2H bytes than fp32)
    -> async D2H on a side stream -> native host note decode (rule2)

`submit` enqueues the device work and the copy and returns at once, so a
caller can keep several batches in flight while the host decodes earlier
ones; `transcribe_batch` is submit + wait + decode.
"""
from __future__ import annotations

import torch

from . import decode
from .models.common import pack_roll_device


class PendingBatch:
    """Packed rolls of one batch on their way to the host."""

    def __init__(self, packed_host: torch.Tensor, done):
        self._packed = packed_host
        self._done = done          # CUDA event, or None on the CPU

    def packed(self) -> torch.Tensor:
        """Wait for the copy; (B, T, 11) uint8 on the host."""
        if self._done is not None:
            self._done.synchronize()
        return self._packed

    def notes(self):
        """Decoded notes: a list of B (pitches, intervals) pairs."""
        return decode.extract_notes_packed_batch(self.packed().numpy(),
                                                 rule="rule2")


def submit(model, audio_i16, copy_stream=None) -> PendingBatch:
    """Enqueue one (B, N) int16 batch (numpy or tensor) on `model`'s
    device. On CUDA the packed roll is copied to pinned host memory on
    `copy_stream` (a new side stream if None) after the compute stream has
    produced it."""
    device = model.device
    audio = torch.as_tensor(audio_i16)
    if audio.dtype != torch.int16 or audio.dim() != 2:
        raise ValueError(f"expected (B, N) int16 audio, got {audio.dtype} "
                         f"{tuple(audio.shape)}")
    if device.type == "cuda" and audio.device.type == "cpu":
        audio = audio.pin_memory()
    audio = audio.to(device, non_blocking=True).to(torch.float32) / 32768.0
    packed = pack_roll_device(model.transcribe(audio)["frame"])
    if device.type != "cuda":
        return PendingBatch(packed, None)
    stream = copy_stream or torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(packed, non_blocking=True)
        packed.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
    return PendingBatch(host, done)


def transcribe_batch(model, audio_i16, copy_stream=None):
    """(B, N) int16 clips -> list of B (pitches, intervals) note lists."""
    return submit(model, audio_i16, copy_stream).notes()
