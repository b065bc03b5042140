"""Fused STFT power + mel projection: CUDA kernel wrapper and plain version.

`mel_power` computes what the TPU kernel `_mel_kernel`
(`reconvat_tpu/ops/pallas_mel.py`) computes: centre reflect pad, frames of
n_fft samples every hop, windowed DFT against the cos/sin bases, power
re^2 + im^2 and the mel projection, (B, N) -> (B, T, n_mels). On a CUDA
tensor it launches `csrc/mel.cu`; on a CPU tensor it runs `mel_power_plain`,
the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import _build


def frame_audio(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, N) -> (B, T, n_fft) frames of the centre reflect-padded signal,
    T = N // hop + 1 (pad n_fft // 2 per side)."""
    pad = n_fft // 2
    if audio.shape[-1] <= pad:
        raise ValueError("signal shorter than reflect padding length")
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, n_fft, hop)


def mel_power_plain(audio, wcos, wsin, mel_basis, hop: int):
    """Plain PyTorch version. wcos/wsin (n_fft, n_freq), mel_basis
    (n_freq, n_mels)."""
    frames = frame_audio(audio, wcos.shape[0], hop)
    re = frames @ wcos
    im = frames @ wsin
    return (re * re + im * im) @ mel_basis


def mel_power(audio, wcos, wsin, mel_basis, hop: int):
    """(B, N) float32 audio -> (B, N // hop + 1, n_mels) mel power.

    CPU tensors take `mel_power_plain`; CUDA tensors launch the kernel (and
    count the launch in `mel_power.launches`) or raise. The kernel has no
    backward, so audio that needs a gradient raises rather than losing
    it."""
    if audio.device.type == "cpu":
        return mel_power_plain(audio, wcos, wsin, mel_basis, hop)
    if audio.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("mel_power: the CUDA kernel has no backward; "
                           "audio that requires grad needs mel_power_plain")
    if audio.device.type != "cuda" or audio.dim() != 2:
        raise ValueError(f"mel_power: expected (B, N) audio on CPU or CUDA, "
                         f"got {tuple(audio.shape)} on {audio.device}")
    B, N = audio.shape
    n_fft, n_freq = wcos.shape
    n_mels = mel_basis.shape[1]
    pad = n_fft // 2
    if N <= pad:
        raise ValueError("signal shorter than reflect padding length")
    _build.check_tensor("audio", audio, (B, N), audio.device)
    _build.check_tensor("wcos", wcos, (n_fft, n_freq), audio.device)
    _build.check_tensor("wsin", wsin, (n_fft, n_freq), audio.device)
    _build.check_tensor("mel_basis", mel_basis, (n_freq, n_mels), audio.device)
    n_frames = N // hop + 1
    lib = _build.load("mel")
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32,
                      device=audio.device)
    # per-frequency-chunk partial sums, added in a fixed order by the kernel
    partial = torch.empty((lib.mel_power_chunks(n_freq), B, n_frames, n_mels),
                          dtype=torch.float32, device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    err = lib.mel_power_launch(
        audio.data_ptr(), wcos.data_ptr(), wsin.data_ptr(),
        mel_basis.data_ptr(), partial.data_ptr(), out.data_ptr(), B, N,
        n_frames, n_fft, hop, pad, n_freq, n_mels, ctypes.c_void_p(stream))
    _build.check(err, "mel_power")
    mel_power.launches += 1
    return out


mel_power.launches = 0
