"""Posteriogram -> note-event decoding on the host (numpy).

The port's own copy of the numpy path of `reconvat_tpu/decode.py`
(reference `model/decoding.py:4-55`): strict `>` thresholds, rising-edge
onsets (the first frame counts as an edge), rule1 additionally requires the
frame channel at the onset, a note extends while onset | frame stays active,
and notes come in row-major (time, pitch) order of their onsets. Binding
the native decoder of `native/` is later work.
"""
from __future__ import annotations

import numpy as np


def unpack_roll(packed, n_pitches=88):
    """Bit-packed (..., K) uint8 roll -> boolean (..., n_pitches).

    Inverse of the device-side packing (bit j of byte k = pitch k*8+j,
    little bit order — the layout `pack_roll_device` and bench.py emit).
    """
    packed = np.asarray(packed, dtype=np.uint8)
    bits = np.unpackbits(packed, axis=-1, bitorder="little")
    return bits[..., :n_pitches].astype(bool)


def extract_notes_packed_batch(onsets_packed, frames_packed=None,
                               n_pitches=88, rule="rule2"):
    """Decode a batch of device-thresholded, bit-packed (B, T, K) rolls.

    Returns a list of B (pitches (N,), intervals (N, 2)) pairs with the
    semantics of `extract_notes_wo_velocity` on the unpacked rolls.
    `frames_packed=None` reuses the onset roll as the frame roll (the
    ReconVAT transcribe contract: onset = frame = pianoroll).
    """
    if rule not in ("rule1", "rule2"):
        raise NameError("Please enter the correct rule name")
    on = np.ascontiguousarray(onsets_packed, dtype=np.uint8)
    if on.ndim != 3:
        raise ValueError(f"expected (B, T, K) packed roll, got {on.shape}")
    fr = on if frames_packed is None else np.ascontiguousarray(
        frames_packed, dtype=np.uint8)
    if fr.shape != on.shape:
        raise ValueError("onset/frame packed shapes differ")
    B, T, K = on.shape
    if K != (n_pitches + 7) // 8:
        raise ValueError(f"K={K} does not match n_pitches={n_pitches}")
    # bits are 0/1, so the default 0.5 thresholds reproduce the device's
    on_b = unpack_roll(on, n_pitches)
    fr_b = on_b if frames_packed is None else unpack_roll(fr, n_pitches)
    return [extract_notes_wo_velocity(on_b[b], fr_b[b], rule=rule)
            for b in range(B)]


def _as_bool(x, threshold):
    x = np.asarray(x)
    return x > threshold


def _next_inactive(active: np.ndarray) -> np.ndarray:
    """For boolean (T, P): index of the first inactive step at or after t.

    Returns int array (T+1, P); value T means "active through the end".
    """
    T, P = active.shape
    idx = np.where(~active, np.arange(T)[:, None], T).astype(np.int64)
    # reverse cumulative minimum: first inactive index >= t
    nz = np.minimum.accumulate(idx[::-1], axis=0)[::-1]
    return np.concatenate([nz, np.full((1, P), T, dtype=np.int64)], axis=0)


def extract_notes_wo_velocity(onsets, frames, onset_threshold=0.5,
                              frame_threshold=0.5, rule="rule1"):
    """Find note (pitch, [onset, offset]) events from onset/frame rolls.

    onsets, frames: float arrays (T, P). Returns (pitches (N,), intervals
    (N, 2)) in frame indices, matching reference
    `extract_notes_wo_velocity` (`model/decoding.py:4-55`).
    """
    if rule not in ("rule1", "rule2"):
        raise NameError("Please enter the correct rule name")

    on = _as_bool(onsets, onset_threshold)
    fr = _as_bool(frames, frame_threshold)

    onset_diff = np.concatenate([on[:1], on[1:] & ~on[:-1]], axis=0)
    if rule == "rule1":
        onset_diff = onset_diff & fr

    starts = np.argwhere(onset_diff)  # row-major (t, p), sorted by t then p
    if len(starts) == 0:
        return np.array([]), np.array([])

    active = on | fr
    nz = _next_inactive(active)
    t, p = starts[:, 0], starts[:, 1]
    offsets = nz[t, p]

    keep = offsets > t
    pitches = p[keep]
    intervals = np.stack([t[keep], offsets[keep]], axis=1)
    return pitches, intervals
