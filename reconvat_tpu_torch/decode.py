"""Posteriogram -> note-event decoding on the host.

`extract_notes_wo_velocity` (float rolls) and `extract_notes_packed_batch`
(the serving path's bit-packed batches) call the native decoder,
`csrc/note_extract.cpp` (the port's copy of `native/note_extract.cpp`),
built with the host compiler at first use (`kernels/_build.py`)
and bound by ctypes, which releases the GIL for the call. A failed build
raises with the compiler's output; nothing falls back to numpy. Each native
call adds one to the function's `calls`.

The `*_plain` functions are the port's copy of the numpy path of
`reconvat_tpu/decode.py` (reference `model/decoding.py:4-55`): the plain
versions the tests and `chip_smoke.py` hold the native decoder against.
`extract_notes` (notes with their mean onset-channel velocity),
`notes_to_roll` and `notes_to_frames` are numpy copies of the JAX
package's (reference `model/decoding.py:58-130`).
Both keep the reference semantics: strict `>` thresholds, rising-edge
onsets (the first frame counts as an edge), rule1 additionally requires the
frame channel at the onset, a note extends while onset | frame stays
active, and notes come in row-major (time, pitch) order of their onsets.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .kernels import _build


def unpack_roll(packed, n_pitches=88):
    """Bit-packed (..., K) uint8 roll -> boolean (..., n_pitches).

    Inverse of the device-side packing (bit j of byte k = pitch k*8+j,
    little bit order — the layout `pack_roll_device` and bench.py emit).
    """
    packed = np.asarray(packed, dtype=np.uint8)
    bits = np.unpackbits(packed, axis=-1, bitorder="little")
    return bits[..., :n_pitches].astype(bool)


def _check_rule(rule):
    if rule not in ("rule1", "rule2"):
        raise NameError("Please enter the correct rule name")


def _check_packed(onsets_packed, frames_packed, n_pitches):
    """(on, fr, B, T, K) of a packed batch; fr is on when frames_packed is
    None."""
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
    return on, fr, B, T, K


def _take_notes(lib, buf, n, what):
    """The (n, 3) int32 (pitch, onset, offset) rows the native call
    allocated at `buf`, copied; the native buffer is freed."""
    try:
        if n < 0:
            raise (MemoryError if n == -1 else ValueError)(
                f"native {what} failed ({n})")
        if n == 0:
            return np.zeros((0, 3), np.int32)
        return np.ctypeslib.as_array(buf, shape=(int(n), 3)).copy()
    finally:
        if buf:
            lib.notes_free(buf)


def extract_notes_packed_batch(onsets_packed, frames_packed=None,
                               n_pitches=88, rule="rule2"):
    """Decode a batch of device-thresholded, bit-packed (B, T, K) rolls in
    one native call (bitwise rising edges on 64-bit lanes).

    Returns a list of B (pitches (N,), intervals (N, 2)) pairs with the
    semantics of `extract_notes_wo_velocity` on the unpacked rolls.
    `frames_packed=None` reuses the onset roll as the frame roll (the
    ReconVAT transcribe contract: onset = frame = pianoroll). P <= 128.
    """
    _check_rule(rule)
    on, fr, B, T, K = _check_packed(onsets_packed, frames_packed, n_pitches)
    if n_pitches > 128:
        raise ValueError(f"the native decoder takes n_pitches <= 128, got "
                         f"{n_pitches}")
    lib = _build.load(_build.HOST)
    buf = ctypes.POINTER(ctypes.c_int32)()
    counts = np.zeros(B, np.int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    n = lib.extract_notes_packed_batch(
        on.ctypes.data_as(u8), fr.ctypes.data_as(u8), B, T, K, n_pitches,
        1 if rule == "rule1" else 0, ctypes.byref(buf),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    extract_notes_packed_batch.calls += 1
    flat = _take_notes(lib, buf, n, "extract_notes_packed_batch")
    out, pos = [], 0
    for c in counts:
        chunk = flat[pos:pos + c]
        pos += c
        out.append((chunk[:, 0], chunk[:, 1:3]) if c
                   else (np.array([]), np.array([])))
    return out


extract_notes_packed_batch.calls = 0


def extract_notes_packed_batch_plain(onsets_packed, frames_packed=None,
                                     n_pitches=88, rule="rule2"):
    """numpy version of `extract_notes_packed_batch`: unpack, then the
    float-roll plain path (bits are 0/1, so the default 0.5 thresholds
    reproduce the device's)."""
    _check_rule(rule)
    on, fr, B, _, _ = _check_packed(onsets_packed, frames_packed, n_pitches)
    on_b = unpack_roll(on, n_pitches)
    fr_b = on_b if frames_packed is None else unpack_roll(fr, n_pitches)
    return [extract_notes_wo_velocity_plain(on_b[b], fr_b[b], rule=rule)
            for b in range(B)]


def extract_notes_wo_velocity(onsets, frames, onset_threshold=0.5,
                              frame_threshold=0.5, rule="rule1"):
    """Find note (pitch, [onset, offset]) events from onset/frame float
    rolls (T, P) in one native call. Returns (pitches (N,), intervals
    (N, 2)) in frame indices, matching reference
    `extract_notes_wo_velocity` (`model/decoding.py:4-55`)."""
    _check_rule(rule)
    on = np.ascontiguousarray(onsets, dtype=np.float32)
    fr = np.ascontiguousarray(frames, dtype=np.float32)
    if on.ndim != 2 or fr.shape != on.shape:
        raise ValueError(f"expected two (T, P) rolls, got {on.shape} and "
                         f"{fr.shape}")
    T, P = on.shape
    lib = _build.load(_build.HOST)
    buf = ctypes.POINTER(ctypes.c_int32)()
    f32 = ctypes.POINTER(ctypes.c_float)
    n = lib.extract_notes(on.ctypes.data_as(f32), fr.ctypes.data_as(f32),
                          T, P, onset_threshold, frame_threshold,
                          1 if rule == "rule1" else 0, ctypes.byref(buf))
    extract_notes_wo_velocity.calls += 1
    notes = _take_notes(lib, buf, n, "extract_notes")
    if len(notes) == 0:
        return np.array([]), np.array([])
    return notes[:, 0], notes[:, 1:3]


extract_notes_wo_velocity.calls = 0


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


def extract_notes_wo_velocity_plain(onsets, frames, onset_threshold=0.5,
                                    frame_threshold=0.5, rule="rule1"):
    """numpy version of `extract_notes_wo_velocity`."""
    _check_rule(rule)

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


def extract_notes(onsets, frames, velocity, onset_threshold=0.5,
                  frame_threshold=0.5):
    """Note events + mean onset-channel velocity per note.

    Matches reference `extract_notes` (`model/decoding.py:58-106`): velocity
    samples are collected at steps where the onset channel stays active
    within [onset, offset).
    """
    on = _as_bool(onsets, onset_threshold)
    fr = _as_bool(frames, frame_threshold)
    velocity = np.asarray(velocity)

    onset_diff = np.concatenate([on[:1], on[1:] & ~on[:-1]], axis=0)
    starts = np.argwhere(onset_diff)
    if len(starts) == 0:
        return np.array([]), np.array([]), np.array([])

    active = on | fr
    nz = _next_inactive(active)
    t, p = starts[:, 0], starts[:, 1]
    offsets = nz[t, p]

    # cumulative sums for velocity averaging over active-onset steps
    onf = on.astype(np.float64)
    cs_v = np.concatenate([np.zeros((1,) + on.shape[1:]),
                           np.cumsum(velocity * onf, axis=0)], axis=0)
    cs_n = np.concatenate([np.zeros((1,) + on.shape[1:]),
                           np.cumsum(onf, axis=0)], axis=0)

    keep = offsets > t
    t, p, offsets = t[keep], p[keep], offsets[keep]
    vsum = cs_v[offsets, p] - cs_v[t, p]
    vcnt = cs_n[offsets, p] - cs_n[t, p]
    vels = np.where(vcnt > 0, vsum / np.maximum(vcnt, 1), 0.0)

    intervals = np.stack([t, offsets], axis=1)
    return p, intervals, vels


def notes_to_roll(pitches, intervals, shape):
    """Note list -> binary pianoroll (the dense half of notes_to_frames;
    `metrics.evaluate_multipitch_rolls` consumes it directly).

    Interval-union via a +1/-1 difference array + cumsum instead of one
    slice assignment per note: identical to `roll[on:off, p] = 1` per
    note (overlaps union to 1 either way)."""
    shape = tuple(shape)
    pitches = np.asarray(pitches, dtype=np.int64).ravel()
    if len(pitches) == 0:
        return np.zeros(shape)
    iv = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    on = np.clip(iv[:, 0], 0, shape[0])
    off = np.clip(np.maximum(iv[:, 1], on), 0, shape[0])
    diff = np.zeros((shape[0] + 1, shape[1]), dtype=np.int64)
    np.add.at(diff, (on, pitches), 1)
    np.add.at(diff, (off, pitches), -1)
    return (np.cumsum(diff[:-1], axis=0) > 0).astype(float)


def notes_to_frames(pitches, intervals, shape):
    """Note list -> per-frame active-pitch lists for multipitch metrics.

    Matches reference `notes_to_frames` (`model/decoding.py:109-130`).
    """
    roll = notes_to_roll(pitches, intervals, shape)
    time = np.arange(roll.shape[0])
    freqs = [roll[t, :].nonzero()[0] for t in time]
    return time, freqs
