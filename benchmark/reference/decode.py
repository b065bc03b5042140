"""Plain numpy reference of the serving path's note decode (reference
`model/decoding.py:extract_notes_wo_velocity`, rule2, with the onset roll
equal to the frame roll): a note starts at each rising edge of a pitch's
roll (the first frame counts as an edge) and lasts while the roll stays
on; notes come in (onset frame, pitch) order."""
from __future__ import annotations

import numpy as np


def unpack(packed, n_pitches: int = 88) -> np.ndarray:
    """(..., K) uint8, bit j of byte k = pitch 8k + j -> bool (..., P)."""
    bits = np.unpackbits(np.asarray(packed, np.uint8), axis=-1,
                         bitorder="little")
    return bits[..., :n_pitches].astype(bool)


def notes(roll: np.ndarray):
    """bool (T, P) -> (pitches (N,), intervals (N, 2)) in frames."""
    found = []
    length = roll.shape[0]
    for pitch in range(roll.shape[1]):
        col = roll[:, pitch].astype(np.int8)
        edges = np.diff(np.concatenate([[0], col, [0]]))
        starts = np.flatnonzero(edges == 1)
        ends = np.flatnonzero(edges == -1)
        found += [(int(t0), pitch, int(min(t1, length)))
                  for t0, t1 in zip(starts, ends)]
    found.sort()
    pitches = np.array([f[1] for f in found], dtype=np.int64)
    intervals = np.array([[f[0], f[2]] for f in found],
                         dtype=np.int64).reshape(-1, 2)
    return pitches, intervals


def same_notes(got, want) -> bool:
    gp, gi = got
    wp, wi = want
    return (np.array_equal(np.asarray(gp, np.int64).ravel(), wp)
            and np.array_equal(np.asarray(gi, np.int64).reshape(-1, 2), wi))
