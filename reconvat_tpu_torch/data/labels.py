"""TSV note table -> piano-roll label codes (the port's copy of
`reconvat_tpu/data/labels.py`).

Reproduces the reference label roll construction
(`model/dataset.py:116-138`): per note, code 3 for HOPS_IN_ONSET steps from
the rounded onset, 2 until the rounded offset, 1 for HOPS_IN_OFFSET steps
after, 0 elsewhere; velocity roll holds MIDI velocity over [onset, offset).
Derived masks (`model/dataset.py:63-66`): onset = (label == 3),
offset = (label == 1), frame = (label > 1).
"""
from __future__ import annotations

import numpy as np

from .. import constants as C


def tsv_to_rolls(midi_rows: np.ndarray, audio_length: int):
    """midi_rows: (N, 4) float array of (onset_s, offset_s, note, velocity).

    Returns (label uint8 (n_steps, 88), velocity uint8 (n_steps, 88)) with
    n_steps = (audio_length - 1) // HOP_LENGTH + 1.
    """
    n_keys = C.MAX_MIDI - C.MIN_MIDI + 1
    n_steps = (audio_length - 1) // C.HOP_LENGTH + 1
    label = np.zeros((n_steps, n_keys), dtype=np.uint8)
    velocity = np.zeros((n_steps, n_keys), dtype=np.uint8)

    midi_rows = np.atleast_2d(np.asarray(midi_rows, dtype=np.float64))
    if midi_rows.size == 0:
        return label, velocity
    for onset, offset, note, vel in midi_rows:
        left = int(round(onset * C.SAMPLE_RATE / C.HOP_LENGTH))
        onset_right = min(n_steps, left + C.HOPS_IN_ONSET)
        frame_right = int(round(offset * C.SAMPLE_RATE / C.HOP_LENGTH))
        frame_right = min(n_steps, frame_right)
        offset_right = min(n_steps, frame_right + C.HOPS_IN_OFFSET)

        f = int(note) - C.MIN_MIDI
        if f < 0 or f >= n_keys:
            continue
        label[left:onset_right, f] = 3
        label[onset_right:frame_right, f] = 2
        label[frame_right:offset_right, f] = 1
        velocity[left:frame_right, f] = int(vel)
    return label, velocity


def label_to_masks(label: np.ndarray):
    """label codes -> float (onset, offset, frame) masks."""
    onset = (label == 3).astype(np.float32)
    offset = (label == 1).astype(np.float32)
    frame = (label > 1).astype(np.float32)
    return onset, offset, frame


def load_tsv(path: str) -> np.ndarray:
    """Read a reference-format note tsv (header row skipped)."""
    return np.loadtxt(path, delimiter="\t", skiprows=1, ndmin=2)


def save_tsv(path: str, midi_rows: np.ndarray):
    np.savetxt(path, midi_rows, fmt="%.6f", delimiter="\t",
               header="onset\toffset\tnote\tvelocity")
