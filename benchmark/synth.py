"""Traffic made from the seed: synthetic piano-like clips with their note
rows and frame and onset labels. `synth_song` is a copy of
`chip_smoke.py:synth_song`, drawing from a `numpy.random.Generator` so
that any seed up to 2**64 is taken as it is."""
from __future__ import annotations

import numpy as np

SAMPLE_RATE, HOP, N_KEYS, MIN_MIDI = 16000, 512, 88, 21


def synth_song(rng, seconds: float):
    """(note rows (onset s, offset s, MIDI note, velocity), int16 audio):
    ~2 notes a second of three decaying harmonics, and a noise floor."""
    n = int(seconds * SAMPLE_RATE)
    n_notes = int(seconds * 2)
    onsets = np.sort(rng.random(n_notes) * (seconds - 1.5))
    rows = np.stack([onsets, onsets + 0.3 + rng.random(n_notes) * 0.8,
                     rng.integers(40, 90, n_notes),
                     rng.integers(40, 120, n_notes)], axis=1)
    x = rng.standard_normal(n) * 1e-3
    for onset, offset, note, vel in rows:
        i0, i1 = int(onset * SAMPLE_RATE), int(offset * SAMPLE_RATE)
        tt = np.arange(i1 - i0) / SAMPLE_RATE
        f0 = 440.0 * 2 ** ((note - 69) / 12.0)
        env = np.exp(-tt * 3.0) * vel / 127.0
        x[i0:i1] += env * sum(a * np.sin(2 * np.pi * f0 * h * tt)
                              for h, a in ((1, 1.0), (2, 0.5), (3, 0.25)))
    return rows, (x / np.abs(x).max() * 0.7 * 32767).astype(np.int16)


def labels(rows, n_frames: int):
    """(frame, onset) float32 (n_frames, 88) rolls of the note rows: a
    note is on from its onset frame to its offset frame, its onset marks
    one frame."""
    frame = np.zeros((n_frames, N_KEYS), np.float32)
    onset = np.zeros((n_frames, N_KEYS), np.float32)
    for t0, t1, note, _ in rows:
        p = int(note) - MIN_MIDI
        f0 = int(round(t0 * SAMPLE_RATE / HOP))
        f1 = max(f0 + 1, int(round(t1 * SAMPLE_RATE / HOP)))
        if 0 <= p < N_KEYS and f0 < n_frames:
            frame[f0:min(f1, n_frames), p] = 1.0
            onset[f0, p] = 1.0
    return frame, onset


def clips(rng, count: int, samples: int, with_labels: bool = False):
    """`count` int16 clips of `samples` samples (B, N), and with
    `with_labels` their (frame, onset) rolls (B, T, 88) each."""
    seconds = samples / SAMPLE_RATE
    n_frames = (samples - 1) // HOP + 1
    audio = np.empty((count, samples), np.int16)
    frame = np.empty((count, n_frames, N_KEYS), np.float32)
    onset = np.empty_like(frame)
    for i in range(count):
        rows, audio[i] = synth_song(rng, seconds)
        if with_labels:
            frame[i], onset[i] = labels(rows, n_frames)
    return (audio, frame, onset) if with_labels else audio
