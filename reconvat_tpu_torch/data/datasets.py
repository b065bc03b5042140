"""The unlabeled input folder of the transcription CLI (the port's copy of
`reconvat_tpu/data/datasets.py:379-404`, reference
`model/dataset.py:446-511`)."""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from .. import constants as C
from . import audio_io


class ApplicationDataset:
    """Inference-only corpus: the folder's .flac and .wav files, 16 kHz,
    no labels."""

    def __init__(self, path):
        self.path = path
        self.data = []
        for audio_path in self.files(path):
            audio, sr = audio_io.read_audio(audio_path)
            if sr != C.SAMPLE_RATE:
                raise ValueError(
                    f"Please make sure the sampling rate is 16k.\n"
                    f"{audio_path} has a sampling rate of {sr}")
            self.data.append(dict(path=audio_path, audio=audio))

    def files(self, path):
        flacs = glob(os.path.join(path, "*.flac"))
        flacs.extend(glob(os.path.join(path, "*.wav")))
        return sorted(flacs)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        d = self.data[index]
        return dict(path=d["path"],
                    audio=d["audio"].astype(np.float32) / 32768.0)
