"""Audio decode and wav write on the host (the port's copy of
`reconvat_tpu/data/audio_io.py`).

The reference reads audio through libsndfile (SoundFile,
`model/dataset.py:110`); neither is a dependency here. WAV decodes through
scipy, FLAC through the native decoder (`csrc/flac_decoder.cpp`, the port's
copy of `native/flac_decoder.cpp`, built with the host compiler at first
use by `kernels/_build.py`). Everything returns int16 mono numpy
+ sample rate, as `soundfile.read(path, dtype='int16')` gives them.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import _build


def read_wav(path: str):
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        pcm = data
    elif data.dtype == np.int32:
        pcm = (data >> 16).astype(np.int16)
    elif data.dtype in (np.float32, np.float64):
        pcm = np.clip(data * 32768.0, -32768, 32767).astype(np.int16)
    elif data.dtype == np.uint8:
        pcm = ((data.astype(np.int16) - 128) << 8)
    else:
        raise ValueError(f"unsupported wav dtype {data.dtype} in {path}")
    if pcm.ndim == 2:  # downmix like soundfile's callers expect mono input
        pcm = pcm.mean(axis=1).astype(np.int16)
    return pcm, int(sr)


def read_flac(path: str):
    lib = _build.load(_build.HOST)
    buf = ctypes.POINTER(ctypes.c_int16)()
    sr = ctypes.c_int(0)
    channels = ctypes.c_int(0)
    n = lib.flac_decode_file(path.encode(), ctypes.byref(buf),
                             ctypes.byref(sr), ctypes.byref(channels))
    if n < 0:
        raise ValueError(f"FLAC decode failed ({n}) for {path}")
    try:
        total = int(n) * channels.value
        pcm = np.ctypeslib.as_array(buf, shape=(total,)).copy()
    finally:
        lib.flac_free(buf)
    if channels.value > 1:
        pcm = pcm.reshape(-1, channels.value).mean(axis=1).astype(np.int16)
    return pcm, sr.value


def read_audio(path: str):
    """Returns (int16 mono pcm, sample_rate)."""
    lower = path.lower()
    if lower.endswith(".wav"):
        return read_wav(path)
    if lower.endswith(".flac"):
        return read_flac(path)
    raise ValueError(f"unsupported audio format: {path}")


def write_wav(path: str, pcm_int16: np.ndarray, sr: int):
    """16-bit PCM wav of `pcm_int16` at `sr` Hz (scipy)."""
    from scipy.io import wavfile

    wavfile.write(path, sr, np.asarray(pcm_int16, dtype=np.int16))
