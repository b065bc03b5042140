"""Mel spectrogram frontend (PyTorch counterpart of
`reconvat_tpu/ops/spectrogram.py`: `STFT.power`, `MelSpectrogram`,
`make_frontend("Mel")`).

The STFT is framing plus two matmuls against precomputed windowed DFT bases
(the reference's conv1d against Fourier kernels, reference
`model/Spectrogram.py:219-231`), and the mel projection one more matmul; on
a CUDA tensor the fused `mel_power` kernel computes the same function with
an FFT per frame from the window alone. Outputs are time-major (B, T, bins).
The bases and what the kernel reads in their place (the window, the FFT's
twiddle table, each mel column's band of nonzero rows) are non-persistent
buffers: they follow the module's device but are not part of its
state_dict.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from . import filterbanks as fb
from .mel_kernel import (fft_twiddles, frame_audio, mel_band, mel_power,
                         mel_power_plain)


class STFT(nn.Module):
    """Power STFT, centre reflect padding, `freq_scale='no'` (reference
    `model/Spectrogram.py:104-231`)."""

    def __init__(self, n_fft: int = 2048, win_length: int | None = None,
                 hop_length: int | None = None, window: str = "hann"):
        super().__init__()
        win_length = win_length or n_fft
        self.n_fft = n_fft
        self.hop_length = hop_length or win_length // 4
        wcos, wsin = fb.fourier_kernels(n_fft, win_length, None, window)
        # (n_fft, bins) for right-multiplication of frames
        self.register_buffer("wcos", torch.from_numpy(wcos.T.copy()),
                             persistent=False)
        self.register_buffer("wsin", torch.from_numpy(wsin.T.copy()),
                             persistent=False)
        # the window alone: bin 0 of the cos basis (cos 0 = 1), bit for bit
        self.register_buffer("window", torch.from_numpy(wcos[0].copy()),
                             persistent=False)

    def power(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, bins) power spectrogram |STFT|^2."""
        frames = frame_audio(x, self.n_fft, self.hop_length)
        real = frames @ self.wcos
        imag = frames @ self.wsin
        return real * real + imag * imag


class MelSpectrogram(nn.Module):
    """|STFT|^2 projected onto the slaney mel filterbank (norm=1, htk=False),
    reference nnAudio MelSpectrogram (`model/Spectrogram.py:396-461`).

    `use_kernel` (default True) sends the whole frontend through the fused
    `mel_power` wrapper, which launches the CUDA kernel on a CUDA tensor and
    runs its plain version on a CPU tensor; False runs the plain version on
    any device (the comparison run of the serving path)."""

    def __init__(self, sr: int = 22050, n_fft: int = 2048,
                 win_length: int | None = None, n_mels: int = 128,
                 hop_length: int = 512, window: str = "hann",
                 fmin: float = 0.0, fmax: float | None = None):
        super().__init__()
        self.stft = STFT(n_fft=n_fft, win_length=win_length,
                         hop_length=hop_length, window=window)
        basis = fb.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
        self.register_buffer("mel_basis", torch.from_numpy(basis.T.copy()),
                             persistent=False)      # (bins, n_mels)
        # what the CUDA kernel reads in place of the bases, derived once
        self.register_buffer("twiddle", fft_twiddles(n_fft), persistent=False)
        self.register_buffer("band", mel_band(self.mel_basis),
                             persistent=False)
        self.n_mels = n_mels
        self.use_kernel = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, n_mels)."""
        args = (x.contiguous(), self.stft.wcos, self.stft.wsin,
                self.mel_basis, self.stft.hop_length)
        if self.use_kernel:
            return mel_power(*args, self.stft.window, self.twiddle, self.band)
        return mel_power_plain(*args)


def make_frontend(spec: str = "Mel", sr: int | None = None,
                  hop_length: int | None = None, n_bins: int | None = None):
    """Frontend factory (reference `model/self_attention_VAT.py:1019-1039`).
    Returns (frontend, n_bins). Only the 'Mel' frontend is ported."""
    if spec != "Mel":
        raise ValueError(f"frontend {spec!r} is not ported; only 'Mel'")
    n_bins = n_bins or C.N_BINS
    return MelSpectrogram(sr=sr or C.SAMPLE_RATE, n_fft=C.WINDOW_LENGTH,
                          win_length=C.WINDOW_LENGTH, n_mels=n_bins,
                          hop_length=hop_length or C.HOP_LENGTH,
                          fmin=C.MEL_FMIN, fmax=C.MEL_FMAX), n_bins
