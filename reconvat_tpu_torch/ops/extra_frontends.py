"""Library frontends (PyTorch counterpart of
`reconvat_tpu/ops/extra_frontends.py`): MFCC, Gammatonegram, DFT, ISTFT,
GriffinLim, CQT1992, CQT2010 and CQT2010v2, with `overlap_add`.

None of them is reachable from the reference's entry points; they are the
rest of the vendored nnAudio surface (reference `model/Spectrogram.py:
469-711, 932-1161, 1654-2092`). Their device work is FFTs (`torch.fft`,
cuFFT on the card), 1-D convolutions (`F.conv1d`) and products, fp32 with
TF32 off (`models.base.fp32_math`), as the JAX package computes them outside
any Pallas kernel. `MFCC` alone reaches a hand-written kernel: its
`MelSpectrogram` launches `csrc/mel.cu` on a CUDA tensor when that kernel
computes its settings.

Every constant is a real buffer, so `.to(device)` moves it and `.double()`
makes it float64; a complex basis is kept as its real and imaginary parts
and joined in the forward, so `.double()` gives complex128 arithmetic
(`Module.double()` casts no complex tensor). Outputs are time-major
(B, T, bins), as the JAX package's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.base import fp32_math
from . import filterbanks as fb
from .mel_kernel import frame_audio
from .spectrogram import STFT, MelSpectrogram, reflect_pad


def _buffer(module: nn.Module, name: str, array: np.ndarray) -> None:
    """A non-persistent float32 buffer of `array`."""
    module.register_buffer(
        name, torch.from_numpy(np.ascontiguousarray(array, np.float32)),
        persistent=False)


def _window(window: str, n_fft: int) -> np.ndarray:
    return fb.pad_center(fb.get_window(window, n_fft), n_fft)


def _complex_basis(module: nn.Module, name: str, basis: np.ndarray) -> None:
    """`basis` (complex) as two float32 buffers, `name`_real and
    `name`_imag: complex64 values, cast by `.double()` to float64."""
    basis = basis.astype(np.complex64)
    _buffer(module, name + "_real", basis.real)
    _buffer(module, name + "_imag", basis.imag)


def _joined(module: nn.Module, name: str) -> torch.Tensor:
    return torch.complex(getattr(module, name + "_real"),
                         getattr(module, name + "_imag"))


class MFCC(nn.Module):
    """Mel spectrogram -> power_to_db -> DCT-II over the mel axis
    (reference `MFCC`, `model/Spectrogram.py:469-591`); `kwargs` go to
    `MelSpectrogram` (22.05 kHz and 128 mels by default; `center`,
    `pad_mode`, `power`, `htk` and `norm` among them).

    The mel power takes `MelSpectrogram`'s route, fixed when it is built:
    the `mel_power` kernel (`csrc/mel.cu`, counted in
    `mel_power.launches`) on a CUDA tensor where the kernel computes the
    settings (`melspec.kernel_computes`: 2048 points, centred, reflect
    padding, power 2), its plain version otherwise, on any device."""

    def __init__(self, sr=22050, n_mfcc=20, norm="ortho", ref=1.0,
                 amin=1e-10, top_db=80.0, **kwargs):
        super().__init__()
        self.melspec = MelSpectrogram(sr=sr, **kwargs)
        self.n_mfcc = n_mfcc
        self.norm = norm
        self.amin = float(amin)
        self.ref = abs(float(ref))
        self.top_db = top_db
        _buffer(self, "dct_basis", self.dct_matrix(self.melspec.n_mels))

    def dct_matrix(self, n: int) -> np.ndarray:
        """(n, n_mfcc) DCT-II basis for right-multiplication, orthonormal
        when `norm` is 'ortho', else scaled by 2 (float64)."""
        k = np.arange(self.n_mfcc)[:, None]
        basis = np.cos(np.pi * k * (2 * np.arange(n)[None, :] + 1) / (2 * n))
        if self.norm == "ortho":
            basis[0] *= 1.0 / np.sqrt(n)
            basis[1:] *= np.sqrt(2.0 / n)
        else:
            basis *= 2.0
        return basis.T

    def _power_to_db(self, S: torch.Tensor) -> torch.Tensor:
        log_spec = 10.0 * torch.log10(torch.clamp_min(S, self.amin))
        log_spec = log_spec - 10.0 * math.log10(max(self.amin, self.ref))
        if self.top_db is not None:
            batch_max = log_spec.reshape(log_spec.shape[0], -1).amax(1)
            log_spec = torch.maximum(
                log_spec, batch_max[:, None, None] - self.top_db)
        return log_spec

    def _dct(self, x: torch.Tensor) -> torch.Tensor:
        """DCT-II over the last axis (of n_mels)."""
        return x @ self.dct_basis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, n_mfcc)."""
        with fp32_math():
            return self._dct(self._power_to_db(self.melspec(x)))


class Gammatonegram(nn.Module):
    """|STFT|^power projected on a 4th-order gammatone filterbank
    (reference `Gammatonegram`, `model/Spectrogram.py:594-709`), on the
    port's `STFT.power`."""

    def __init__(self, sr=44100, n_fft=2048, n_bins=64, hop_length=512,
                 window="hann", center=True, pad_mode="reflect", power=2.0,
                 fmin=20.0, fmax=None):
        super().__init__()
        self.stft = STFT(n_fft=n_fft, hop_length=hop_length, window=window,
                         center=center, pad_mode=pad_mode)
        self.power = power
        basis = fb.gammatone_filterbank(sr, n_fft, n_bins, fmin, fmax)
        _buffer(self, "basis", basis.T)          # (bins, n_bins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, n_bins)."""
        with fp32_math():
            mag = torch.sqrt(self.stft.power(x)) ** self.power
            return mag @ self.basis


class DFT(nn.Module):
    """Full (two-sided) DFT of windowed frames, returning (real, imag)
    (reference `DFT`, `model/Spectrogram.py:1654-1752`), and its inverse."""

    def __init__(self, n_fft=2048, hop_length=512, window="hann",
                 center=True, pad_mode="reflect"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.center = center
        self.pad_mode = pad_mode
        _buffer(self, "window", _window(window, n_fft))

    def forward(self, x: torch.Tensor):
        """(B, L) -> (real (B, T, n_fft), imag (B, T, n_fft))."""
        frames = frame_audio(x, self.n_fft, self.hop_length, self.center,
                             self.pad_mode)
        spec = torch.fft.fft(frames * self.window, dim=-1)
        return spec.real, spec.imag

    def inverse(self, real, imag, length=None):
        frames = torch.fft.ifft(torch.complex(real, imag), dim=-1).real
        return overlap_add(frames * self.window, self.hop_length,
                           self.window, self.n_fft, self.center, length)


def _fold(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, N) -> (B, (T - 1) hop + N): frame t added at t hop."""
    B, T, N = frames.shape
    total = (T - 1) * hop + N
    return F.fold(frames.transpose(1, 2), (1, total), (1, N),
                  stride=(1, hop)).reshape(B, total)


def overlap_add(frames, hop, window, n_fft, center=True, length=None):
    """Windowed overlap-add with window-sum-square normalization
    (reference iSTFT tail, `model/Spectrogram.py:283-311`): the frames
    (B, T, N) summed at their hops by `F.fold`, divided by the sum of the
    squared window at each sample (1 where that sum is 1e-10 or less),
    then cropped by n_fft // 2 at the front (with `center`) to `length`
    samples, or also at the back when `length` is None."""
    T = frames.shape[1]
    sig = _fold(frames, hop)
    wss = _fold((window * window).expand(1, T, -1), hop)
    sig = sig / torch.where(wss > 1e-10, wss, torch.ones_like(wss))
    pad = n_fft // 2
    if length is None:
        return sig[:, pad:-pad] if center else sig
    return sig[:, pad:pad + length] if center else sig[:, :length]


class ISTFT(nn.Module):
    """Inverse STFT from complex spectrograms (reference `iSTFT`,
    `model/Spectrogram.py:1753-1961` and `STFT.inverse`:239-311)."""

    def __init__(self, n_fft=2048, hop_length=None, window="hann",
                 center=True):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.center = center
        _buffer(self, "window", _window(window, n_fft))

    def forward(self, real, imag, onesided=True, length=None):
        """real/imag (B, T, bins) -> waveform (B, L)."""
        spec = torch.complex(real, imag)
        if onesided:
            frames = torch.fft.irfft(spec, n=self.n_fft, dim=-1)
        else:
            frames = torch.fft.ifft(spec, dim=-1).real
        return overlap_add(frames * self.window, self.hop_length,
                           self.window, self.n_fft, self.center, length)


class GriffinLim(nn.Module):
    """Griffin-Lim phase retrieval with momentum (reference `Griffin_Lim`,
    `model/Spectrogram.py:1962-2092`). The initial phase is drawn from a
    `torch.Generator` (`initial_phase`; seed 0 when none is given) where
    the JAX class takes a PRNG key."""

    def __init__(self, n_fft=2048, hop_length=None, window="hann",
                 center=True, n_iter=32, momentum=0.99):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.n_iter = n_iter
        self.momentum = momentum
        self.istft = ISTFT(n_fft=n_fft, hop_length=self.hop_length,
                           window=window, center=center)

    def _stft_complex(self, x: torch.Tensor) -> torch.Tensor:
        frames = frame_audio(x, self.n_fft, self.hop_length)
        return torch.fft.rfft(frames * self.istft.window, dim=-1)

    @staticmethod
    def initial_phase(shape, generator: torch.Generator,
                      like: torch.Tensor) -> torch.Tensor:
        """Phases uniform in [-pi, pi), drawn on the host from `generator`
        and moved to `like`'s device and dtype."""
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return (u * (2 * math.pi) - math.pi).to(like.device, like.dtype)

    def forward(self, magnitude, generator=None, length=None):
        """magnitude (B, T, bins) -> waveform (B, L)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        angles = torch.polar(torch.ones_like(magnitude), self.initial_phase(
            magnitude.shape, generator, magnitude))
        rebuilt = torch.zeros_like(angles)
        for _ in range(self.n_iter):
            tprev = rebuilt
            spec = magnitude * angles
            inverse = self.istft(spec.real, spec.imag, length=length)
            rebuilt = self._stft_complex(inverse)
            update = rebuilt - (self.momentum / (1 + self.momentum)) * tprev
            angles = update / torch.clamp_min(update.abs(), 1e-16)
        spec = magnitude * angles
        return self.istft(spec.real, spec.imag, length=length)


class CQT1992(nn.Module):
    """Frequency-domain CQT (Brown & Puckette 1992), the legacy v1 class
    (reference `model/Spectrogram.py:712-931`): one kernel-wide real FFT
    per hop, multiplied by conj(fft(kernels)) over the positive
    half-spectrum (a complex matmul), as the JAX package computes it."""

    def __init__(self, sr=22050, hop_length=512, fmin=220, fmax=None,
                 n_bins=84, bins_per_octave=12, norm=1, window="hann",
                 center=True, pad_mode="reflect"):
        super().__init__()
        self.hop_length = hop_length
        self.center = center
        self.pad_mode = pad_mode
        self.norm = norm
        q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
        if fmax is not None:
            # reference create_cqt_kernels: fmax overrides n_bins
            n_bins = int(np.ceil(bins_per_octave * np.log2(fmax / fmin)))
        kernels, self.kernel_width, lengths = fb.cqt_kernels(
            q, sr, fmin, n_bins, bins_per_octave, norm, window)
        spec = np.fft.fft(kernels, axis=1)[:, :self.kernel_width // 2 + 1]
        _complex_basis(self, "kernel_spec", np.conj(spec).T)
        _buffer(self, "sqrt_lengths", np.sqrt(lengths))
        self.n_bins = n_bins

    def _complex(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, n_bins) complex CQT."""
        frames = frame_audio(x, self.kernel_width, self.hop_length,
                             self.center, self.pad_mode)
        out = torch.fft.rfft(frames, dim=-1) @ _joined(self, "kernel_spec")
        if self.norm:
            return out / self.kernel_width * self.sqrt_lengths
        return out * self.sqrt_lengths

    def forward(self, x, output_format="Magnitude"):
        with fp32_math():
            out = self._complex(x)
        if output_format == "Magnitude":
            return out.abs()
        if output_format == "Complex":
            return torch.stack([out.real, out.imag], dim=-1)
        if output_format == "Phase":
            ang = out.angle()
            return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        raise ValueError(output_format)


def _firwin2_lowpass(band_center: float, kernel_length: int = 256,
                     transition_bandwidth: float = 0.03) -> np.ndarray:
    """nnAudio's `create_lowpass_filter`: firwin2 with unit gain up to
    band_center/(1+tb) and zero gain from band_center*(1+tb)."""
    import scipy.signal

    passband_max = band_center / (1 + transition_bandwidth)
    stopband_min = band_center * (1 + transition_bandwidth)
    taps = scipy.signal.firwin2(kernel_length,
                                [0.0, passband_max, stopband_min, 1.0],
                                [1.0, 1.0, 0.0, 0.0])
    return taps.astype(np.float32)


class CQT2010(nn.Module):
    """Multi-octave frequency-domain CQT (Schoerkhuber & Klapuri 2010), the
    legacy v1 class (reference `model/Spectrogram.py:932-1161`): the top
    octave's frequency-domain kernels reused on each x2 decimation, after
    an early downsampling when the top octave sits far below Nyquist.

    As in the JAX package, the published algorithm (upstream nnAudio's
    `get_cqt`), not the vendored snapshot's forward, which applies the raw
    DFT kernels (`model/Spectrogram.py:1123-1129`) and so returns
    linear-frequency bins."""

    def __init__(self, sr=22050, hop_length=512, fmin=32.70, fmax=None,
                 n_bins=84, bins_per_octave=12, norm=True, basis_norm=1,
                 window="hann", pad_mode="reflect", earlydownsample=True):
        super().__init__()
        self.pad_mode = pad_mode
        self.n_bins = n_bins
        self.norm = norm

        q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
        self.n_octaves = int(np.ceil(n_bins / bins_per_octave))
        n_filters = min(bins_per_octave, n_bins)

        # top-octave frequency range (reference
        # `model/Spectrogram.py:994-1008`)
        fmin_t = fmin * 2.0 ** (self.n_octaves - 1)
        remainder = n_bins % bins_per_octave
        if remainder == 0:
            fmax_t = fmin_t * 2.0 ** ((bins_per_octave - 1)
                                      / bins_per_octave)
        else:
            fmax_t = fmin_t * 2.0 ** ((remainder - 1) / bins_per_octave)
        fmin_t = fmax_t / 2.0 ** (1 - 1.0 / bins_per_octave)
        if fmax_t > sr / 2:
            raise ValueError("top CQT bin exceeds Nyquist; reduce n_bins")

        # early downsampling (reference get_early_downsample_params)
        self.early_factor = 1
        self.register_buffer("early_filter", None, persistent=False)
        if earlydownsample:
            window_bandwidth = 1.5
            filter_cutoff = fmax_t * (1 + 0.5 * window_bandwidth / q)
            nyquist = sr // 2
            c1 = max(0, int(np.ceil(np.log2(0.85 * nyquist / filter_cutoff))
                            - 1) - 2)
            num_twos = int(np.ceil(np.log2(hop_length)))
            c2 = max(0, num_twos - self.n_octaves + 1)
            count = min(c1, c2)
            if count > 0:
                self.early_factor = 2 ** count
                hop_length //= self.early_factor
                sr = sr / float(self.early_factor)
                _buffer(self, "early_filter", _firwin2_lowpass(
                    1.0 / self.early_factor, 256, 0.03)[None, None, :])
        self.hop_length = hop_length

        kernels, self.n_fft, _ = fb.cqt_kernels(
            q, sr, fmin_t, n_filters, bins_per_octave, basis_norm, window)
        spec = np.fft.fft(kernels, axis=1)[:, :self.n_fft // 2 + 1]
        _complex_basis(self, "kernel_spec", np.conj(spec).T)

        freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
        _buffer(self, "sqrt_lengths", np.sqrt(np.ceil(q * sr / freqs)))
        # x2 decimation lowpass (reference uses transitionBandwidth=0.001)
        _buffer(self, "lowpass", _firwin2_lowpass(0.5, 256, 0.001)[None, None])

    @staticmethod
    def _downsample(x, taps, stride):
        pad = (taps.shape[-1] - 1) // 2
        return F.conv1d(F.pad(x, (pad, pad)), taps, stride=stride)

    def _octave(self, x, hop):
        """Frequency-domain top-octave CQT of (B, L) at the given hop."""
        frames = frame_audio(x, self.n_fft, hop, True, self.pad_mode)
        return torch.fft.rfft(frames, dim=-1) @ _joined(self, "kernel_spec")

    def forward(self, x, output_format="Magnitude"):
        """(B, L) -> (B, T, n_bins)."""
        with fp32_math():
            if self.early_filter is not None:
                x = self._downsample(x[:, None, :], self.early_filter,
                                     self.early_factor)[:, 0]
            hop = self.hop_length
            octaves = [self._octave(x, hop)]           # top octave first
            sig = x[:, None, :]
            for _ in range(self.n_octaves - 1):
                if hop % 2:
                    raise ValueError(
                        "hop_length must be divisible by 2**n_octaves")
                hop //= 2
                sig = self._downsample(sig, self.lowpass, 2)
                octaves.append(self._octave(sig[:, 0], hop))

        t_min = min(o.shape[1] for o in octaves)
        # low -> high frequency; drop excess bottom bins
        full = torch.cat([o[:, :t_min] for o in octaves[::-1]], dim=2)
        full = full[:, :, full.shape[2] - self.n_bins:]
        if self.norm:
            full = full / self.n_fft * self.sqrt_lengths
        else:
            full = full * self.sqrt_lengths
        full = full * self.early_factor
        if output_format == "Magnitude":
            return full.abs()
        if output_format == "Complex":
            return torch.stack([full.real, full.imag], dim=-1)
        raise ValueError(output_format)


class CQT2010v2(nn.Module):
    """Multi-octave CQT: the top octave's time-domain kernels reused on
    each x2 decimation (reference `CQT2010v2`,
    `model/Spectrogram.py:1362-1642`), the strided convolutions by
    `F.conv1d`."""

    def __init__(self, sr=22050, hop_length=512, fmin=32.70, fmax=None,
                 n_bins=84, bins_per_octave=12, norm=1, window="hann",
                 center=True, pad_mode="reflect"):
        super().__init__()
        import scipy.signal

        self.hop_length = hop_length
        self.center = center
        self.pad_mode = pad_mode
        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave

        q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
        self.n_octaves = int(np.ceil(n_bins / bins_per_octave))
        # top-octave kernels at the original sample rate
        remainder = n_bins % bins_per_octave
        self.top_bins = remainder if remainder else bins_per_octave
        fmax_t = fmin * 2.0 ** ((n_bins - 1) / bins_per_octave)
        fmin_top = fmax_t / 2.0 ** ((bins_per_octave - 1)
                                    / bins_per_octave)
        kernels, self.kernel_width, lengths = fb.cqt_kernels(
            q, sr, fmin_top, bins_per_octave, bins_per_octave, norm,
            window)
        _buffer(self, "kr", kernels.real[:, None, :])
        _buffer(self, "ki", kernels.imag[:, None, :])
        _buffer(self, "sqrt_lengths", np.sqrt(lengths)[None, :, None])

        # 256-tap halfband lowpass for the x2 decimation cascade
        taps = scipy.signal.firwin(256, 0.4985, window=("kaiser", 9.0))
        _buffer(self, "lowpass", taps[None, None, :])

    def _downsample2(self, x):
        xp = F.pad(x, (127, 128), mode="replicate")
        return F.conv1d(xp, self.lowpass, stride=2)

    def forward(self, x):
        """(B, L) -> (B, T, n_bins) CQT magnitude."""
        with fp32_math():
            if self.center:
                pad = self.kernel_width // 2
                x = (reflect_pad(x, pad) if self.pad_mode == "reflect"
                     else F.pad(x, (pad, pad)))
            sig = x[:, None, :]
            hop = self.hop_length
            octaves = []
            for oct_idx in range(self.n_octaves):
                if oct_idx > 0:
                    sig = self._downsample2(sig)
                    if hop % 2:
                        raise ValueError(
                            "hop_length must be a multiple of 2**n_octaves")
                    hop //= 2
                real = F.conv1d(sig, self.kr, stride=hop) * self.sqrt_lengths
                imag = -F.conv1d(sig, self.ki, stride=hop) * self.sqrt_lengths
                octaves.append(torch.sqrt(real * real + imag * imag))

        # octave o covers bins [n_bins - (o+1)*bpo, n_bins - o*bpo); the
        # bottom (n_octaves*bpo - n_bins) bins are excess: dropped
        t_min = min(m.shape[-1] for m in octaves)
        full = torch.cat([m[:, :, :t_min] for m in octaves[::-1]], dim=1)
        return full[:, full.shape[1] - self.n_bins:].transpose(1, 2)
