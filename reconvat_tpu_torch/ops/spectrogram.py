"""Spectrogram frontends (PyTorch counterpart of
`reconvat_tpu/ops/spectrogram.py`: `STFT.power`, `MelSpectrogram`,
`CQT1992v2`, `CFP`, `make_frontend`).

Mel: the STFT is framing plus two matmuls against precomputed windowed DFT
bases (the reference's conv1d against Fourier kernels, reference
`model/Spectrogram.py:219-231`), and the mel projection one more matmul; on
a CUDA tensor the fused `mel_power` kernel computes the same function with
an FFT per frame from the window alone, at the settings it computes
(`MelSpectrogram.kernel_computes`). CQT: a strided convolution against
complex CQT kernels, taken as accumulated matmuls over hop-sized chunks of
the kernels (cuBLAS). CFP: FFT magnitudes and a spectrum/cepstrum cascade
of real FFTs (cuFFT), then two triangular projections (cuBLAS). The JAX
package has no TPU kernel for CQT or CFP, and neither has the port.
Outputs are time-major (B, T, bins). Each frontend states how far its
frames reach into the audio (`frame_reach`, in hops on either side of a
frame's centre: Mel 4, the 2,048-sample window with its reflect padding;
CQT 32, half its 32,768-tap kernel; CFP 4, half its 4,000-sample frame)
and how many leading STFT frames it drops (`frame_offset`: CFP 1); the
streaming path's halos are taken from them. The bases and what the kernel
reads in their place are non-persistent buffers: they follow the module's device
but are not part of its state_dict.

Precision: every frontend computes in fp32, in fp32 and bf16 models alike
(the JAX package runs its frontend matmuls at `Precision.HIGH` in a bf16
model, `frontend_precision`). The models call the frontend inside
`models/base.fp32_math`, which switches TF32 off for cuBLAS and cuDNN, so
the CQT and CFP matmuls run in full fp32 on the card too.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C
from . import filterbanks as fb
from .mel_kernel import (KERNEL_N_FFT, fft_twiddles, frame_audio, mel_band,
                         mel_power)


class STFT(nn.Module):
    """Magnitude and power STFT, `freq_scale='no'` (reference
    `model/Spectrogram.py:104-231`): the first `freq_bins` bins (all
    n_fft // 2 + 1 by default), centre reflect padding by default, with
    `center` and `pad_mode` as `frame_audio` takes them (zeros for any
    mode but 'reflect')."""

    def __init__(self, n_fft: int = 2048, win_length: int | None = None,
                 freq_bins: int | None = None,
                 hop_length: int | None = None, window: str = "hann",
                 center: bool = True, pad_mode: str = "reflect"):
        super().__init__()
        win_length = win_length or n_fft
        self.n_fft = n_fft
        self.hop_length = hop_length or win_length // 4
        self.center, self.pad_mode = center, pad_mode
        wcos, wsin = fb.fourier_kernels(n_fft, win_length, freq_bins, window)
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
        frames = frame_audio(x, self.n_fft, self.hop_length, self.center,
                             self.pad_mode)
        real = frames @ self.wcos
        imag = frames @ self.wsin
        return real * real + imag * imag

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, bins) magnitude |STFT|."""
        return torch.sqrt(self.power(x))


class MelSpectrogram(nn.Module):
    """|STFT|^power projected onto a mel filterbank, reference nnAudio
    MelSpectrogram (`model/Spectrogram.py:396-461`): by default power 2,
    the slaney scale (htk=False) and norm=1, centre reflect padding.
    `htk` and `norm` change the basis only; `center`, `pad_mode` and
    `power` go to the STFT and the exponent as the JAX package takes
    them (a power other than 2 raises the magnitude to it).

    `use_kernel` sends the whole frontend through the fused `mel_power`
    wrapper, which launches the CUDA kernel on a CUDA tensor and runs its
    plain version on a CPU tensor; False runs the plain version on any
    device (the comparison run of the serving path). It is fixed when the
    module is built, never by a failed launch: True where the kernel
    computes these settings (`kernel_computes`: n_fft = KERNEL_N_FFT, all
    n_fft // 2 + 1 bins, centred, reflect padding and power 2; any
    window, hop, mel range, `htk` and `norm`, since the kernel reads the
    window, the basis and its band), else False, and setting it True
    there raises ValueError."""

    def __init__(self, sr: int = 22050, n_fft: int = 2048,
                 win_length: int | None = None, n_mels: int = 128,
                 hop_length: int = 512, window: str = "hann",
                 center: bool = True, pad_mode: str = "reflect",
                 power: float = 2.0, htk: bool = False, fmin: float = 0.0,
                 fmax: float | None = None, norm: int | None = 1):
        super().__init__()
        self.stft = STFT(n_fft=n_fft, win_length=win_length,
                         hop_length=hop_length, window=window,
                         center=center, pad_mode=pad_mode)
        self.power_exp = power
        basis = fb.mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm)
        self.register_buffer("mel_basis", torch.from_numpy(basis.T.copy()),
                             persistent=False)      # (bins, n_mels)
        # what the CUDA kernel reads in place of the bases, derived once
        self.register_buffer("twiddle", fft_twiddles(n_fft), persistent=False)
        self.register_buffer("band", mel_band(self.mel_basis),
                             persistent=False)
        self.n_mels = n_mels
        self.kernel_computes = (n_fft == KERNEL_N_FFT and center
                                and pad_mode == "reflect" and power == 2.0)
        self.use_kernel = self.kernel_computes
        # frames of audio a spec frame reads on either side, and how many
        # leading frames the frontend drops (streaming's halos)
        self.frame_reach, self.frame_offset = 4, 0

    @property
    def use_kernel(self) -> bool:
        return self._use_kernel

    @use_kernel.setter
    def use_kernel(self, flag: bool) -> None:
        if flag and not self.kernel_computes:
            s = self.stft
            raise ValueError(
                f"MelSpectrogram: the mel_power kernel computes a centred, "
                f"reflect-padded {KERNEL_N_FFT}-point power spectrum "
                f"(power 2), not n_fft={s.n_fft}, center={s.center}, "
                f"pad_mode={s.pad_mode!r}, power={self.power_exp}")
        self._use_kernel = bool(flag)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, n_mels)."""
        if self.use_kernel:
            return mel_power(x.contiguous(), self.stft.wcos, self.stft.wsin,
                             self.mel_basis, self.stft.hop_length,
                             self.stft.window, self.twiddle, self.band)
        spec = self.stft.power(x)
        if self.power_exp != 2.0:
            spec = torch.sqrt(spec) ** self.power_exp
        return spec @ self.mel_basis


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, L) reflect-padded by `pad` samples per side."""
    if x.shape[-1] <= pad:
        raise ValueError("signal shorter than reflect padding length")
    return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]


class CQT1992v2(nn.Module):
    """Constant-Q transform by direct convolution with complex CQT kernels,
    reference CQT1992v2 (`model/Spectrogram.py:1246-1329`): centre
    padding of kernel_width // 2 (reflected for `pad_mode` 'reflect',
    zeros for any other, none without `center`), one hop, magnitude
    scaled by sqrt(kernel length per bin). `frame_reach` is the centred
    frontend's, the one the models build.

    When the hop divides the kernel width (512 | 32768 at `make_frontend`'s
    settings) the strided convolution is taken as kernel_width / hop
    accumulated products of hop-sized row chunks of the padded audio with
    the matching chunks of the kernels, real and imaginary parts side by
    side (`chunks`, (k, hop, 2 n_bins)), as the JAX package computes it;
    otherwise as `F.conv1d` at stride hop (`conv1d`). The audio is never
    unfolded into kernel-wide frames."""

    def __init__(self, sr: int = 22050, hop_length: int = 512,
                 fmin: float = 32.70, fmax: float | None = None,
                 n_bins: int = 84, bins_per_octave: int = 12, norm: int = 1,
                 window: str = "hann", center: bool = True,
                 pad_mode: str = "reflect"):
        super().__init__()
        self.hop_length = hop_length
        self.center, self.pad_mode = center, pad_mode
        q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
        kernels, self.kernel_width, lengths = fb.cqt_kernels(
            q, sr, fmin, n_bins, bins_per_octave, norm, window, fmax)
        self.n_bins = n_bins
        # a frame's kernel spans kernel_width samples about its centre
        self.frame_reach = -(-(self.kernel_width // 2) // hop_length)
        self.frame_offset = 0
        basis = np.concatenate([kernels.real, kernels.imag])  # (2n, width)
        self.register_buffer("sqrt_lengths",
                             torch.from_numpy(np.sqrt(lengths)),
                             persistent=False)
        if self.kernel_width % hop_length == 0:
            k = self.kernel_width // hop_length
            chunks = basis.reshape(2 * n_bins, k, hop_length).transpose(1, 2, 0)
            self.register_buffer(
                "chunks", torch.from_numpy(np.ascontiguousarray(chunks)),
                persistent=False)
            self.weight = None
        else:
            self.chunks = None
            self.register_buffer("weight",
                                 torch.from_numpy(basis.copy())[:, None],
                                 persistent=False)

    def conv_weight(self) -> torch.Tensor:
        """The kernels as the (2 n_bins, 1, width) weight of `F.conv1d`."""
        if self.weight is not None:
            return self.weight
        k, hop, n2 = self.chunks.shape
        return self.chunks.permute(2, 0, 1).reshape(n2, 1, k * hop)

    def _chunked(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Lp) padded audio -> (B, T, 2 n_bins) real and imaginary
        products. The batch rows are laid end to end, so each chunk's
        product is one (rows, hop) x (hop, 2 n_bins) GEMM accumulated in
        place; the k - 1 rows of start positions that straddle two batch
        rows are computed and dropped."""
        k, hop, n2 = self.chunks.shape
        B, Lp = x.shape
        n_frames = (Lp - self.kernel_width) // hop + 1
        n_rows = max(Lp // hop, n_frames + k - 1)
        rows = F.pad(x[:, :Lp // hop * hop],
                     (0, (n_rows - Lp // hop) * hop)).reshape(B * n_rows, hop)
        starts = B * n_rows - k + 1
        acc = rows[:starts] @ self.chunks[0]
        for j in range(1, k):
            acc.addmm_(rows[j:j + starts], self.chunks[j])
        acc = F.pad(acc, (0, 0, 0, k - 1)).reshape(B, n_rows, n2)
        return acc[:, :n_frames]

    def conv1d(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Lp) padded audio -> (B, T, 2 n_bins) by `F.conv1d`."""
        return F.conv1d(x[:, None], self.conv_weight(),
                        stride=self.hop_length).transpose(1, 2)

    def magnitude(self, parts: torch.Tensor) -> torch.Tensor:
        """(B, T, 2 n_bins) real and imaginary products -> (B, T, n_bins)
        magnitudes scaled by sqrt(kernel length), the imaginary part
        negated as the reference takes it."""
        real = parts[..., :self.n_bins] * self.sqrt_lengths
        imag = -parts[..., self.n_bins:] * self.sqrt_lengths
        return torch.sqrt(real * real + imag * imag)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, n_bins) CQT magnitude."""
        if self.center:
            pad = self.kernel_width // 2
            x = (reflect_pad(x, pad) if self.pad_mode == "reflect"
                 else F.pad(x, (pad, pad)))
        return self.magnitude(self._chunked(x) if self.chunks is not None
                              else self.conv1d(x))


def _real_fft_full(x: torch.Tensor) -> torch.Tensor:
    """Re fft(x) over the last axis, all N bins, for real x: the real FFT's
    bins 0..N // 2 and their mirror images N - k for the rest (Re X[N - k]
    = Re X[k]), as the JAX package reads `jnp.real(jnp.fft.fft(x))`."""
    n = x.shape[-1]
    r = torch.fft.rfft(x, dim=-1).real
    return torch.cat([r, r[..., 1:n - r.shape[-1] + 1].flip(-1)], dim=-1)


class CFP(nn.Module):
    """Combined Frequency and Periodicity frontend, reference
    `Combined_Frequency_Periodicity` (`model/Spectrogram.py:2093-2233`):
    Blackman-Harris STFT magnitude -> the spectrum/cepstrum cascade of real
    FFTs with cut-off masks (g = [0.24, 0.6, 1]) -> the log-frequency and
    log-quefrency triangular projections -> their elementwise product.
    Output (B, T - 2, n_bins): the first and last STFT frames are dropped,
    as the reference drops them. Each FFT of real input is a real FFT
    (`torch.fft.rfft`, cuFFT on the card) whose mirror fills the full
    spectrum the cascade's masks read."""

    def __init__(self, fr=2, fs=16000, hop_length=320, window_size=2049,
                 fc=80, tc=1 / 1000, g=(0.24, 0.6, 1), num_per_oct=48):
        super().__init__()
        import scipy.signal

        self.hop_length = hop_length
        self.N = int(fs / float(fr))
        # a frame spans N samples about its centre; output frame i is STFT
        # frame i + 1 (the first and last are dropped)
        self.frame_reach = -(-(self.N // 2) // hop_length)
        self.frame_offset = 1
        f = fs * np.linspace(0, 0.5, round(self.N // 2), endpoint=True)
        h = scipy.signal.windows.blackmanharris(window_size)
        self.g = list(g)
        self.tc_idx = round(fs * tc)
        self.fc_idx = round(fc / fr)
        self.high_freq_idx = int(round((1 / tc) / fr) + 1)
        self.high_quef_idx = int(round(fs / fc) + 1)
        f = f[:self.high_freq_idx]
        q = np.arange(self.high_quef_idx) / float(fs)
        f2lf, q2lf = self._create_logfreq_matrices(f, q, fr, fc, tc,
                                                   num_per_oct, fs)
        # (f, n) and (q, n) for right-multiplication
        self.register_buffer("freq2logfreq", torch.from_numpy(
            f2lf.T.astype(np.float32).copy()), persistent=False)
        self.register_buffer("quef2logfreq", torch.from_numpy(
            q2lf.T.astype(np.float32).copy()), persistent=False)
        self.n_bins = q2lf.shape[0]
        # the window centred in N samples, fp32, as the JAX package keeps it
        self.register_buffer("window", torch.from_numpy(
            fb.pad_center(h.astype(np.float32), self.N).astype(np.float32)),
            persistent=False)
        self.h_norm = float(np.linalg.norm(h.astype(np.float32)))

    def _nonlinear(self, x, g, cutoff):
        """Zero the first and last `cutoff` bins, then relu(x) ** g, or
        log(x) where g is 0."""
        cutoff = int(cutoff)
        n = x.shape[-1]
        mask = torch.ones(n, dtype=x.dtype, device=x.device)
        mask[:cutoff] = 0
        mask[n - cutoff:] = 0
        if g != 0:
            return (torch.clamp_min(x, 0.0) * mask) ** g
        return torch.log(x) * mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T - 2, n_bins), T = L // hop + 1."""
        N = self.N
        frames = F.pad(x, (N // 2, N // 2)).unfold(-1, N, self.hop_length)
        spec_c = torch.fft.rfft(frames * self.window, dim=-1)
        mag = spec_c.abs()[:, 1:-1]                # drop first/last frame
        tfr0 = torch.cat([mag, mag[..., 1:N - mag.shape[-1] + 1].flip(-1)],
                         dim=-1) / self.h_norm

        spec = torch.clamp_min(tfr0, 0.0) ** self.g[0]
        ceps = torch.zeros_like(spec)
        for gc in range(1, len(self.g)):
            if gc % 2 == 1:
                ceps = _real_fft_full(spec) / np.sqrt(N)
                ceps = self._nonlinear(ceps, self.g[gc], self.tc_idx)
            else:
                spec = _real_fft_full(ceps) / np.sqrt(N)
                spec = self._nonlinear(spec, self.g[gc], self.fc_idx)

        half = int(round(N / 2))
        tfr = spec[..., :half][..., :self.high_freq_idx]
        cep = ceps[..., :half][..., :self.high_quef_idx]
        return (tfr @ self.freq2logfreq) * (cep @ self.quef2logfreq)

    @staticmethod
    def _create_logfreq_matrices(f, q, fr, fc, tc, num_per_oct, fs):
        """Reference `create_logfreq_matrix` (`model/Spectrogram.py:
        2193-2233`): (freq_band (n, len f), quef_band (n, len q))."""
        start_freq, stop_freq = fc, 1 / tc
        nest = int(np.ceil(np.log2(stop_freq / start_freq)) * num_per_oct)
        central_freq = []
        for i in range(nest):
            cen = start_freq * 2.0 ** (i / num_per_oct)
            if cen < stop_freq:
                central_freq.append(cen)
            else:
                break
        nest = len(central_freq)
        freq_band = np.zeros((nest - 1, len(f)))
        for i in range(1, nest - 1):
            l = int(round(central_freq[i - 1] / fr))
            r = int(round(central_freq[i + 1] / fr) + 1)
            if l >= r - 1:
                freq_band[i, l] = 1
            else:
                for j in range(l, min(r, len(f))):
                    if central_freq[i - 1] < f[j] < central_freq[i]:
                        freq_band[i, j] = ((f[j] - central_freq[i - 1])
                                           / (central_freq[i]
                                              - central_freq[i - 1]))
                    elif central_freq[i] < f[j] < central_freq[i + 1]:
                        freq_band[i, j] = ((central_freq[i + 1] - f[j])
                                           / (central_freq[i + 1]
                                              - central_freq[i]))
        with np.errstate(divide="ignore"):
            finv = 1 / q
        quef_band = np.zeros((nest - 1, len(finv)))
        for i in range(1, nest - 1):
            lo = int(round(fs / central_freq[i + 1]))
            hi = int(round(fs / central_freq[i - 1]) + 1)
            for j in range(lo, min(hi, len(finv))):
                if central_freq[i - 1] < finv[j] < central_freq[i]:
                    quef_band[i, j] = ((finv[j] - central_freq[i - 1])
                                       / (central_freq[i]
                                          - central_freq[i - 1]))
                elif central_freq[i] < finv[j] < central_freq[i + 1]:
                    quef_band[i, j] = ((central_freq[i + 1] - finv[j])
                                       / (central_freq[i + 1]
                                          - central_freq[i]))
        return freq_band, quef_band


def make_frontend(spec: str = "Mel", sr: int | None = None,
                  hop_length: int | None = None, n_bins: int | None = None):
    """Frontend factory (reference `model/self_attention_VAT.py:1019-1039`).
    Returns (frontend, n_bins): 'Mel' 229 bins, 'CQT' 176 (24 per octave
    from 27.5 Hz), 'CFP' 386 (the reference `UNet`'s CFP settings,
    `model/self_attention_VAT.py:1031-1037`; T - 2 frames)."""
    sr = sr or C.SAMPLE_RATE
    hop_length = hop_length or C.HOP_LENGTH
    if spec == "Mel":
        n_bins = n_bins or C.N_BINS
        return MelSpectrogram(sr=sr, n_fft=C.WINDOW_LENGTH,
                              win_length=C.WINDOW_LENGTH, n_mels=n_bins,
                              hop_length=hop_length, fmin=C.MEL_FMIN,
                              fmax=C.MEL_FMAX), n_bins
    if spec == "CQT":
        r = 2
        n_bins = n_bins or 88 * r
        return CQT1992v2(sr=sr, hop_length=hop_length, n_bins=n_bins,
                         fmin=27.5, bins_per_octave=12 * r), n_bins
    if spec == "CFP":
        frontend = CFP(fs=sr, fr=4, window_size=C.WINDOW_LENGTH,
                       hop_length=hop_length, fc=C.MEL_FMIN,
                       tc=1 / C.MEL_FMAX)
        return frontend, frontend.n_bins
    raise ValueError(f"unknown spectrogram type: {spec}")
