"""Host-side (numpy) filterbank builders for the frontends.

The port's own copy of the window, windowed-DFT, slaney mel, gammatone and
CQT kernel helpers of `reconvat_tpu/ops/filterbanks.py` (the port imports
nothing of the JAX package). They reproduce the kernels the reference builds through
nnAudio 0.2.0 (`create_fourier_kernels` / librosa `mel` /
`create_cqt_kernels`, reference `model/Spectrogram.py:133,421,1266`) and
run once at model build.
"""
from __future__ import annotations

import numpy as np


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window; `periodic=True` matches scipy `get_window('hann', n)`."""
    if n == 1:
        return np.ones(1)
    denom = n if periodic else n - 1
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / denom)


def get_window(window: str, n: int, periodic: bool = True) -> np.ndarray:
    if window in ("hann", "hanning"):
        return hann_window(n, periodic)
    if window in ("ones", "boxcar", "rectangular"):
        return np.ones(n)
    if window == "hamming":
        denom = n if periodic else n - 1
        return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / denom)
    raise ValueError(f"unsupported window: {window}")


def pad_center(w: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to `size` (librosa pad_center semantics)."""
    n = len(w)
    lpad = (size - n) // 2
    return np.pad(w, (lpad, size - n - lpad))


def fourier_kernels(n_fft: int, win_length: int | None = None,
                    freq_bins: int | None = None, window: str = "hann"):
    """Windowed DFT basis (freq_scale='no').

    Returns (wcos, wsin) each of shape (freq_bins, n_fft) such that for a
    frame x of length n_fft:
        real[k] = sum_n x[n] * wcos[k, n],   imag[k] = sum_n x[n] * wsin[k, n]
    and |STFT|^2 = real^2 + imag^2 (matching the reference conv1d STFT,
    reference `model/Spectrogram.py:219-231`).
    """
    if win_length is None:
        win_length = n_fft
    if freq_bins is None:
        freq_bins = n_fft // 2 + 1
    wmask = pad_center(get_window(window, win_length, periodic=True), n_fft)
    n = np.arange(n_fft)
    k = np.arange(freq_bins)
    arg = 2 * np.pi * np.outer(k, n) / n_fft
    wcos = np.cos(arg) * wmask
    wsin = np.sin(arg) * wmask
    return wcos.astype(np.float32), wsin.astype(np.float32)


# ---------------------------------------------------------------------------
# Mel filterbank (librosa-compatible, slaney scale, norm=1)
# ---------------------------------------------------------------------------

def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney scale: linear below 1 kHz, logarithmic above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = f >= min_log_hz
        mels[log_t] = min_log_mel + np.log(f[log_t] / min_log_hz) / logstep
    elif f >= min_log_hz:
        mels = min_log_mel + np.log(f / min_log_hz) / logstep
    return mels


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if freqs.ndim:
        log_t = m >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (m[log_t] - min_log_mel))
    elif m >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (m - min_log_mel))
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False):
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels)
    return mel_to_hz(mels, htk)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: int | None = 1) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2).

    Matches librosa `filters.mel` with `norm=1` (slaney area normalization),
    which is what nnAudio 0.2.0 uses (reference `model/Spectrogram.py:421`).
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    if norm == 1:
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, np.newaxis]
    return weights.astype(np.float32)


def erb_centre_freqs(fmin: float, fmax: float, n: int) -> np.ndarray:
    """ERB-spaced centre frequencies, ascending (Glasberg & Moore)."""
    ear_q, min_bw = 9.26449, 24.7
    i = np.arange(1, n + 1)
    cfs = (-(ear_q * min_bw)
           + np.exp(i * (-np.log(fmax + ear_q * min_bw)
                         + np.log(fmin + ear_q * min_bw)) / n)
           * (fmax + ear_q * min_bw))
    return cfs[::-1]


def gammatone_filterbank(sr: int, n_fft: int, n_bins: int = 64,
                         fmin: float = 20.0, fmax: float | None = None,
                         width: float = 1.0) -> np.ndarray:
    """4th-order gammatone frequency-domain weights, (n_bins, n_fft//2+1).

    Port of the published gammatonegram `fft_weights` math (Ellis 2009 /
    Slaney MakeERBFilters), the basis behind nnAudio's Gammatonegram
    (reference `model/Spectrogram.py:594-709`).
    """
    if fmax is None:
        fmax = sr / 2
    ear_q, min_bw = 9.26449, 24.7
    cfs = erb_centre_freqs(fmin, fmax, n_bins)
    gt_ord = 4
    n_freqs = n_fft // 2 + 1
    ucirc = np.exp(1j * 2 * np.pi * np.arange(n_freqs) / n_fft)

    wts = np.zeros((n_bins, n_freqs))
    T = 1.0 / sr
    for i, cf in enumerate(cfs):
        erb = width * ((cf / ear_q) ** 1 + min_bw ** 1) ** 1
        B = 1.019 * 2 * np.pi * erb
        r = np.exp(-B * T)
        theta = 2 * np.pi * cf * T
        pole = r * np.exp(1j * theta)

        ebt = np.exp(B * T)
        cn = np.cos(2 * cf * np.pi * T)
        sn = np.sin(2 * cf * np.pi * T)
        sq_p = np.sqrt(3 + 2 ** 1.5)
        sq_m = np.sqrt(3 - 2 ** 1.5)
        a11 = -(2 * T * cn / ebt + 2 * sq_p * T * sn / ebt) / 2
        a12 = -(2 * T * cn / ebt - 2 * sq_p * T * sn / ebt) / 2
        a13 = -(2 * T * cn / ebt + 2 * sq_m * T * sn / ebt) / 2
        a14 = -(2 * T * cn / ebt - 2 * sq_m * T * sn / ebt) / 2
        zros = -np.array([a11, a12, a13, a14]) / T

        t1 = -2 * np.exp(4j * cf * np.pi * T) * T
        t2 = 2 * np.exp(-(B * T) + 2j * cf * np.pi * T) * T
        gain = np.abs(
            (t1 + t2 * (cn - sq_m * sn))
            * (t1 + t2 * (cn + sq_m * sn))
            * (t1 + t2 * (cn - sq_p * sn))
            * (t1 + t2 * (cn + sq_p * sn))
            / (-2 / np.exp(2 * B * T) - 2 * np.exp(4j * cf * np.pi * T)
               + 2 * (1 + np.exp(4j * cf * np.pi * T)) / np.exp(B * T))
            ** 4)
        wts[i] = ((T ** 4) / gain
                  * np.abs(ucirc - zros[0]) * np.abs(ucirc - zros[1])
                  * np.abs(ucirc - zros[2]) * np.abs(ucirc - zros[3])
                  * (np.abs((pole - ucirc) * (pole.conj() - ucirc))
                     ** -gt_ord))
    return wts.astype(np.float32)


def cqt_kernels(q: float, fs: float, fmin: float, n_bins: int = 84,
                bins_per_octave: int = 12, norm: int = 1,
                window: str = "hann", fmax: float | None = None):
    """Complex log-spaced CQT kernels (nnAudio `create_cqt_kernels`, used by
    CQT1992v2, reference `model/Spectrogram.py:1266-1273`): per-bin
    windowed complex exponentials of length ceil(Q fs / freq), centred,
    L`norm`-normalized. Returns (kernels complex64 (n_bins, fft_len),
    fft_len, lengths float32 (n_bins,))."""
    if fmax is not None and n_bins is None:
        n_bins = int(np.ceil(bins_per_octave * np.log2(fmax / fmin)))
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    if np.max(freqs) > fs / 2:
        raise ValueError("The top CQT bin exceeds the Nyquist frequency; "
                         "reduce n_bins or raise sr")
    lengths = np.ceil(q * fs / freqs)
    fft_len = int(2 ** np.ceil(np.log2(np.ceil(q * fs / fmin))))

    kernels = np.zeros((n_bins, fft_len), dtype=np.complex64)
    for k in range(n_bins):
        freq = freqs[k]
        l = int(np.ceil(q * fs / freq))
        if l % 2 == 1:
            start = int(np.ceil(fft_len / 2.0 - l / 2.0)) - 1
        else:
            start = int(np.ceil(fft_len / 2.0 - l / 2.0))
        t = np.r_[-(l // 2):l - (l // 2)]
        sig = (get_window(window, l, periodic=True)
               * np.exp(t * 1j * 2 * np.pi * freq / fs) / l)
        if norm:
            sig = sig / np.linalg.norm(sig, norm)
        kernels[k, start:start + l] = sig
    return kernels, fft_len, lengths.astype(np.float32)
