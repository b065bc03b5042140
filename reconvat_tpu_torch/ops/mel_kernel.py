"""Fused STFT power + mel projection: CUDA kernel wrapper and plain versions.

`mel_power` computes what the TPU kernel `_mel_kernel`
(`reconvat_tpu/ops/pallas_mel.py`) computes: centre reflect pad, frames of
n_fft samples every hop, windowed DFT, power re^2 + im^2 and the mel
projection, (B, N) -> (B, T, n_mels). On a CUDA tensor it launches
`csrc/mel.cu`, which runs a shared-memory FFT per frame; on a CPU tensor it
runs `mel_power_plain`, the function's definition (the DFT as two matmuls
against the cos/sin bases).

`mel_power_fft_plain` is the kernel's arithmetic step by step in PyTorch
(frames, window, the kernel's Stockham passes with the kernel's twiddle
table, power, the mel sum over each column's nonzero rows): the model of the
kernel that runs, and can be debugged, without a GPU.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..kernels import _build

# the kernel's FFT: Stockham autosort passes of these radices, in order
FFT_RADICES = (4,) * 5 + (2,)
KERNEL_N_FFT = math.prod(FFT_RADICES)   # the length csrc/mel.cu is built for


def frame_audio(audio: torch.Tensor, n_fft: int, hop: int,
                center: bool = True, pad_mode: str = "reflect"):
    """(B, N) -> (B, T, n_fft) frames every `hop` samples; with `center`
    (T = N // hop + 1) the signal is first padded by n_fft // 2 per side,
    reflected where `pad_mode` is 'reflect' and with zeros for any other
    mode, as the JAX package pads."""
    if center:
        pad = n_fft // 2
        if pad_mode == "reflect" and audio.shape[-1] <= pad:
            raise ValueError("signal shorter than reflect padding length")
        mode = "reflect" if pad_mode == "reflect" else "constant"
        audio = F.pad(audio[:, None], (pad, pad), mode=mode)[:, 0]
    return audio.unfold(-1, n_fft, hop)


def mel_power_plain(audio, wcos, wsin, mel_basis, hop: int):
    """Plain PyTorch version. wcos/wsin (n_fft, n_freq), mel_basis
    (n_freq, n_mels)."""
    frames = frame_audio(audio, wcos.shape[0], hop)
    re = frames @ wcos
    im = frames @ wsin
    return (re * re + im * im) @ mel_basis


def fft_twiddles(n_fft: int, dtype=torch.float32, device=None):
    """(n_fft // 2, 2) table of cos and -sin of 2 pi k / n_fft, computed in
    float64 and rounded once to `dtype`: exp(-2 pi i k / n_fft) as (re, im)
    pairs, the layout the kernel reads as float2."""
    k = torch.arange(n_fft // 2, dtype=torch.float64)
    arg = k * (2.0 * math.pi / n_fft)
    table = torch.stack([torch.cos(arg), -torch.sin(arg)], dim=1)
    return table.to(dtype=dtype, device=device).contiguous()


def mel_band(mel_basis: torch.Tensor) -> torch.Tensor:
    """int32 (n_mels, 2): for each column of mel_basis (n_freq, n_mels) the
    first nonzero row and one past the last nonzero row; (0, 0) for a column
    of zeros. A sum over [lo, hi) skips exact zeros only."""
    n_freq = mel_basis.shape[0]
    nz = (mel_basis != 0).to(torch.int32)
    lo = nz.argmax(dim=0)
    hi = n_freq - nz.flip(0).argmax(dim=0)
    empty = nz.sum(dim=0) == 0
    lo, hi = lo.masked_fill(empty, 0), hi.masked_fill(empty, 0)
    return torch.stack([lo, hi], dim=1).to(torch.int32).contiguous()


def _twiddle_at(tw: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """exp(-2 pi i idx / n) for idx in [0, n) from the half table tw
    (n // 2 complex): the second half is minus the first."""
    half = tw.shape[0]
    return torch.where(idx < half, tw[idx % half], -tw[idx % half])


def stockham_fft(z: torch.Tensor, twiddle: torch.Tensor) -> torch.Tensor:
    """Forward DFT of the complex rows z (..., n), n = KERNEL_N_FFT, by the
    Stockham autosort passes of `csrc/mel.cu` (radices FFT_RADICES,
    decimation in frequency, output in natural order, no bit reversal).
    twiddle is `fft_twiddles(n)` in z's real dtype. A pass of radix R at
    sub-length m * R and stride s reads x[q + s * (p + m * r)] and writes
    y[q + s * (R * p + k)] = w^(p * k) * sum_r x_r * exp(-2 pi i r k / R),
    w = exp(-2 pi i / (m * R)), for p < m, q < s."""
    n = z.shape[-1]
    if n != KERNEL_N_FFT:
        raise ValueError(f"the passes {FFT_RADICES} transform rows of "
                         f"{KERNEL_N_FFT}, got {n}")
    tw = torch.view_as_complex(twiddle.contiguous())
    lead = z.shape[:-1]
    s = 1
    for radix in FFT_RADICES:
        m = n // (s * radix)
        a = z.reshape(*lead, radix, m, s)
        p = torch.arange(m, device=z.device)[:, None] * s   # twiddle index
        if radix == 2:
            a0, a1 = a.unbind(-3)
            ys = [a0 + a1, (a0 - a1) * tw[p]]
        else:
            a0, a1, a2, a3 = a.unbind(-3)
            t0, t1, t2 = a0 + a2, a0 - a2, a1 + a3
            d = a1 - a3
            t3 = torch.complex(d.imag, -d.real)               # -i (a1 - a3)
            ys = [t0 + t2, (t1 + t3) * tw[p],
                  (t0 - t2) * tw[2 * p], (t1 - t3) * _twiddle_at(tw, 3 * p)]
        z = torch.stack(ys, dim=-2).reshape(*lead, n)
        s *= radix
    return z


def fft_power(frames: torch.Tensor, twiddle: torch.Tensor) -> torch.Tensor:
    """Power spectrum, bins 0..n/2, of the real windowed frames (B, T, n),
    as the kernel computes it: frames 2i and 2i + 1 are the real and
    imaginary part of one complex FFT Z and are unpacked as
    X_a[k] = (Z[k] + conj Z[n - k]) / 2, X_b[k] = (Z[k] - conj Z[n - k]) / 2i
    (a missing last partner is zero)."""
    n = frames.shape[-1]
    T = frames.shape[1]
    if T % 2:
        frames = F.pad(frames, (0, 0, 0, 1))
    z = stockham_fft(torch.complex(frames[:, 0::2], frames[:, 1::2]), twiddle)
    k = torch.arange(n // 2 + 1, device=frames.device)
    zk, zn = z[..., k], z[..., (n - k) % n]
    pa = ((zk.real + zn.real).square() + (zk.imag - zn.imag).square()) * 0.25
    pb = ((zk.imag + zn.imag).square() + (zk.real - zn.real).square()) * 0.25
    return torch.stack([pa, pb], dim=2).flatten(1, 2)[:, :T]


def banded_mel_sum(power: torch.Tensor, mel_basis: torch.Tensor,
                   band: torch.Tensor) -> torch.Tensor:
    """power (..., n_freq) projected on mel_basis (n_freq, n_mels), each
    column summed over its rows [lo, hi) of `band` only."""
    cols = [power[..., lo:hi] @ mel_basis[lo:hi, m]
            for m, (lo, hi) in enumerate(band.tolist())]
    return torch.stack(cols, dim=-1)


def mel_power_fft_plain(audio, window, mel_basis, hop: int):
    """The CUDA kernel's arithmetic in plain PyTorch, float32 or float64:
    window (n_fft,), mel_basis (n_freq, n_mels) with n_freq = n_fft // 2 + 1.
    Same function as `mel_power_plain` up to rounding."""
    n_fft = window.shape[0]
    frames = frame_audio(audio, n_fft, hop) * window
    twiddle = fft_twiddles(n_fft, audio.dtype, audio.device)
    return banded_mel_sum(fft_power(frames, twiddle), mel_basis,
                          mel_band(mel_basis))


def mel_power(audio, wcos, wsin, mel_basis, hop: int, window, twiddle, band):
    """(B, N) float32 audio -> (B, N // hop + 1, n_mels) mel power.

    CPU tensors take `mel_power_plain`; CUDA tensors launch the kernel (and
    count the launch in `mel_power.launches`) or raise. The kernel has no
    backward, so audio that needs a gradient raises rather than losing
    it. The kernel reads, in place of the bases, what the caller derived
    from them once: `window` (n_fft,) = `wcos[:, 0]` (cos 0 = 1), `twiddle`
    = `fft_twiddles(n_fft)` and `band` = `mel_band(mel_basis)`."""
    if audio.device.type == "cpu":
        return mel_power_plain(audio, wcos, wsin, mel_basis, hop)
    if audio.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("mel_power: the CUDA kernel has no backward; "
                           "audio that requires grad needs mel_power_plain")
    if audio.device.type != "cuda" or audio.dim() != 2:
        raise ValueError(f"mel_power: expected (B, N) audio on CPU or CUDA, "
                         f"got {tuple(audio.shape)} on {audio.device}")
    B, N = audio.shape
    n_fft, n_freq = wcos.shape
    n_mels = mel_basis.shape[1]
    pad = n_fft // 2
    if N <= pad:
        raise ValueError("signal shorter than reflect padding length")
    if n_fft != KERNEL_N_FFT or n_freq != n_fft // 2 + 1:
        raise ValueError(f"mel_power: the kernel computes all "
                         f"{KERNEL_N_FFT // 2 + 1} bins of a {KERNEL_N_FFT}-"
                         f"point DFT, got bases of {(n_fft, n_freq)}")
    _build.check_tensor("audio", audio, (B, N), audio.device)
    _build.check_tensor("wcos", wcos, (n_fft, n_freq), audio.device)
    _build.check_tensor("wsin", wsin, (n_fft, n_freq), audio.device)
    _build.check_tensor("window", window, (n_fft,), audio.device)
    _build.check_tensor("twiddle", twiddle, (n_fft // 2, 2), audio.device)
    _build.check_tensor("mel_basis", mel_basis, (n_freq, n_mels), audio.device)
    _build.check_tensor("band", band, (n_mels, 2), audio.device, torch.int32)
    n_frames = N // hop + 1
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32,
                      device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    err = _build.load("mel").mel_power_launch(
        audio.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
        mel_basis.data_ptr(), band.data_ptr(), out.data_ptr(), B, N,
        n_frames, n_fft, hop, n_mels, ctypes.c_void_p(stream))
    _build.check(err, "mel_power")
    mel_power.launches += 1
    return out


mel_power.launches = 0
