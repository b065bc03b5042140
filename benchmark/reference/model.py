"""Plain PyTorch reference of the flagship ReconVAT (reference `UNet`,
KinWaiCheuk/ReconVAT `model/self_attention_VAT.py`) and of UNetOnset
(`model/UNet_onset.py` `UNet_Onset`): the signal chain, the U-Net, the
window-31 banded attention and the heads, written from the published
layer equations as functions of a flat parameter dict whose keys are the
reference state_dict's names.

It imports torch and numpy only, never the program under test. Every
table it needs (window, mel basis) is computed here again. Math is float32
with TF32 off (`fp32_math`); nothing is fused and nothing is cached.

BatchNorm modes: "train" normalizes by the batch's biased moments and
moves the running statistics (momentum 0.1, biased variance, as the
JAX package and the port do); "calibrate" likewise with momentum 1, so
that the running statistics become the batch's; "frozen" normalizes by
the batch's moments and leaves the running statistics alone (the VAT
chains); "eval" reads the running statistics.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE, HOP, N_FFT = 16000, 512, 2048
N_MELS, FMIN, FMAX = 229, 30.0, 8000.0
N_KEYS = 88
BN_EPS, BN_MOMENTUM, LEAKY_SLOPE = 1e-5, 0.1, 0.01
WINDOW = 31


@contextlib.contextmanager
def fp32_math():
    """Full fp32 products and convolutions (TF32 off), restored on exit."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


# -- signal chain ------------------------------------------------------------

def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (np.log(6.4) / 27)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_basis(n_mels=N_MELS, fmin=FMIN, fmax=FMAX, sr=SAMPLE_RATE,
              n_fft=N_FFT) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) slaney triangles with area normalisation
    (librosa `filters.mel(norm=1)`, which nnAudio 0.2.0 builds)."""
    fft_hz = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rise = (fft_hz[None] - lo) / (mid - lo)
    fall = (hi - fft_hz[None]) / (hi - mid)
    tri = np.maximum(0.0, np.minimum(rise, fall))
    tri *= (2.0 / (hi - lo))
    return tri.T.astype(np.float32)


class Signal:
    """audio (B, N) in [-1, 1] -> normalised log-mel image (B, T, F, 1):
    the final sample dropped, centre reflect padding, periodic Hann window,
    |rFFT|^2, mel projection, log(x + 1e-5), min-max over each clip."""

    def __init__(self, device):
        n = np.arange(N_FFT)
        window = 0.5 - 0.5 * np.cos(2 * np.pi * n / N_FFT)
        self.window = torch.tensor(window, dtype=torch.float32,
                                   device=device)
        self.basis = torch.from_numpy(mel_basis()).to(device)

    def mel(self, audio):
        x = audio[:, :-1]
        x = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
        frames = x.unfold(-1, N_FFT, HOP) * self.window
        spec = torch.fft.rfft(frames, dim=-1)
        return (spec.real.square() + spec.imag.square()) @ self.basis

    def __call__(self, audio):
        spec = torch.log(self.mel(audio) + 1e-5)
        lo = spec.amin(dim=(1, 2), keepdim=True)
        hi = spec.amax(dim=(1, 2), keepdim=True)
        return ((spec - lo) / (hi - lo))[..., None]


# -- layers ------------------------------------------------------------------

def _conv(x, p, name, stride=1, padding=0):
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride,
                    padding)


def _conv_t(x, p, name, stride=1, padding=0, size=None):
    w = p[name + ".weight"]
    k = w.shape[2:]
    extra = (0, 0)
    if size is not None:
        extra = tuple(size[i] - ((x.shape[2 + i] - 1) * stride
                                 - 2 * padding + k[i]) for i in range(2))
    return F.conv_transpose2d(x, w, p[name + ".bias"], stride, padding,
                              extra)


def _bn(x, p, stats, name, mode):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if mode == "eval":
        mean = stats[name + ".running_mean"]
        var = stats[name + ".running_var"]
    else:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        if mode in ("train", "calibrate"):
            rate = BN_MOMENTUM if mode == "train" else 1.0
            with torch.no_grad():
                m, v = name + ".running_mean", name + ".running_var"
                stats[m] = stats[m] + rate * (mean - stats[m])
                stats[v] = stats[v] + rate * (var - stats[v])
    scale = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] \
        + b[None, :, None, None]


def _act(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def _enc_block(x, p, s, pre, mode):
    y = _act(_bn(_conv(x, p, pre + ".conv1", padding=1), p, s,
                 pre + ".bn1", mode))
    y = _act(_bn(_conv(y, p, pre + ".conv2", padding=1), p, s,
                 pre + ".bn2", mode)) + _conv(x, p, pre + ".skip")
    return _conv(y, p, pre + ".ds", stride=2), tuple(y.shape[2:])


def _dec_block(x, size, skip, p, s, pre, mode, last):
    x = _conv_t(x, p, pre + ".us", stride=2, size=size)
    if not last:
        x = torch.cat([x, skip], dim=1)
    x = _act(_bn(_conv_t(x, p, pre + ".conv2d", padding=1), p, s,
                 pre + ".bn2d", mode))
    x = _conv_t(x, p, pre + ".conv1d", padding=1)
    return x if last else _act(_bn(x, p, s, pre + ".bn1d", mode))


def unet(x, p, s, enc, dec, mode):
    """(B, C, T, F) -> (B, out, T, F): four residual encoder blocks of 16,
    32, 64 and 128 channels, 3x3 skip convolutions, four transposed
    decoder blocks."""
    x1, s1 = _enc_block(x, p, s, enc + ".block1", mode)
    x2, s2 = _enc_block(x1, p, s, enc + ".block2", mode)
    x3, s3 = _enc_block(x2, p, s, enc + ".block3", mode)
    x4, s4 = _enc_block(x3, p, s, enc + ".block4", mode)
    skips = [_conv(x3, p, enc + ".conv1", padding=1),
             _conv(x2, p, enc + ".conv2", padding=1),
             _conv(x1, p, enc + ".conv3", padding=1)]
    y = _dec_block(x4, s4, skips[0], p, s, dec + ".d_block1", mode, False)
    y = _dec_block(y, s3, skips[1], p, s, dec + ".d_block2", mode, False)
    y = _dec_block(y, s2, skips[2], p, s, dec + ".d_block3", mode, False)
    return _dec_block(y, s1, None, p, s, dec + ".d_block4", mode, True)


def attention(x, p, pre, heads, window=WINDOW):
    """Window-`window` multi-head self-attention over time (reference
    `MutliHeadAttention1D`): K and V from the zero-padded input, energies
    q.k + q.rel without scaling, softmax over the window."""
    b, length, _ = x.shape
    half = (window - 1) // 2
    wq = p[pre + ".W_q.weight"]
    d = wq.shape[0] // heads
    xpad = F.pad(x, (0, 0, half, half))
    q = (x @ wq.T).reshape(b, length, heads, d)
    k = (xpad @ p[pre + ".W_k.weight"].T).reshape(b, -1, heads, d)
    v = (xpad @ p[pre + ".W_v.weight"].T).reshape(b, -1, heads, d)
    rel = p[pre + ".rel"][0].reshape(heads, d, window)
    kw, vw = k.unfold(1, window, 1), v.unfold(1, window, 1)
    energy = (torch.einsum("blhd,blhdw->blhw", q, kw)
              + torch.einsum("blhd,hdw->blhw", q, rel))
    probs = torch.softmax(energy, dim=-1)
    out = torch.einsum("blhw,blhdw->blhd", probs, vw)
    return out.reshape(b, length, heads * d)


def _linear(x, p, name):
    return x @ p[name + ".weight"].T + p[name + ".bias"]


# -- the two models ----------------------------------------------------------

class ReconVATRef:
    """Transcriber: U-Net -> 4 heads of 229 -> linear -> sigmoid.
    Reconstructor: 4 heads of 229 over the roll -> linear -> sigmoid ->
    U-Net."""
    heads = {"transcriber": 4, "reconstructor": 4}
    frame_head = "transcriber.linear1"

    def transcriber(self, x, p, s, mode):
        """x (B, T, F, 1) -> {"frame": (B, T, 88)} and the frame logits."""
        y = unet(x.permute(0, 3, 1, 2), p, s, "transcriber.Unet1_encoder",
                 "transcriber.Unet1_decoder", mode)[:, 0]
        h = attention(y, p, "transcriber.lstm1", self.heads["transcriber"])
        logits = _linear(h, p, "transcriber.linear1")
        return {"frame": torch.sigmoid(logits)}, logits

    def reconstructor(self, roll, p, s, mode):
        h = attention(roll, p, "reconstructor.lstm2",
                      self.heads["reconstructor"])
        spec = torch.sigmoid(_linear(h, p, "reconstructor.linear2"))
        y = unet(spec[:, None], p, s, "reconstructor.Unet2_encoder",
                 "reconstructor.Unet2_decoder", mode)
        return y.permute(0, 2, 3, 1)

    def vat_target(self, out):
        """The rolls VAT compares: a tensor for the flagship."""
        return out["frame"]


class UNetOnsetRef(ReconVATRef):
    """Transcriber: 2-channel U-Net; channel 0 -> linear -> sigmoid is the
    onset roll, channel 1 -> linear are features; [onset, features] -> 6
    heads of 128 -> linear -> sigmoid is the frame roll. Reconstructor as
    the flagship's."""
    heads = {"transcriber": 6, "reconstructor": 4}
    frame_head = "transcriber.combine_stack.linear"

    def transcriber(self, x, p, s, mode):
        y = unet(x.permute(0, 3, 1, 2), p, s, "transcriber.Unet1_encoder",
                 "transcriber.Unet1_decoder", mode)
        onset = torch.sigmoid(_linear(y[:, 0], p, "transcriber.linear_onset"))
        feat = _linear(y[:, 1], p, "transcriber.linear_feature")
        h = attention(torch.cat([onset, feat], dim=-1), p,
                      "transcriber.combine_stack.attention",
                      self.heads["transcriber"])
        logits = _linear(h, p, "transcriber.combine_stack.linear")
        return {"frame": torch.sigmoid(logits), "onset": onset}, logits

    def vat_target(self, out):
        return out


MODELS = {"reconvat": ReconVATRef, "unetonset": UNetOnsetRef}


def frame_logits(model, signal, audio, p, s):
    """Eval-mode frame logits (B, T, 88) of float audio (B, N)."""
    return model.transcriber(signal(audio), p, s, "eval")[1]


def n_frames(n_samples: int) -> int:
    return (n_samples - 1) // HOP + 1


def logit(q: float) -> float:
    return math.log(q / (1.0 - q))
