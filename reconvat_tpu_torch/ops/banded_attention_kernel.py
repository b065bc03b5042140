"""Banded local attention forward: CUDA kernel wrapper and plain version.

`banded_attention_fwd` computes what the TPU kernel `_attention_kernel`
(`reconvat_tpu/ops/pallas_attention.py`) computes, and also returns the
attention probabilities, which the default reference path returns:

    s[b, t, h, j] = q[b, t, h] . (kpad[b, t + j, h] + rel[h, :, j])
    p = softmax_j(s)           (no 1/sqrt(d) scale)
    out[b, t, h] = sum_j p[b, t, h, j] * vpad[b, t + j, h]

with kpad/vpad zero-padded by (window - 1) // 2 rows per side. On a CUDA
tensor it launches `csrc/banded_attention.cu`; on a CPU tensor it runs
`banded_attention`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import _build


def banded_attention(q, kpad, vpad, rel, window: int):
    """Plain PyTorch version.

    q (B, L, H, Dh); kpad/vpad (B, L + window - 1, H, Dh); rel (H, Dh,
    window) or None. Returns (out (B, L, H, Dh), probs (B, L, H, window)).
    The band is unfolded to (B, L, H, Dh, window) windows; q.k and q.rel are
    formed apart and added, as the reference adds its skewed bias.
    """
    kw = kpad.unfold(1, window, 1)          # (B, L, H, Dh, W)
    vw = vpad.unfold(1, window, 1)
    scores = torch.einsum("blhd,blhdw->blhw", q, kw)
    if rel is not None:
        scores = scores + torch.einsum("blhd,hdw->blhw", q, rel)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("blhw,blhdw->blhd", probs, vw)
    return out, probs


def banded_attention_fwd(q, kpad, vpad, rel, window: int):
    """Returns (out, probs) like `banded_attention`.

    CPU tensors take `banded_attention`; CUDA tensors launch the kernel (and
    count the launch in `banded_attention_fwd.launches`) or raise. A
    missing rel is a zero rel."""
    if q.device.type == "cpu":
        return banded_attention(q, kpad, vpad, rel, window)
    if q.device.type != "cuda" or q.dim() != 4:
        raise ValueError(f"banded_attention_fwd: expected (B, L, H, Dh) on "
                         f"CPU or CUDA, got {tuple(q.shape)} on {q.device}")
    B, L, H, D = q.shape
    if not 1 <= window <= 32 or D > 256:
        raise ValueError(f"kernel takes window <= 32 and Dh <= 256, got "
                         f"window={window}, Dh={D}")
    if rel is None:
        rel = torch.zeros((H, D, window), dtype=q.dtype, device=q.device)
    _build.check_tensor("q", q, (B, L, H, D), q.device)
    _build.check_tensor("kpad", kpad, (B, L + window - 1, H, D), q.device)
    _build.check_tensor("vpad", vpad, (B, L + window - 1, H, D), q.device)
    _build.check_tensor("rel", rel, (H, D, window), q.device)
    out = torch.empty((B, L, H, D), dtype=torch.float32, device=q.device)
    probs = torch.empty((B, L, H, window), dtype=torch.float32,
                        device=q.device)
    lib = _build.load("banded_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.banded_attention_fwd_launch(
        q.data_ptr(), kpad.data_ptr(), vpad.data_ptr(), rel.data_ptr(),
        out.data_ptr(), probs.data_ptr(), B, L, H, D, window,
        ctypes.c_void_p(stream))
    _build.check(err, "banded_attention_fwd")
    banded_attention_fwd.launches += 1
    return out, probs


banded_attention_fwd.launches = 0
