"""Loss primitives (PyTorch counterpart of `reconvat_tpu/models/losses.py`).

`F.binary_cross_entropy` already has the semantics the JAX package rebuilds
by hand: logs clamped at -100 in the forward, and a backward of
(pred - target) / max(pred * (1 - pred), 1e-12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(x, frame_mask=None):
    """Mean over the frames selected by frame_mask (bool, (frames,), axis 1
    of x); the plain mean without a mask. A (batch, frames) mask gives the
    (batch,) vector of each row's own mean over its frames (the rows of
    a batch of songs, each padded to the same bucket)."""
    if frame_mask is None:
        return x.mean()
    if frame_mask.dim() == 2:
        m = frame_mask.reshape(frame_mask.shape + (1,) * (x.dim() - 2))
        scale = x[0].numel() // frame_mask.shape[1]   # trailing dims
        dims = tuple(range(1, x.dim()))
        return (torch.where(m, x, 0.0).sum(dims)
                / (frame_mask.sum(1) * scale))
    m = frame_mask.reshape((1, -1) + (1,) * (x.dim() - 2))
    scale = x.numel() // frame_mask.numel()   # batch x trailing dims
    return torch.where(m, x, 0.0).sum() / (frame_mask.sum() * scale)


def binary_cross_entropy(pred, target, frame_mask=None):
    """Mean BCE on probabilities."""
    return _masked_mean(F.binary_cross_entropy(pred, target,
                                               reduction="none"), frame_mask)


def mse_loss(pred, target, frame_mask=None):
    return _masked_mean((pred - target) ** 2, frame_mask)


def binary_kl_div(y_pred, y_ref):
    """Per-bin Bernoulli KL(q_pred || p_ref), summed and divided by the
    batch size (torch `reduction='batchmean'`)."""
    y_pred = y_pred.clamp(1e-4, 0.9999)
    y_ref = y_ref.clamp(1e-4, 0.9999)
    q = torch.stack((y_pred, 1 - y_pred), -1)
    p = torch.stack((y_ref, 1 - y_ref), -1)
    return (q * (q.log() - p.log())).sum() / y_pred.shape[0]
