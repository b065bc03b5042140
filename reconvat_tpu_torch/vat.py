"""Virtual Adversarial Training (PyTorch counterpart of
`reconvat_tpu/vat.py`, reference `model/self_attention_VAT.py:101-246`).

One power iteration finds the adversarial direction in spectrogram space:
the gradient of the objective with respect to a random direction d, taken
with `torch.autograd.grad` and detached, as the reference's
`loss.backward(); d = d.grad`. The perturbed input is clamped to [0, 1],
and the direction is scaled by 1e10 against fp32 underflow before it is
normalized again. The direction is drawn in x's dtype (fp32 in both compute
dtypes: a bf16 model casts the perturbed input at its first convolution,
as the JAX package does, so at the default xi the perturbation is mostly
rounded away there and the direction is zero wherever the clean and
perturbed predictions agree bit for bit).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .models.losses import binary_cross_entropy, binary_kl_div

GRAD_RESCUE = 1e10   # d * 1e10 underflow rescue of the UNet variants


@dataclasses.dataclass(frozen=True)
class VATConfig:
    xi: float = 1e-6
    eps: float = 2.0
    kl_div: bool = False
    norm_axis: int = -1         # axis of the per-vector L2 norm


def l2_normalize(d, axis: int = -1):
    """d over its L2 norm along `axis`, the norm floored at 1e-30 so that
    an all-zero direction (a saturated model whose gradient underflows)
    gives a zero perturbation instead of NaN, as in the JAX package."""
    norm = torch.linalg.vector_norm(d, dim=axis, keepdim=True)
    return d / norm.clamp_min(1e-30)


def vat_loss(apply_fn: Callable, x, generator, cfg: VATConfig, init_d=None,
             y_ref=None, split: int | None = None):
    """Returns (loss, r_adv, d_normalized).

    apply_fn(x) -> prediction tensor. The loss's gradient flows into the
    parameters that apply_fn uses; the adversarial direction is detached.
    d is drawn from `generator` (on x's device) unless `init_d` gives it.
    y_ref: the clean prediction, when the caller already has it; it is
    detached either way. split: x is two chains stacked on the batch axis
    (`[:split]` and `[split:]`), and the loss is the pair of their
    objectives."""
    objective = binary_kl_div if cfg.kl_div else binary_cross_entropy
    if y_ref is None:
        with torch.no_grad():
            y_ref = apply_fn(x)
    y_ref = y_ref.detach()
    if init_d is None:
        d = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=x.dtype)
    else:
        d = init_d

    def perturbed(r):
        return (x + r).clamp(0.0, 1.0)

    # one power iteration, as every ReconVAT configuration runs it
    d = d.detach().requires_grad_(True)
    r = cfg.xi * l2_normalize(d, cfg.norm_axis)
    adv = objective(apply_fn(perturbed(r)), y_ref)
    grad, = torch.autograd.grad(adv, d)
    d = grad.detach() * GRAD_RESCUE
    r_adv = cfg.eps * l2_normalize(d, cfg.norm_axis)
    y_pred = apply_fn(perturbed(r_adv))
    d_normalized = l2_normalize(d, cfg.norm_axis)
    if split is None:
        return objective(y_pred, y_ref), r_adv, d_normalized
    return ((objective(y_pred[:split], y_ref[:split]),
             objective(y_pred[split:], y_ref[split:])), r_adv, d_normalized)
