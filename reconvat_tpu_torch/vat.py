"""Virtual Adversarial Training (PyTorch counterpart of
`reconvat_tpu/vat.py`, reference `model/self_attention_VAT.py:101-246`).

`n_power` power iterations find the adversarial direction in spectrogram
space: the gradient of the objective with respect to a random direction d,
taken with `torch.autograd.grad` and detached, as the reference's
`loss.backward(); d = d.grad`. The perturbed input is clamped to [0, 1]
(`clamp`), and the direction is scaled by `grad_rescue` (1e10) against fp32
underflow before it is normalized again. The direction is drawn in x's
dtype (fp32 in both compute dtypes: a bf16 model casts the perturbed input
at its first convolution, as the JAX package does, so at the default xi
the perturbation is mostly rounded away there and the direction is zero
wherever the clean and perturbed predictions agree bit for bit).

`RECONVAT_VAT_REMAT=1` recomputes the adversarial forward in the outer
backward (`torch.utils.checkpoint`) instead of storing its activations:
less peak memory for one more forward. The recompute runs after the
caller's code has returned, so `apply_fn` must itself set up whatever the
forward needs (the model's VAT functions set BatchNorm's mode and freeze
its running statistics inside the call).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from .models.common import tree_map
from .models.losses import binary_cross_entropy, binary_kl_div
from .parallel import mesh as pmesh

GRAD_RESCUE = 1e10   # d * 1e10 underflow rescue of the UNet variants


@dataclasses.dataclass(frozen=True)
class VATConfig:
    xi: float = 1e-6
    eps: float = 2.0
    n_power: int = 1
    kl_div: bool = False
    binwise: bool = False
    grad_rescue: float = GRAD_RESCUE
    norm_axis: int = -1         # axis of the per-vector L2 norm
    clamp: bool = True          # clamp the perturbed input to [0, 1]
    # (y_pred_tree, y_ref_tree) -> (total, loss_tree), in place of the
    # BCE/KL sum over the prediction tree
    objective: Callable | None = None


def l2_normalize(d, axis: int = -1, binwise: bool = False):
    """d over its L2 norm along `axis`, the norm floored at 1e-30 so that
    an all-zero direction (a saturated model whose gradient underflows)
    gives a zero perturbation instead of NaN, as in the JAX package;
    binwise: d / (|d| + 1e-8), each element on its own."""
    if binwise:
        return d / (d.abs() + 1e-8)
    norm = torch.linalg.vector_norm(d, dim=axis, keepdim=True)
    return d / norm.clamp_min(1e-30)


def _tree_objective(y_pred, y_ref, kl_div: bool):
    """BCE (or KL) of each leaf; the total sums the leaves in sorted key
    order, as `jax.tree_util.tree_leaves` orders a dict."""
    obj = binary_kl_div if kl_div else binary_cross_entropy
    losses = tree_map(obj, y_pred, y_ref)
    if not isinstance(losses, dict):
        return losses, losses
    leaves = [losses[k] for k in sorted(losses)]
    return sum(leaves[1:], leaves[0]), losses


def vat_loss(apply_fn: Callable, x, generator, cfg: VATConfig, init_d=None,
             y_ref=None, split: int | None = None):
    """Returns (loss_tree, r_adv, d_normalized).

    apply_fn(x) -> prediction tensor, or dict of them; the loss tree has
    its structure. The loss's gradient flows into the parameters that
    apply_fn uses; the adversarial direction is detached. d is drawn from
    `generator` (on x's device) unless `init_d` gives it. y_ref: the clean
    prediction, when the caller already has it; it is detached either way.
    Inside a data-parallel step d is this rank's rows of the global batch's
    draw (`parallel.mesh.draw_rows`).
    split: x is two chains stacked on the batch axis (`[:split]` and
    `[split:]`), and the loss is the pair of their objectives."""

    def objective(y_pred, y_ref_):
        if cfg.objective is not None:
            return cfg.objective(y_pred, y_ref_)
        return _tree_objective(y_pred, y_ref_, cfg.kl_div)

    if y_ref is None:
        with torch.no_grad():
            y_ref = apply_fn(x)
    y_ref = tree_map(torch.Tensor.detach, y_ref)
    if init_d is None:
        d = pmesh.draw_rows(lambda shape: torch.randn(
            shape, generator=generator, device=x.device, dtype=x.dtype),
            x.shape, split)
    else:
        d = init_d

    def perturbed(r):
        return (x + r).clamp(0.0, 1.0) if cfg.clamp else x + r

    for _ in range(cfg.n_power):
        d = d.detach().requires_grad_(True)
        r = cfg.xi * l2_normalize(d, cfg.norm_axis, cfg.binwise)
        total, _ = objective(apply_fn(perturbed(r)), y_ref)
        grad, = torch.autograd.grad(total, d)
        d = grad.detach() * cfg.grad_rescue
    r_adv = cfg.eps * l2_normalize(d, cfg.norm_axis, cfg.binwise)

    def adv_fwd(r):
        return apply_fn(perturbed(r))

    if os.environ.get("RECONVAT_VAT_REMAT") == "1":
        y_pred = checkpoint(adv_fwd, r_adv, use_reentrant=False)
    else:
        y_pred = adv_fwd(r_adv)
    d_normalized = l2_normalize(d, cfg.norm_axis, cfg.binwise)
    if split is None:
        return objective(y_pred, y_ref)[1], r_adv, d_normalized

    def seg(tree, sl):
        return tree_map(lambda a: a[sl], tree)

    head, tail = slice(None, split), slice(split, None)
    return ((objective(seg(y_pred, head), seg(y_ref, head))[1],
             objective(seg(y_pred, tail), seg(y_ref, tail))[1]),
            r_adv, d_normalized)
