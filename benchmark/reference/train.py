"""Plain PyTorch reference of one semi-supervised training step of the
flagship and of UNetOnset (reference `UNet.run_on_batch` and
`model/helper_functions.py:train_VAT_model`, as the JAX package runs
them): the unlabelled VAT chain, the labelled full forward (transcriber,
reconstructor, transcriber again) with its losses, the labelled VAT chain,
the LDS terms at alpha / 2, the gradient's global norm clipped to 3 before
the update, Adam, and a per-step staircase decay.

VAT (`model/self_attention_VAT.py:101-246`): d ~ N(0, 1) of the spec
image's shape, drawn from the step's generator (the unlabelled chain's
first, then the labelled chain's); one power iteration of
r = xi d / |d| over the bins, the gradient of the BCE between the
perturbed and the clean prediction with respect to d, times 1e10; the
adversarial input clamp(x + eps d / |d|, 0, 1). The chains run the
transcriber with BatchNorm on the batch's moments and the running
statistics left alone.

Imports torch and the reference model only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import fp32_math

GRAD_RESCUE = 1e10
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def _normalize(d):
    return d / torch.linalg.vector_norm(d, dim=2, keepdim=True).clamp_min(
        1e-30)


def _bce_tree(pred, ref):
    """{key: BCE} of a tensor or dict of rolls, and their sum in sorted key
    order."""
    if not isinstance(pred, dict):
        loss = F.binary_cross_entropy(pred, ref)
        return loss, loss
    losses = {k: F.binary_cross_entropy(pred[k], ref[k]) for k in pred}
    keys = sorted(losses)
    return sum((losses[k] for k in keys[1:]), losses[keys[0]]), losses


def _detach(tree):
    if isinstance(tree, dict):
        return {k: v.detach() for k, v in tree.items()}
    return tree.detach()


def vat(fn, x, generator, xi, eps, y_ref=None):
    """(LDS tree, mean |d / |d||) of one VAT chain."""
    if y_ref is None:
        with torch.no_grad():
            y_ref = fn(x)
    y_ref = _detach(y_ref)
    d = torch.randn(x.shape, generator=generator, device=x.device,
                    dtype=x.dtype)
    d = d.requires_grad_(True)
    total, _ = _bce_tree(fn((x + xi * _normalize(d)).clamp(0.0, 1.0)),
                         y_ref)
    grad, = torch.autograd.grad(total, d)
    d = grad.detach() * GRAD_RESCUE
    r_adv = eps * _normalize(d)
    _, lds = _bce_tree(fn((x + r_adv).clamp(0.0, 1.0)), y_ref)
    return lds, _normalize(d).abs().mean()


def losses_of_batch(model, signal, p, s, batch_l, batch_ul, generator, xi,
                    eps):
    """The step's losses under the reference's names; `s` (running
    statistics) moves as the supervised forward moves it."""
    def chain(x):
        return model.vat_target(model.transcriber(x, p, s, "frozen")[0])

    spec_ul = signal(batch_ul["audio"])
    lds_ul, rn_ul = vat(chain, spec_ul, generator, xi, eps)
    spec = signal(batch_l["audio"])
    first, _ = model.transcriber(spec, p, s, "train")
    recon = model.reconstructor(first["frame"], p, s, "train")
    second, _ = model.transcriber(recon, p, s, "train")
    lds_l, rn_l = vat(chain, spec, generator, xi, eps,
                      y_ref=model.vat_target(first))

    frame = batch_l["frame"]
    losses = {
        "loss/train_reconstruction": (recon[..., 0] - spec[..., 0]).square()
        .mean(),
        "loss/train_frame": F.binary_cross_entropy(first["frame"], frame),
        "loss/train_frame2": F.binary_cross_entropy(second["frame"], frame),
    }
    if isinstance(lds_l, dict):
        onset = batch_l["onset"]
        losses["loss/train_onset"] = F.binary_cross_entropy(first["onset"],
                                                            onset)
        losses["loss/train_onset2"] = F.binary_cross_entropy(
            second["onset"], onset)
        for k in sorted(lds_l):
            losses[f"loss/train_LDS_l_{k}"] = lds_l[k]
            losses[f"loss/train_LDS_ul_{k}"] = lds_ul[k]
    else:
        losses["loss/train_LDS_l"] = lds_l
        losses["loss/train_LDS_ul"] = lds_ul
    losses["loss/train_r_norm_l"] = rn_l
    losses["loss/train_r_norm_ul"] = rn_ul
    return losses


def total_loss(losses, alpha):
    return sum(alpha * v / 2.0 if k.startswith("loss/train_LDS") else v
               for k, v in losses.items())


class Adam:
    """torch.optim.Adam's update (no weight decay, bias-corrected) with the
    staircase decay lr * rate ** (step // decay_steps)."""

    def __init__(self, lr, decay_steps, decay_rate):
        self.lr, self.decay_steps, self.decay_rate = lr, decay_steps, \
            decay_rate
        self.m, self.v, self.t = {}, {}, 0

    def update(self, p, grads):
        lr = self.lr * self.decay_rate ** (self.t // self.decay_steps)
        self.t += 1
        b1, b2 = ADAM_BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            self.m[k] = m = b1 * m + (1 - b1) * g
            self.v[k] = v = b2 * v + (1 - b2) * g * g
            denom = v.sqrt() / math.sqrt(c2) + ADAM_EPS
            p[k] = p[k] - (lr / c1) * m / denom


def step(model, signal, p, s, opt, batch_l, batch_ul, generator, cfg):
    """One training step in place on the parameters `p`, the running
    statistics `s` and the optimizer. Returns (detached losses, the
    clipped gradients the optimizer took)."""
    with fp32_math():
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        losses = losses_of_batch(model, signal, leaves, s, batch_l, batch_ul,
                                 generator, cfg["xi"], cfg["eps"])
        total = total_loss(losses, cfg["alpha"])
        keys = list(leaves)
        grads = torch.autograd.grad(total, [leaves[k] for k in keys],
                                    allow_unused=True)
        grads = {k: g.detach() for k, g in zip(keys, grads) if g is not None}
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = (cfg["clip_gradient_norm"] / (norm + 1e-6)).clamp(max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        with torch.no_grad():
            opt.update(p, grads)
    return {k: v.detach() for k, v in losses.items()}, grads
