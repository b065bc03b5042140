"""Port's train-mode BatchNorm, losses, VAT and optimizer vs the JAX
package, on the CPU.

Tolerances, fp32 on both sides:
- BatchNorm output, batch statistics and input gradient: atol 1e-5 (rtol
  1e-5); the JAX layer forms the variance as E[x^2] - mean^2, torch as a
  two-pass sum, over 2 x 16 x 40 values per channel.
- losses and their gradients: rtol 1e-6 (atol 1e-7), elementwise formulas
  that differ only in the order of the mean; the saturated BCE gradient
  (1e12-clamped denominator) is compared at rtol 1e-6 too.
- vat_loss: rtol 1e-4, atol 1e-5 on the loss, r_adv and the direction,
  at xi = 0.1 with the perturbed input clear of the [0, 1] clamp. The
  objective's minimum is at y_ref, so the power iteration's gradient is
  proportional to y_pred - y_ref, a difference of size ~xi: fp32 rounding
  of the predictions (~6e-8) shows in the direction at ~1e-6 / xi
  relative. At the default xi = 1e-6 it is rounding noise (see
  tests/test_torch_train.py).
- optimizer: rtol 1e-5 on the parameters after each step; torch's
  clip_grad_norm_ divides by norm + 1e-6 where optax divides by the norm,
  a relative difference of 1e-6 / norm (about 2e-7 here).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu import vat as jvat
from reconvat_tpu.models import losses as jlosses
from reconvat_tpu.nn.unet import FoldSpec, MaskedBatchNorm
from reconvat_tpu.train.state import make_optimizer
from reconvat_tpu_torch import vat
from reconvat_tpu_torch.models import losses
from reconvat_tpu_torch.nn.unet import BatchNorm2d, frozen_batch_stats
from reconvat_tpu_torch.train.state import (apply_gradients,
                                            create_train_state,
                                            total_loss_from_dict)


def _close(a, b, rtol, atol, name=""):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a),
                               np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=name)


def test_train_batchnorm_matches_jax():
    """Output, input gradient and the biased running-variance update of
    the port's BatchNorm2d in training, against the JAX NHWC
    MaskedBatchNorm (FoldSpec(F, 1)); the frozen switch keeps batch
    statistics and drops the update."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 16, 40, 6) * 2 + 1).astype(np.float32)   # NHWC
    g = rng.randn(*x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    ra_mean = rng.randn(6).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bn = MaskedBatchNorm()
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}
    fold = FoldSpec(40, 1)

    def f(x_):
        return bn.apply(variables, x_, False, fold, mutable=["batch_stats"])

    y, updates = f(jnp.asarray(x))
    _, vjp = jax.vjp(lambda x_: f(x_)[0], jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))

    port = BatchNorm2d(6, eps=1e-5)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(ra_mean))
        port.running_var.copy_(torch.from_numpy(ra_var))
    port.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    with frozen_batch_stats(port):
        frozen = port(xt)
    torch.testing.assert_close(port.running_var, torch.from_numpy(ra_var),
                               rtol=0, atol=0)
    yt = port(xt)
    yt.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    torch.testing.assert_close(frozen, yt, rtol=0, atol=0)
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(yt.permute(0, 2, 3, 1), y, **tol)
    _close(xt.grad.permute(0, 2, 3, 1), gx, **tol)
    _close(port.running_mean, updates["batch_stats"]["mean"], **tol)
    _close(port.running_var, updates["batch_stats"]["var"], **tol)
    assert port.update_stats


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.RandomState(1)
    pred = rng.uniform(0.01, 0.99, (2, 12, 5)).astype(np.float32)
    target = (rng.rand(2, 12, 5) < 0.3).astype(np.float32)
    # saturated predictions: the 1e12 gradient clamp and the -100 log
    # clamp of torch's BCE, which the JAX package rebuilds by hand
    pred[0, 0, :3] = [0.0, 1.0, 1e-30]
    target[0, 0, :3] = [1.0, 0.0, 1.0]
    mask = np.arange(12) < 9 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    tol = dict(rtol=1e-6, atol=1e-7)
    for name, jf, tf in (("bce", jlosses.binary_cross_entropy,
                          losses.binary_cross_entropy),
                         ("mse", jlosses.mse_loss, losses.mse_loss)):
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(pred),
                                        jnp.asarray(target), jmask)
        p = torch.from_numpy(pred).requires_grad_()
        tv = tf(p, torch.from_numpy(target), tmask)
        tv.backward()
        _close(tv, jv, **tol, name=name)
        _close(p.grad, jg, **tol, name=f"{name} grad")
    soft = rng.uniform(0.0, 1.0, pred.shape).astype(np.float32)
    jv, jg = jax.value_and_grad(jlosses.binary_kl_div)(jnp.asarray(pred),
                                                       jnp.asarray(soft))
    p = torch.from_numpy(pred).requires_grad_()
    tv = losses.binary_kl_div(p, torch.from_numpy(soft))
    tv.backward()
    _close(tv, jv, rtol=1e-6, atol=1e-6, name="kl")
    _close(p.grad, jg, rtol=1e-6, atol=1e-7, name="kl grad")


def test_l2_normalize_floors_the_norm():
    d = torch.zeros(2, 3, 4)
    d[0, 1] = torch.tensor([3.0, 0.0, 4.0, 0.0])
    out = vat.l2_normalize(d, axis=2)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 1], torch.tensor([0.6, 0.0, 0.8, 0.0]))
    assert out[1].abs().sum() == 0


@pytest.mark.parametrize("kl_div,split", [(False, None), (True, None),
                                          (False, 2)])
def test_vat_loss_matches_jax(kl_div, split):
    """vat_loss on a small differentiable model (sigmoid of a per-frame
    linear map of the spec) with the same pinned direction on both sides,
    clean forward recomputed (split=None) or passed as y_ref (split)."""
    rng = np.random.RandomState(2)
    x = rng.uniform(0.2, 0.8, (4, 6, 10, 1)).astype(np.float32)
    w = (rng.randn(10, 7) * 0.5).astype(np.float32)
    d0 = rng.randn(*x.shape).astype(np.float32)
    cfg = dict(xi=0.1, eps=2.0, kl_div=kl_div, norm_axis=2)

    def jfn(x_):
        return jax.nn.sigmoid(x_[..., 0] @ jnp.asarray(w))

    y_ref = None if split is None else jfn(jnp.asarray(x))
    jl, jr, jd = jvat.vat_loss(jfn, jnp.asarray(x), None,
                               jvat.VATConfig(n_power=1, **cfg),
                               init_d=jnp.asarray(d0),
                               y_ref=y_ref, split=split)

    wt = torch.from_numpy(w).requires_grad_()

    def tfn(x_):
        return torch.sigmoid(x_[..., 0] @ wt)

    y_ref = None if split is None else tfn(torch.from_numpy(x))
    tl, tr, td = vat.vat_loss(tfn, torch.from_numpy(x), None,
                              vat.VATConfig(**cfg),
                              init_d=torch.from_numpy(d0), y_ref=y_ref,
                              split=split)
    tol = dict(rtol=1e-4, atol=1e-5)
    for a, b in zip((tl,) if split is None else tl,
                    (jl,) if split is None else jl):
        _close(a, b, **tol, name="loss")
    _close(tr, jr, **tol, name="r_adv")
    _close(td, jd, **tol, name="direction")
    # the loss's gradient reaches the model's parameters, not the direction
    (tl if split is None else tl[0]).backward()
    assert wt.grad is not None and wt.grad.abs().sum() > 0


def test_total_loss_scales_lds_terms():
    got = total_loss_from_dict({"loss/train_frame": torch.tensor(1.0),
                                "loss/train_LDS_l": torch.tensor(2.0),
                                "loss/train_LDS_ul": torch.tensor(4.0)}, 0.5)
    assert float(got) == 1.0 + 0.5 * (2.0 + 4.0) / 2


def test_optimizer_schedule_and_clip_match_optax():
    """Adam + staircase decay (every 2 steps here) + global-norm clipping
    to 3 before the update, on a toy parameter over 5 steps, against the
    JAX package's make_optimizer; gradients alternate above and below the
    clip norm."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(7).astype(np.float32)
    grads = [(rng.randn(7) * s).astype(np.float32)
             for s in (5.0, 0.1, 3.0, 0.5, 10.0)]
    tx, _ = make_optimizer(learning_rate=0.1, decay_steps=2, decay_rate=0.5,
                           clip_gradient_norm=3.0)
    jp, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(jp)

    module = torch.nn.Module()
    module.p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    state = create_train_state(module, learning_rate=0.1, decay_steps=2,
                               decay_rate=0.5, clip_gradient_norm=3.0)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = jp + updates
        module.p.grad = torch.from_numpy(g.copy())
        apply_gradients(module, state)
        _close(module.p, jp, rtol=1e-5, atol=1e-7, name=f"step {i}")
    assert state.step == 5
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.1 * 0.25)
