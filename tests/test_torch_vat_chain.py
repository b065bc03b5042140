"""The port's VAT options against the JAX package, and its batched VAT
chain and adversarial-forward remat against their contracts, on the CPU.

- `vat_loss` with n_power=2, binwise, clamp=False and a custom objective
  over a dict of predictions, on a small sigmoid-linear model, the
  direction pinned: rtol 1e-4, atol 1e-5, the tolerances of
  tests/test_torch_vat.py, in float64 on both sides. binwise makes each
  element of the perturbation +-eps by the sign of its gradient, so in
  fp32 the elements whose gradient is rounding noise flip sign between
  the packages (2e-3 relative on the loss).
- `vat_chain='batched'` against the port's two separate chains with the
  same directions and BatchNorm frozen on its running statistics (the JAX
  package's own contract, tests/test_vat_batched_chain.py), in float64:
  losses rtol 1e-10, gradients rtol 1e-9 (the two chains' only coupling
  is the power objective's mean over 2B instead of B, a power-of-two
  scale the normalization removes; the rest is summation order).
- The batched chain's and the application objective's losses against the
  JAX package's: tests/test_torch_vat_jax.py.
- Remat on against off (`RECONVAT_VAT_REMAT=1`, fp32): equal losses,
  gradients and running statistics, to the bit: the recompute runs the
  same forward on the same values.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu import vat as jvat
from reconvat_tpu_torch import vat
from reconvat_tpu_torch.models import reconvat as reconvat_mod
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.nn.unet import BatchNorm2d, running_stats
from reconvat_tpu_torch.train.state import total_loss_from_dict

from .torch_threads import torch_one_thread  # noqa: F401

FRAMES, XI, SEED = 32, 0.1, 5
F64_LOSS_RTOL, F64_GRAD_RTOL = 1e-10, 1e-9


def _batches(b, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    n = FRAMES * 512
    return ({"audio": (rng.randn(b, n) * 0.1).astype(dtype),
             "frame": (rng.rand(b, FRAMES, 88) < 0.05).astype(dtype)},
            {"audio": (rng.randn(b, n) * 0.1).astype(dtype)})


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(a, b, rtol, atol, name=""):
    np.testing.assert_allclose(
        np.asarray(a.detach() if torch.is_tensor(a) else a), np.asarray(b),
        rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", ["n_power", "binwise", "objective"])
def test_vat_loss_options_match_jax(case):
    """n_power=2 / binwise / clamp=False with a custom objective over a
    dict of two heads, against the JAX vat_loss, the direction pinned."""
    rng = np.random.RandomState(3)
    x = rng.uniform(0.2, 0.8, (3, 6, 10, 1))
    w = rng.randn(10, 7) * 0.5
    d0 = rng.randn(*x.shape)
    cfg = dict(xi=0.1, eps=2.0, norm_axis=2)
    if case == "n_power":
        cfg["n_power"] = 2
    elif case == "binwise":
        cfg["binwise"] = True
    else:
        cfg["clamp"] = False

    def objective(lib):
        def fn(y_pred, y_ref):
            tree = {k: lib.mean((y_pred[k] - y_ref[k]) ** 2) * (i + 1)
                    for i, k in enumerate(sorted(y_pred))}
            return tree["a"] + tree["b"], tree
        return fn

    def jfn(x_):
        z = x_[..., 0] @ jnp.asarray(w)
        if case != "objective":
            return jax.nn.sigmoid(z)
        return {"a": jax.nn.sigmoid(z), "b": jnp.tanh(z)}

    jcfg = jvat.VATConfig(**cfg, objective=(objective(jnp)
                                            if case == "objective"
                                            else None))
    jax.config.update("jax_enable_x64", True)
    try:
        jl, jr, jd = jax.tree_util.tree_map(np.asarray, jvat.vat_loss(
            jfn, jnp.asarray(x), None, jcfg, init_d=jnp.asarray(d0)))
    finally:
        jax.config.update("jax_enable_x64", False)
    wt = torch.from_numpy(w).requires_grad_()

    def tfn(x_):
        z = x_[..., 0] @ wt
        if case != "objective":
            return torch.sigmoid(z)
        return {"a": torch.sigmoid(z), "b": torch.tanh(z)}

    tcfg = vat.VATConfig(**cfg, objective=(objective(torch)
                                           if case == "objective" else None))
    tl, tr, td = vat.vat_loss(tfn, torch.from_numpy(x), None, tcfg,
                              init_d=torch.from_numpy(d0))
    tol = dict(rtol=1e-4, atol=1e-5)
    if case == "objective":
        assert set(tl) == set(jl) == {"a", "b"}
        for k in tl:
            _close(tl[k], jl[k], **tol, name=k)
        (tl["a"] + tl["b"]).backward()
    else:
        _close(tl, jl, **tol, name="loss")
        tl.backward()
    _close(tr, jr, **tol, name="r_adv")
    _close(td, jd, **tol, name="direction")
    assert wt.grad is not None and wt.grad.abs().sum() > 0


def _port_model(seed=0, **kw):
    """A float64 port model with random BatchNorm statistics and biases."""
    model = ReconVAT(device="cpu", xi=XI, reconstruction=True, **kw)
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.add_(0.05 * torch.randn(
                    m.running_mean.shape, generator=g))
            if isinstance(getattr(m, "bias", None), torch.Tensor):
                m.bias.add_(0.05 * torch.randn(m.bias.shape, generator=g))
    return model.double()


def _losses_grads(model, batch_l, batch_ul, generator):
    model.zero_grad(set_to_none=True)
    _, losses, _ = model.run_on_batch(batch_l, batch_ul, generator,
                                      vat=True, train=True)
    total_loss_from_dict(losses, 1.0).backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def test_batched_chain_equals_separate_frozen_chains(monkeypatch):
    """vat_chain='batched' (one draw of 2B directions) equals the
    separate chains run on the running statistics with the two halves of
    that draw (the unlabeled chain first), in losses and gradients."""
    batch_l, batch_ul = (_torch(b) for b in _batches(2))
    model = _port_model(vat_chain="batched")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    stats = running_stats(model)
    losses_b, grads_b = _losses_grads(
        model, batch_l, batch_ul, torch.Generator().manual_seed(SEED))
    d_all = torch.randn((4, FRAMES, 229, 1), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(SEED))

    model.load_state_dict(before)
    model.vat_chain = "separate"
    orig_fn = ReconVAT._transcriber_fn
    monkeypatch.setattr(ReconVAT, "_transcriber_fn",
                        lambda self, train, _=None: orig_fn(self, False,
                                                            stats))
    real_vat, calls = reconvat_mod.vat_loss, []

    def pinned(apply_fn, x, generator, cfg, init_d=None, y_ref=None,
               split=None):
        seg = d_all[2:] if not calls else d_all[:2]
        calls.append(1)
        return real_vat(apply_fn, x, generator, cfg, init_d=seg,
                        y_ref=y_ref)

    monkeypatch.setattr(reconvat_mod, "vat_loss", pinned)
    losses_s, grads_s = _losses_grads(model, batch_l, batch_ul, None)
    assert len(calls) == 2
    assert set(losses_b) == set(losses_s)
    for k in losses_s:
        _close(losses_b[k], losses_s[k], F64_LOSS_RTOL, 1e-14, k)
    for n in grads_s:
        scale = max(grads_s[n].abs().max().item(), 1e-12)
        _close(grads_b[n] / scale, grads_s[n] / scale, 0, F64_GRAD_RTOL, n)


def test_remat_matches_stored_forward(monkeypatch):
    """RECONVAT_VAT_REMAT=1 recomputes the adversarial forward inside the
    backward: the same losses, gradients and running statistics (the
    recompute leaves them alone) as storing it."""
    batch_l, batch_ul = (_torch(b) for b in _batches(1, dtype=np.float32))
    out = []
    for remat in ("0", "1"):
        monkeypatch.setenv("RECONVAT_VAT_REMAT", remat)
        model = ReconVAT(device="cpu", xi=XI, reconstruction=False)
        losses, grads = _losses_grads(model, batch_l, batch_ul,
                                      torch.Generator().manual_seed(SEED))
        stats = {k: v for k, v in model.state_dict().items()
                 if "running" in k}
        out.append((losses, grads, stats))
    for a, b in zip(out[0], out[1]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]),
                               torch.as_tensor(b[k])), k
