"""Port's ReconVAT train step vs the JAX package, on the CPU.

One `run_on_batch` with reconstruction and VAT on a labeled and an
unlabeled batch (B = 2 + 2, 32 frames), from the same weights and the same
VAT directions: every loss, every parameter gradient of the total loss
(the JAX gradient tree mapped by `flax_to_torch`) and the new BatchNorm
running statistics.

The directions are pinned: the port draws them from a torch.Generator,
the test draws the same numbers and hands them to the JAX `vat_loss`
through a wrapper (as tests/test_vat_ref_reuse.py wraps it); nothing in
the JAX package changes.

Both sides run in float64 (JAX x64 mode, as tests/test_vat_ref_reuse.py
runs it; the port's model cast with `.double()`), at xi = 1e-2. The power
iteration's gradient is proportional to y_pred - y_ref, because the
objective's minimum is at y_ref; on a randomly initialised transcriber
that difference is small, and in fp32 it is rounding noise that no two
implementations share (the adversarial directions of the two packages
differ by ~1e-2 in fp32 at any xi from 1e-2 to 1). In float64 it is not.

Tolerances (float64):
- losses: rtol 1e-7; BatchNorm running statistics: rtol 1e-7, atol 1e-8
  (means near zero of O(1) activations). The JAX attention takes its
  softmax in float32 even in x64 mode (`reconvat_tpu/nn/attention.py:197`),
  ~4e-7 relative on its output.
- gradients: at random init the step's gradient is ill-conditioned. A
  random transcriber outputs ~0.5 everywhere, so the reconstructor and the
  second transcriber pass run train-mode BatchNorm on near-constant
  signals; perturbing the audio by 1e-9 (relative) moves either
  package's own gradient by up to ~1e-2 on some leaves. So each leaf is
  held to the JAX gradient's own movement under a PROBE = 1e-7 (relative)
  perturbation of the audio, the size of the float32 softmax rounding
  above: max |port - jax| <= 3 x max |jax(probe) - jax| + 1e-9 x (the
  largest gradient magnitude). Measured, the port's gap is at most 1.1x
  that movement on every leaf; a well-conditioned leaf is held to the
  1e-9 floor.
- the route test (the port's attention op vs autograd of its plain
  forward, both in the port, float64): losses rtol 1e-7, gradients, each
  leaf divided by the larger of its largest magnitude and 1e-4 of the
  largest over all leaves, atol 1e-6 (the floor covers the biases of
  convolutions that feed a train-mode BatchNorm, whose true gradient is
  zero).
- the fp32 default-xi case is checked for what must hold: finite losses
  and an adversarial perturbation of norm eps per vector.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reconvat_tpu.models.reconvat as jreconvat_mod
from reconvat_tpu import vat as jvat
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu.train.state import total_loss_from_dict as jax_total
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.train.state import (create_train_state,
                                            make_eval_step, make_train_step,
                                            total_loss_from_dict)
from reconvat_tpu_torch import weights

from . import torch_dp_worker as worker
from .torch_threads import torch_one_thread  # noqa: F401

B, FRAMES, XI, SEED = 2, 32, 1e-2, 11
F64_TOL = dict(rtol=1e-7, atol=1e-12)
STATS_TOL = dict(rtol=1e-7, atol=1e-8)
F64_GRAD_ATOL = 1e-6
PROBE, PROBE_FACTOR, F64_GRAD_FLOOR = 1e-7, 3.0, 1e-9


def _batches(seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    n = FRAMES * 512
    return ({"audio": (rng.randn(B, n) * 0.1).astype(dtype),
             "frame": (rng.rand(B, FRAMES, 88) < 0.05).astype(dtype)},
            {"audio": (rng.randn(B, n) * 0.1).astype(dtype)})


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _perturbed(variables, seed=0):
    """Random biases, BN scales and running statistics on top of the init
    (init biases are zero and BN the identity), in float64."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float64)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape)
        if name in ("bias", "mean"):
            return v + 0.05 * rng.randn(*v.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, v.shape)
        return v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _directions():
    """The port's two float64 VAT draws from `SEED`: unlabeled chain, then
    labeled."""
    g = torch.Generator().manual_seed(SEED)
    shape = (B, FRAMES, 229, 1)
    return [torch.randn(shape, generator=g, dtype=torch.float64).numpy()
            for _ in range(2)]


@pytest.fixture(scope="module")
def reference():
    """JAX losses, gradients and new batch stats of one VAT train step in
    float64, with the VAT directions pinned; jitted once."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield _reference_x64()
    finally:
        jax.config.update("jax_enable_x64", False)


def _reference_x64():
    model = JaxReconVAT(conv_layout="nhwc", xi=XI)
    variables = _perturbed(model.init(jax.random.PRNGKey(0),
                                      seq_frames=FRAMES))
    batch_l, batch_ul = _batches(dtype=np.float64)
    dirs = [jnp.asarray(d) for d in _directions()]

    def pinned(apply_fn, x, key, cfg, init_d=None, y_ref=None, split=None):
        return jvat.vat_loss(apply_fn, x, key, cfg, init_d=dirs.pop(0),
                             y_ref=y_ref, split=split)

    def loss_fn(params, batch_l, batch_ul):
        _, losses, _, new_stats = model.run_on_batch(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch_l, batch_ul, jax.random.PRNGKey(1), vat=True, train=True)
        return jax_total(losses, 1.0), (losses, new_stats)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreconvat_mod, "vat_loss", pinned)
        grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
        grads, (losses, new_stats) = grad_fn(variables["params"], batch_l,
                                             batch_ul)
        # the same step on audio perturbed by PROBE (relative): how far
        # the JAX gradient itself moves, leaf by leaf
        rng = np.random.RandomState(7)
        probe = [{**b, "audio": b["audio"] * (1 + PROBE * rng.randn(
            *b["audio"].shape))} for b in (batch_l, batch_ul)]
        grads_probe, _ = grad_fn(variables["params"], *probe)
    return variables, grads, grads_probe, losses, new_stats


def _to_f64(tree):
    """`flax_to_torch` (same names and layouts) keeping float64 values."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "_tensor",
                   lambda w: torch.tensor(np.asarray(w, np.float64)))
        return weights.flax_to_torch(tree)


def _assert_grads_close(got: dict, expect: dict, atol: float):
    """Per leaf, over max(leaf's max |g|, 1e-4 x the max over leaves)."""
    floor = 1e-4 * max(g.abs().max().item() for g in expect.values())
    assert set(got) == set(expect)
    for name, g in expect.items():
        scale = max(g.abs().max().item(), floor)
        np.testing.assert_allclose(got[name].numpy() / scale,
                                   g.numpy() / scale, rtol=0, atol=atol,
                                   err_msg=name)


def _assert_step_matches_jax(reference, got: dict, grads: dict,
                             state: dict):
    """The port's losses, gradients (of the total loss) and new running
    statistics against the JAX step's, by the tolerances above."""
    variables, jgrads, grads_probe, losses, new_stats = reference
    assert set(got) == set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(got[k]), float(v), **F64_TOL,
                                   err_msg=k)
    expect, moved = (_to_f64({"params": g}) for g in (jgrads, grads_probe))
    assert set(grads) == set(expect)
    top = max(g.abs().max().item() for g in expect.values())
    for name, g in expect.items():
        diff = (grads[name] - g).abs().max().item()
        self_move = (moved[name] - g).abs().max().item()
        assert diff <= PROBE_FACTOR * self_move + F64_GRAD_FLOOR * top, (
            name, diff / top, self_move / top)
    stats = _to_f64({"params": {}, "batch_stats": new_stats})
    assert len(stats) == 2 * 30 + 30        # mean, var, batch count x 30
    for name, v in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[name].numpy(), v.numpy(),
                                       **STATS_TOL, err_msg=name)


def test_vat_train_step_matches_jax(reference):
    variables = reference[0]
    model = ReconVAT(device="cpu", xi=XI).double()
    model.load_state_dict(_to_f64(variables), strict=True)
    batch_l, batch_ul = (_torch_batch(b)
                         for b in _batches(dtype=np.float64))
    _, got, _ = model.run_on_batch(batch_l, batch_ul,
                                   torch.Generator().manual_seed(SEED),
                                   vat=True, train=True)
    total_loss_from_dict(got, 1.0).backward()
    _assert_step_matches_jax(
        reference, {k: v.item() for k, v in got.items()},
        {n: p.grad for n, p in model.named_parameters()},
        model.state_dict())


def test_vat_train_step_two_ranks_matches_jax(reference, tmp_path):
    """The same step data-parallel over 2 gloo ranks of 1 + 1 clips
    (`make_train_step` under a mesh, unclipped; tests/torch_dp_worker.py):
    each rank draws the global batch's directions from the same seed and
    keeps its rows, so the pinned directions. The all-reduced losses and
    gradients and the global BatchNorm statistics against the JAX step's
    by the one-process tolerances; the ranks' new parameters and
    statistics bit-equal."""
    r0, r1 = worker.run_job(tmp_path, {
        "model": "ReconVAT", "kwargs": {"xi": XI},
        "state": _to_f64(reference[0]), "vat": True, "seed": SEED,
        **dict(zip(("batch_l", "batch_ul"), (
            _torch_batch(b) for b in _batches(dtype=np.float64))))})
    for k, v in r1["state"].items():
        assert torch.equal(r0["state"][k], v), k
    losses = {k: v for k, v in r0["losses"].items() if k != "loss/total"}
    _assert_step_matches_jax(reference, losses, r0["grads"], r0["state"])


def test_kernel_route_matches_plain_route_on_cpu():
    """The model through the attention op (its backward the plain
    backward on the CPU) and through autograd of the plain forward: same
    losses and gradients, with VAT, in float64."""
    batch_l, batch_ul = (_torch_batch(b)
                         for b in _batches(seed=1, dtype=np.float64))
    model = ReconVAT(device="cpu", xi=XI, seed=2).double()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for use_kernels in (True, False):
        model.load_state_dict(start)
        model.use_kernels(use_kernels)
        model.zero_grad()
        _, losses, _ = model.run_on_batch(
            batch_l, batch_ul, torch.Generator().manual_seed(3), vat=True)
        total_loss_from_dict(losses, 1.0).backward()
        results.append((losses, {n: p.grad.clone()
                                 for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = results
    for k in la:
        torch.testing.assert_close(la[k], lb[k], **F64_TOL)
    _assert_grads_close(ga, gb, F64_GRAD_ATOL)


def test_default_xi_step_is_finite_and_updates_in_place():
    """At the default xi the losses are finite, each r_adv vector has norm
    eps, and make_train_step updates the parameters, the running
    statistics and the schedule in place."""
    model = ReconVAT(device="cpu", seed=1)
    batch_l, batch_ul = (_torch_batch(b) for b in _batches(seed=2))
    preds, losses, spec = model.run_on_batch(
        batch_l, batch_ul, torch.Generator().manual_seed(0), vat=True)
    assert tuple(spec.shape) == (B, FRAMES, 229)
    norms = torch.linalg.vector_norm(preds["r_adv"], dim=2)
    torch.testing.assert_close(norms, torch.full_like(norms, 2.0))
    assert all(torch.isfinite(v) for v in losses.values())

    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model)
    step = make_train_step(model, alpha=1.0, vat=True, use_unlabeled=True)
    out = step(state, batch_l, batch_ul, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in out.values())
    assert out["loss/total"].item() == pytest.approx(
        total_loss_from_dict({k: v for k, v in out.items()
                              if k != "loss/total"}, 1.0).item())
    assert state.step == 1
    after = model.state_dict()
    for key in ("transcriber.linear1.weight",
                "transcriber.Unet1_encoder.block1.bn1.running_var"):
        assert not torch.equal(before[key], after[key]), key

    evaluated = make_eval_step(model)(batch_l)
    assert not model.training
    assert set(evaluated) == {"loss/test_reconstruction", "loss/test_frame",
                              "loss/test_frame2", "loss/test_LDS_l",
                              "loss/test_r_norm_l"}
