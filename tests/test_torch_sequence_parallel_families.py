"""Sequence parallelism (`mesh_sp`) in Segmentation and Thickstun
(`reconvat_tpu_torch/models/segmentation.py`, `models/thickstun.py`, the
halos of `parallel/mesh.py:time_halo`) on the CPU, in gloo ranks on
localhost (`tests/torch_dp_worker.py`, one process a rank, one torch
thread each), against one process on the whole batch and against the JAX
package:

- `time_halo` with halos of 1.5x and 3x a rank's frames and one-sided
  halos, on 2 and 4 ranks: each rank's haloed frames and the gradient of a
  weighted sum over every rank's output equal the whole tensor's
  zero-padded slices and their gradient, exactly (integer-valued float64,
  so every sum is exact in any order);
- `draw_rows` on time axis 1 and 2, and `SharedDropout` on an NCHW input,
  at mesh_sp=2 and mesh_dp=2 x mesh_sp=2: each rank's draw and mask are
  its rows and frames of the one-process draw and mask, exactly;
- Segmentation's float64 VAT step (xi 1e-2, dropout 0.4) on 2 + 2 clips of
  64 frames, the JAX family test's length (tests/test_parallel_families.py),
  at mesh_sp=2 and at mesh_dp=2 x mesh_sp=2, its supervised step at
  mesh_sp=2, and Thickstun's float64 step on 2 clips of 20 frames (10 a
  rank, fewer than its 12-frame halo; 16 does not divide 20) at mesh_sp=2:
  losses, the reduced gradients and the BatchNorm running statistics
  within F64_RTOL = 1e-9 of one process (the gradients relative to the
  largest), the ranks' parameters and statistics bit-equal. The ranks sum
  each convolution over other frame counts than one process does, so the
  steps differ by rounding. Segmentation's train step at random init
  amplifies float64 rounding to 1e-9-1e-8 of the largest gradient (its
  first convolution's): one process on SPREAD_THREADS threads differs from
  itself on one by that much. So a Segmentation step is held within the
  larger of 1e-9 and SPREAD_FACTOR x that spread, read in the run (the
  ranks land at 1.0x of it); a wrong halo moves the gradients by O(1);
- negative controls: the supervised Segmentation step at mesh_sp=2 with
  the strided convolutions' interior (0, 1) TF-SAME pads zero-padded in
  place of the next rank's first frame, or with every halo zero-padded
  (`torch_dp_worker.broken_halos`), must miss that bound;
- against the JAX package (one jitted `jax.value_and_grad` of the
  train-mode frame BCE on the port's spec):
  - Segmentation's supervised step with dropout 0, both in float64, on
    the JAX pair's weights (tests/test_torch_segmentation.py's `_pair`),
    in one process and at mesh_sp=2 (rank 0): the frame BCE, the new
    running statistics and every gradient, at tests/test_torch_
    segmentation.py's tolerances (loss atol and rtol 1e-4, statistics
    rtol 1e-4 and atol 1e-5, gradients 1e-4 of the largest; the gap is
    3.5e-6). The JAX package rounds the attention's energies, softmax
    and output to fp32 in x64 mode, and at these 64 frames the step's
    conditioning moves the first convolution's gradient by 2e-2 of the
    largest for that alone; so the port's step runs here with the same
    roundings (`torch_dp_worker.jax_attention_casts`), and the port's own
    attention, without them, is held to one process above;
  - Thickstun's step, both in float64, with NARROW_K2_OUT = 64 channels
    in its time convolution in place of 4096 ('thick64sp_narrow': XLA's
    float64 convolution on the CPU takes 113 s for the full width's
    step), otherwise as the case above, in one process and at mesh_sp=2
    (rank 0): the frame BCE (tests/test_torch_thickstun_prestack.py's
    rtol 1e-4, atol 1e-7) and every gradient (THICKSTUN_GRAD_ATOL of the
    largest; the gap is 4.3e-8), the JAX gradients clipped as the step
    clips its own (norm 3).
The CLIs at mesh_sp=2 and the refusals are in
tests/test_torch_sequence_parallel_clis.py. Every collective waits at most
120 s and every rank runs under a timeout of its own.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.models.losses import binary_cross_entropy as jax_bce
from reconvat_tpu.models.thickstun import Thickstun as JaxThickstun
from reconvat_tpu.models.thickstun import ThickstunModule
from reconvat_tpu_torch.weights import flax_to_torch

from . import torch_dp_worker as worker
from .test_torch_segmentation import (_assert_step_matches_jax, _close, _jit,
                                      _pair)
from .test_torch_thickstun_prestack import _template
from .torch_threads import torch_one_thread  # noqa: F401

F64_RTOL = 1e-9
# Segmentation's float64 train step at random init is ill-conditioned: one
# process on SPREAD_THREADS threads differs from itself on one by 1e-9 to
# 1e-8 of the largest gradient (the first convolution's)
SPREAD_THREADS, SPREAD_FACTOR = 4, 3
JAX_FRAMES = worker.SEG_FRAMES
# Thickstun's gradients against the JAX package's float64 step: each
# leaf's largest gap over the largest gradient. The JAX module rounds the
# sigmoid's input to fp32 in x64 mode, which moves them by 7e-8 of the
# largest at full width
THICKSTUN_GRAD_ATOL = 1e-6
TWO = [("halo_long", 2), ("draw", 2), ("seg64sp", 2), ("seg64sp_novat", 2),
       ("seg64sp_zero_strided_pads", 2), ("seg64sp_no_halos", 2),
       ("thick64sp", 2), ("thick64sp_narrow", 2), ("seg_jax", 2)]
FOUR = [("halo_long", 4), ("draw", 2), ("seg64sp", 2)]  # dp 2 x sp 2


def _jax_batch():
    """The float64 labeled batch of the JAX comparison: 2 clips of
    JAX_FRAMES."""
    rng = np.random.RandomState(2)
    return {"audio": torch.from_numpy(rng.randn(2, JAX_FRAMES * 512) * 0.1),
            "frame": torch.from_numpy(
                (rng.rand(2, JAX_FRAMES, 88) < 0.05).astype(np.float64))}


def _jax_step(module, variables, spec, label, port, clip=0.0) -> dict:
    """JAX's float64 train-mode frame BCE, its gradients and, where the
    variables hold `batch_stats`, the new running statistics (as the
    port's state-dict names of `port`), one jitted `jax.value_and_grad`;
    with `clip` the gradients scaled as `torch.nn.utils.clip_grad_norm_`
    scales the port's."""
    bn = "batch_stats" in variables

    def loss_fn(params, x, y):
        if not bn:
            return jax_bce(module.apply({"params": params}, x, train=True),
                           y), {}
        pred, upd = module.apply({"params": params, "batch_stats": stats},
                                 x, train=True, mutable=["batch_stats"])
        return jax_bce(pred, y), upd["batch_stats"]

    with jax.enable_x64():
        params, stats = (jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables.get(k, {}))
            for k in ("params", "batch_stats"))
        (loss, new), grads = jax.tree_util.tree_map(np.asarray, _jit(
            jax.value_and_grad(loss_fn, has_aux=True), level=2)(
                params, jnp.asarray(spec), jnp.asarray(label)))
    if clip:
        norm = np.sqrt(sum((g ** 2).sum()
                           for g in jax.tree_util.tree_leaves(grads)))
        scale = min(1.0, clip / (norm + 1e-6))
        grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
    return {"loss": loss,
            "stats": flax_to_torch({"params": variables["params"],
                                    "batch_stats": new}, port) if bn else {},
            "grads": flax_to_torch({"params": grads}, port)}


def _thickstun_jax(tmp_path) -> dict:
    """`_jax_step` of the narrow Thickstun case ('thick64sp_narrow') on its
    weights, read by the JAX package's loader from a `.pt`."""
    model, batch_l, _, _ = worker.family_setup("thick64sp_narrow")
    path = str(tmp_path / "thickstun.pt")
    torch.save(model.state_dict(), path)
    jmodel = JaxThickstun()
    jmodel.module = ThickstunModule(k2_out=worker.NARROW_K2_OUT)
    variables = jmodel.load_reference_weights(
        path, _template(jmodel, worker.THICK_FRAMES))
    spec = model.make_spec(batch_l["audio"]).detach().numpy()
    return _jax_step(jmodel.module, variables, spec,
                     batch_l["frame"].numpy(), model, clip=3.0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({world: each rank's results}, the one-process results, JAX's
    steps by family): the 2- and 4-rank groups run in their processes
    while this one computes the references."""
    jmodel, variables, port = _pair()
    batch = _jax_batch()
    port = port.double()
    spec = port.make_spec(batch["audio"]).detach().numpy()
    seg_jax = {"model": "Segmentation", "kwargs": {"dropout_rate": 0.0},
               "state": port.state_dict(), "batch_l": batch,
               "batch_ul": None, "vat": False, "seed": 0, "jax_casts": True}
    waits = {}
    for world, cases in ((2, TWO), (4, FOUR)):
        out = tmp_path_factory.mktemp(f"families{world}")
        job = os.path.join(out, "job.pt")
        torch.save({"cases": cases, "jobs": {"seg_jax": seg_jax}}, job)
        waits[world] = worker.spawn(out, world, job)
    got, failed = {}, []
    try:
        ref = {f"halo_long{sp}": worker.halo_reference(
            sp, worker.LONG_HALO_SHAPES) for sp in (2, 4)}
        ref["draw"] = worker.draw_run()
        for case in ("seg64sp", "seg64sp_novat", "thick64sp",
                     "thick64sp_narrow"):
            ref[case] = worker.family_run(case)
        # one process's own spread: the same steps summed in another order
        threads = torch.get_num_threads()
        torch.set_num_threads(SPREAD_THREADS)
        try:
            for case in ("seg64sp", "seg64sp_novat"):
                ref[f"spread_{case}"] = max(_gaps(
                    [worker.family_run(case)], ref[case]).values())
        finally:
            torch.set_num_threads(threads)
        with worker.jax_attention_casts():
            ref["seg_jax"] = worker.step_run(port, batch, None, False,
                                             seed=0, clip=0.0)
        jax_ref = {"seg": _jax_step(jmodel.module, variables, spec,
                                    batch["frame"].numpy(), port),
                   "thick": _thickstun_jax(tmp_path_factory.mktemp("jax"))}
    finally:
        for world, wait in waits.items():
            try:
                got[world] = wait()
            except AssertionError as e:
                failed.append(e)
    if failed:
        raise failed[0]
    return got, ref, jax_ref


def _gaps(results: list, one: dict) -> dict:
    """How rank 0's step (`torch_dp_worker.step_run`) differs from one
    process's: each loss's relative gap, each gradient's largest gap over
    the largest gradient magnitude, each running statistic's largest gap
    over its largest magnitude. Fails unless the ranks' states are
    bit-equal."""
    for res in results[1:]:
        for k, v in res["state"].items():
            assert torch.equal(results[0]["state"][k], v), k
    got = results[0]
    assert set(got["losses"]) == set(one["losses"])
    gaps = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-300)
            for k, v in one["losses"].items()}
    top = max(g.abs().max().item() for g in one["grads"].values())
    gaps.update({f"grad {k}": (got["grads"][k] - g).abs().max().item() / top
                 for k, g in one["grads"].items()})
    for k, v in one["state"].items():
        if k.endswith(("running_mean", "running_var")):
            gaps[k] = ((got["state"][k] - v).abs().max().item()
                       / max(v.abs().max().item(), 1e-300))
    return gaps


def _bound(ref: dict, case: str) -> float:
    """F64_RTOL, or SPREAD_FACTOR x one process's own spread where that is
    larger (Segmentation's steps, `ref["spread_<case>"]`)."""
    return max(F64_RTOL, SPREAD_FACTOR * ref.get(f"spread_{case}", 0.0))


def _assert_step_matches(results: list, ref: dict, case: str):
    gaps = _gaps(results, ref[case])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= _bound(ref, case), (worst, gaps[worst],
                                             _bound(ref, case))


@pytest.mark.parametrize("sp", [2, 4])
def test_long_and_one_sided_halos_match_zero_padded_slices(ranks, sp):
    got, ref, _ = ranks
    for i, per_rank in enumerate(ref[f"halo_long{sp}"]):
        for r, (y, dx) in enumerate(per_rank):
            y_r, dx_r = got[sp][r]["halo_long"][i]
            assert torch.equal(y_r, y), (worker.LONG_HALO_SHAPES[i], r)
            assert torch.equal(dx_r, dx), (worker.LONG_HALO_SHAPES[i], r)


@pytest.mark.parametrize("world", [2, 4], ids=["sp2", "dp2xsp2"])
def test_draws_and_dropout_masks_are_the_one_process_slices(ranks, world):
    got, ref, _ = ranks
    dp = world // 2
    for i, (shape, dim) in enumerate(worker.DRAW_SHAPES):
        for r in range(world):
            rows = slice(r // 2 * shape[0] // dp,
                         (r // 2 + 1) * shape[0] // dp)
            per = shape[dim] // 2
            for got_t, one in zip(got[world][r]["draw"][i], ref["draw"][i]):
                want = one[rows].narrow(dim, r % 2 * per, per)
                assert torch.equal(got_t, want), (shape, dim, r)


@pytest.mark.parametrize("world", [2, 4], ids=["sp2", "dp2xsp2"])
def test_segmentation_vat_step_matches_one_process(ranks, world):
    got, ref, _ = ranks
    _assert_step_matches([got[world][r]["seg64sp"] for r in range(world)],
                         ref, "seg64sp")


def test_segmentation_supervised_step_matches_one_process(ranks):
    got, ref, _ = ranks
    _assert_step_matches([got[2][r]["seg64sp_novat"] for r in range(2)],
                         ref, "seg64sp_novat")


@pytest.mark.parametrize("broken", ["zero_strided_pads", "no_halos"])
def test_broken_halos_miss_the_one_process_step(ranks, broken):
    """The negative controls: the same comparison as the supervised step's
    above, on ranks whose halos are zero-padded."""
    got, ref, _ = ranks
    gaps = _gaps([got[2][r][f"seg64sp_{broken}"] for r in range(2)],
                 ref["seg64sp_novat"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] > _bound(ref, "seg64sp_novat"), (worst, gaps[worst])


def test_thickstun_step_matches_one_process(ranks):
    got, ref, _ = ranks
    _assert_step_matches([got[2][r]["thick64sp"] for r in range(2)],
                         ref, "thick64sp")


@pytest.mark.parametrize("where", ["one_process", "sp2"])
def test_segmentation_step_matches_jax(ranks, where):
    got, ref, jax_ref = ranks
    res = ref["seg_jax"] if where == "one_process" else got[2][0]["seg_jax"]
    _assert_step_matches_jax(jax_ref["seg"], res["losses"]["loss/train_frame"],
                             res["grads"], res["state"])


@pytest.mark.parametrize("where", ["one_process", "sp2"])
def test_thickstun_step_matches_jax(ranks, where):
    got, ref, jax_ref = ranks
    case = "thick64sp_narrow"
    res = ref[case] if where == "one_process" else got[2][0][case]
    ref_grads = jax_ref["thick"]["grads"]
    _close("loss/train_frame", res["losses"]["loss/train_frame"],
           jax_ref["thick"]["loss"], atol=1e-7)
    top = max(g.abs().max().item() for g in ref_grads.values())
    assert sorted(res["grads"]) == sorted(ref_grads)
    for name, g in ref_grads.items():
        gap = (res["grads"][name] - g.double()).abs().max().item() / top
        assert gap <= THICKSTUN_GRAD_ATOL, (name, gap)
