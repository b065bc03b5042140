"""Data-parallel training of the port (`reconvat_tpu_torch/parallel/`,
`train/state.py`, `train/driver.py`, the training CLIs' `mesh_dp`) on the
CPU, in gloo ranks on localhost.

- The six training CLIs resolve `mesh_dp`, `mesh_sp` and `multihost` as
  tests/test_mesh_driver.py expects of the JAX package's; `mesh_sp=2`, an
  indivisible batch and `mesh_dp=2` on `device=cuda` without a card raise
  before the run directory is written.
- Two ranks (`tests/torch_dp_worker.py`, spawned once, each on its rows of
  the global batch) against one process on the whole batch:
  - the port's `BatchNorm2d`, and flax's `BatchNorm` on the global batch,
    in float64: output, input and affine gradients, running statistics
    within 1e-12 (relative to each one's largest magnitude);
  - one flagship VAT step (xi 1e-2; the directions are the one-process
    step's draws, each rank keeping its rows) and one Segmentation step
    (dropout 0.4; supervised: in float64 the Segmentation VAT step's
    gradients move by 9e-9 of the largest between 1 and 4 CPU threads of
    one process, so its VAT step is held on the card by the fp32 rule),
    in float64: losses, the reduced gradients and the running statistics
    within 1e-9 relative (the gradients relative to the largest);
  - the ranks' parameters and statistics are bit-equal after each step;
  - one fp32 flagship VAT step at the default xi by the JAX package's
    criterion (tests/test_parallel_families.py:102-117): losses within
    rtol 3e-3 / atol 1e-4; after the one Adam step every parameter delta
    at most 2.05 x lr, the median under 1e-6, over 85 % under 1e-4.
- `MappedLoader` against the JAX package's; a dataset's cache is written
  whole (renamed into place), as ranks prepare the same files at once.
- The training CLI at `mesh_dp=2 device=cpu` (rank 0 here, rank 1 started
  by the CLI): one short epoch on files the test writes; rank 0 alone
  wrote the run directory; a resume at `mesh_dp=2` restores every tensor
  bit-equal.
Every collective waits at most 120 s (`parallel.distributed.TIMEOUT`, set
so in each rank) and every spawned process runs under a timeout of its
own. The 2-rank steps are also held against the JAX package's step on the
same weights and directions, beside its one-process comparisons:
tests/test_torch_train.py (the flagship's VAT step) and
tests/test_torch_segmentation.py (Segmentation's step).
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from reconvat_tpu.data.loader import MappedLoader as JaxMappedLoader
from reconvat_tpu_torch import train_UNet_VAT as cli
from reconvat_tpu_torch.data import datasets
from reconvat_tpu_torch.data.loader import MappedLoader
from reconvat_tpu_torch.parallel import distributed
from reconvat_tpu_torch.train import checkpoint as ckpt
from reconvat_tpu_torch.train import driver

from . import synth_data
from . import torch_dp_worker as worker
from .torch_threads import torch_one_thread  # noqa: F401

CLIS = ("train_UNet_VAT", "train_UNet_Onset_VAT", "train_baseline_Multi_Inst",
        "train_baseline_onset_frame_VAT", "train_baseline_Thickstun",
        "train_baseline_Prestack")
F64_RTOL = 1e-9


@pytest.mark.parametrize("name", CLIS)
def test_cli_configs_resolve_mesh_settings(name):
    mod = importlib.import_module(f"reconvat_tpu_torch.{name}")
    cfg = mod.ex._resolve({"mesh_dp": 4, "mesh_sp": 2})
    assert cfg["mesh_dp"] == 4 and cfg["mesh_sp"] == 2, name
    assert cfg["multihost"] is False, name
    cfg = mod.ex._resolve({})
    assert cfg["mesh_dp"] == 0 and cfg["mesh_sp"] == 0, name


def test_mesh_world():
    assert driver.mesh_world({}) == 1
    assert driver.mesh_world({"mesh_dp": 1, "mesh_sp": 1}) == 1
    assert driver.mesh_world({"mesh_dp": 3, "device": "cpu"}) == 3
    with pytest.raises(ValueError, match="every visible GPU"):
        driver.mesh_world({"mesh_dp": -1, "device": "cpu"})
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        driver.mesh_world({"mesh_sp": 2})
    assert driver.build_mesh({}) is None


@pytest.mark.parametrize("override,error,match", [
    ({"mesh_sp": 2, "device": "cpu"}, NotImplementedError, "item 3.3"),
    ({"mesh_dp": 2, "device": "cpu", "train_batch_size": 1}, ValueError,
     "batch"),
    ({"mesh_dp": 2, "device": "cpu", "train_batch_size": 2,
      "batch_size": 3}, ValueError, "batch"),
    ({"mesh_dp": 2, "train_batch_size": 2}, RuntimeError, "no CUDA device"),
])
def test_cli_refuses_mesh_before_any_work(tmp_path, monkeypatch, override,
                                          error, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        cli.ex.run(cli.train, {"root": str(tmp_path), "train_on": "nowhere",
                               **override})
    assert os.listdir(tmp_path) == []


def test_mapped_loader_matches_jax():
    batches = [{"audio": np.full((2, 3), i)} for i in range(4)]

    def double(batch):
        return {"audio": batch["audio"] * 2}

    got, ref = MappedLoader(batches, double), JaxMappedLoader(batches, double)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["audio"], b["audio"])


def test_dataset_cache_is_written_whole(tmp_path, monkeypatch):
    """The ranks of a data-parallel run prepare the same files at once, so
    a dataset's cache is written under another name and renamed into
    place: no reader opens a half-written cache. Each write goes to a
    file that is not the cache, the cache appears by a rename, and a
    second load reads it."""
    synth_data.make_maps_like(str(tmp_path), duration_s=1.0)
    written, savez = [], datasets.np.savez

    def record(file, **arrays):
        written.append(file.name)
        assert os.path.exists(file.name)
        return savez(file, **arrays)

    monkeypatch.setattr(datasets.np, "savez", record)
    first = datasets.MAPS(str(tmp_path), groups=["AkPnBcht"], verbose=False)
    cache = os.path.splitext(first.data[0]["path"])[0] + \
        datasets.CACHE_SUFFIX
    assert len(written) == 1 and written[0] != cache
    assert sorted(os.listdir(os.path.dirname(cache))) == sorted(
        [os.path.basename(first.data[0]["path"]), os.path.basename(cache)])
    again = datasets.MAPS(str(tmp_path), groups=["AkPnBcht"], verbose=False)
    assert len(written) == 1
    np.testing.assert_array_equal(again.data[0]["audio"],
                                  first.data[0]["audio"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(rank 0's results, rank 1's, the one-process results): the ranks
    run in two processes while this one computes the reference."""
    wait = worker.spawn(tmp_path_factory.mktemp("ranks"))
    try:
        ref = {"bn": worker.bn_run(*worker.bn_inputs())}
        for case in worker.CASES[1:]:
            ref[case] = worker.step_run(*worker.step_setup(case),
                                        worker.VAT[case])
    finally:
        ranks = wait()
    return tuple(ranks) + (ref,)


def _rel(got, ref):
    got, ref = (np.asarray(a, np.float64) for a in (got, ref))
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _flax_batchnorm():
    """flax's BatchNorm (training, momentum 0.9 = the port's 0.1) on the
    global batch in float64, channels last: output, input and affine
    gradients, and the new running statistics."""
    layer, x, w = worker.bn_inputs()
    nhwc = (0, 2, 3, 1)
    module = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
    with jax.enable_x64():
        variables = {
            "params": {"scale": jnp.asarray(layer.weight.detach().numpy()),
                       "bias": jnp.asarray(layer.bias.detach().numpy())},
            "batch_stats": {"mean": jnp.zeros(5, jnp.float64),
                            "var": jnp.ones(5, jnp.float64)}}
        xj = jnp.asarray(x.numpy().transpose(nhwc))
        wj = jnp.asarray(w.numpy().transpose(nhwc))

        def loss(params, xs):
            y, upd = module.apply({**variables, "params": params}, xs,
                                  mutable=["batch_stats"])
            return (y * wj).sum(), (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"], xj)
        back = (0, 3, 1, 2)
        return {"y": np.asarray(y).transpose(back),
                "dx": np.asarray(gx).transpose(back),
                "dweight": np.asarray(gp["scale"]),
                "dbias": np.asarray(gp["bias"]),
                "running_mean": np.asarray(stats["mean"]),
                "running_var": np.asarray(stats["var"])}


def test_batchnorm_two_ranks_match_one_process_and_flax(ranks):
    r0, r1, ref = ranks
    flax_ref = _flax_batchnorm()
    for k, v in ref["bn"].items():
        got = (torch.cat([r0["bn"][k], r1["bn"][k]]) if k in ("y", "dx")
               else r0["bn"][k])
        assert _rel(got, v) < 1e-12, k
        assert _rel(got, flax_ref[k]) < 1e-12, k
        if k not in ("y", "dx"):
            assert torch.equal(r0["bn"][k], r1["bn"][k]), k


@pytest.mark.parametrize("case", ["flagship64", "segmentation64"])
def test_float64_step_two_ranks_match_one_process(ranks, case):
    r0, r1, ref = ranks
    got, one = r0[case], ref[case]
    for k, v in r1[case]["state"].items():
        assert torch.equal(got["state"][k], v), k
    assert set(got["losses"]) == set(one["losses"])
    for k, v in one["losses"].items():
        assert got["losses"][k] == pytest.approx(v, rel=F64_RTOL), k
    top = max(g.abs().max().item() for g in one["grads"].values())
    for k, g in one["grads"].items():
        assert (got["grads"][k] - g).abs().max().item() <= F64_RTOL * top, k
    for k, v in one["state"].items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(got["state"][k], v) < F64_RTOL, k


def test_fp32_step_two_ranks_by_the_jax_criterion(ranks):
    r0, r1, ref = ranks
    got, one = r0["flagship32"], ref["flagship32"]
    for k, v in r1["flagship32"]["state"].items():
        assert torch.equal(got["state"][k], v), k
    for k, v in one["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=3e-3,
                                   atol=1e-4, err_msg=k)
    params = [k for k in one["grads"]]
    d = torch.cat([(got["state"][k] - one["state"][k]).abs().reshape(-1)
                   for k in params]).numpy()
    assert d.max() <= 2.05 * worker.LR, d.max()
    assert np.median(d) < 1e-6, np.median(d)
    assert np.mean(d < 1e-4) > 0.85, np.mean(d < 1e-4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """MAPS (4 AkPnBcht songs, one 2-s test song in each test group) and
    MAESTRO (2 songs) under a temporary root, named by the
    RECONVAT_*_ROOT variables."""
    root = tmp_path_factory.mktemp("corpora")
    maps = str(root / "MAPS")
    synth_data.make_maps_like(maps, groups=("AkPnBcht",), files_per_group=4,
                              duration_s=3.0)
    for i, group in enumerate(("ENSTDkAm", "ENSTDkCl")):
        synth_data.make_maps_like(maps, groups=(group,), duration_s=2.0,
                                  seed=60 + i)
    synth_data.make_maestro_like(str(root / "MAESTRO"), n_files=2,
                                 duration_s=3.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RECONVAT_MAPS_ROOT", maps)
        mp.setenv("RECONVAT_MAESTRO_ROOT", str(root / "MAESTRO"))
        mp.setattr(distributed, "TIMEOUT", worker.TIMEOUT)
        # the rank the CLI starts: one thread, as this process's torch work
        mp.setenv("OMP_NUM_THREADS", "1")
        yield root


def test_cli_trains_on_two_ranks_and_resumes(corpus):
    args = dict(device="cpu", train_on="MAPS", small=True, supersmall=False,
                sequence_length=32 * 512, batch_size=2, train_batch_size=2,
                iteration=2, epoches=1, saving_freq=1, logging_freq=1,
                compute_dtype=None, mesh_dp=2, eval_host_workers=0)
    model, state, metrics = cli.ex.run(cli.train, dict(
        args, root=str(corpus / "runs")))
    logdir = cli.ex.current_run.config["logdir"]
    assert os.listdir(corpus / "runs") == [os.path.basename(logdir)]
    names = sorted(os.listdir(logdir))
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    assert len(events) == 1, names                  # rank 0's alone
    assert [n for n in names if n not in events] == [
        "MIDI_results", "_sources", "config.json", "model-1", "result_dict",
        "run.json"]
    assert state.step == 2 and metrics is not None
    saved = ckpt.load_state(os.path.join(logdir, "model-1"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k

    resumed, r_state, _ = cli.ex.run(cli.train, dict(
        args, root=str(corpus / "resumed"), epoches=0,
        resume_iteration="latest", trained_dir=logdir))
    assert r_state.step == 2
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    opt = r_state.optimizer.state_dict()["state"]
    for i, slots in saved["optimizer"]["state"].items():
        for name, v in slots.items():
            assert torch.equal(opt[i][name], v), (i, name)
