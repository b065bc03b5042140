"""Sequence parallelism of the port (`mesh_sp`: the time axis over ranks,
`reconvat_tpu_torch/parallel/mesh.py`, the halos of `nn/unet.py` and
`nn/attention.py`) and streaming over ranks (`models/common.py:
transcribe_streaming(mesh_ctx=...)`) on the CPU, in gloo ranks on
localhost (`tests/torch_dp_worker.py`, one process a rank, one torch
thread each), against one process on the whole batch:

- `time_halo` on 2 and 4 ranks: each rank's haloed frames and the
  gradient of a weighted sum over every rank's output equal the whole
  tensor's zero-padded slices and their gradient, exactly (integer-valued
  float64, so every sum is exact in any order);
- the flagship's eval-mode forward with reconstruction at mesh_sp=2
  (float64): every output within 1e-10 of its largest magnitude (the JAX
  package's sharded forward is held within 2e-5 in fp32,
  tests/test_parallel.py);
- the flagship's VAT step (float64, xi 1e-2) at mesh_sp=2 and at mesh_dp=2
  x mesh_sp=2, and UNetOnset's at mesh_sp=2: losses, the reduced
  gradients and the BatchNorm running statistics within F64_RTOL = 1e-9
  (the gradients relative to the largest), the ranks' parameters and
  statistics bit-equal (tests/test_torch_train.py and
  tests/test_torch_unet_onset.py hold the flagship's and UNetOnset's sp
  steps against the JAX package's single-device step);
- streaming a song over 2 ranks, on Mel and CQT: every rank returns one
  device's roll bit for bit (each window is the same computation);
- a crop whose frames do not split over mesh_sp into multiples of 16
  raises ValueError before any work, and the two CLIs resolve dp x sp;
- `train_UNet_Onset_VAT` at mesh_sp=2 (rank 0 here, rank 1 started by
  the CLI) trains one short epoch on files the test writes, rank 0 alone
  writing the run directory, and its checkpoint holds the returned
  model.
Every collective waits at most 120 s and every rank runs under a timeout
of its own.
"""
import os

import numpy as np
import pytest
import torch

from reconvat_tpu_torch import train_UNet_Onset_VAT as onset_cli
from reconvat_tpu_torch import train_UNet_VAT as cli
from reconvat_tpu_torch.parallel import distributed
from reconvat_tpu_torch.parallel import mesh as pmesh
from reconvat_tpu_torch.train import checkpoint as ckpt
from reconvat_tpu_torch.train import driver

from . import synth_data
from . import torch_dp_worker as worker
from .torch_threads import torch_one_thread  # noqa: F401

F64_RTOL = 1e-9
EVAL_RTOL = 1e-10
TWO = [("halo", 2), ("eval", 2), ("flagship64sp", 2), ("onset64sp", 2),
       ("stream_Mel", 2), ("stream_CQT", 2)]
FOUR = [("halo", 4), ("flagship64sp", 2)]     # the step at dp 2 x sp 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({world: each rank's results}, the one-process results): the 2- and
    4-rank groups run in their processes while this one computes the
    references."""
    waits = {}
    for world, cases in ((2, TWO), (4, FOUR)):
        out = tmp_path_factory.mktemp(f"sp{world}")
        job = os.path.join(out, "job.pt")
        torch.save({"cases": cases}, job)
        waits[world] = worker.spawn(out, world, job)
    got, failed = {}, []
    try:
        ref = {"halo2": worker.halo_reference(2),
               "halo4": worker.halo_reference(4),
               "eval": worker.eval_run()}
        for case in ("flagship64sp", "onset64sp"):
            ref[case] = worker.step_run(*worker.sp_setup(case), True)
        for spec in ("Mel", "CQT"):
            ref[f"stream_{spec}"] = worker.stream_run(spec)
    finally:
        for world, wait in waits.items():
            try:
                got[world] = wait()
            except AssertionError as e:
                failed.append(e)
    if failed:
        raise failed[0]
    return got, ref


def _rel(got, ref):
    got, ref = (np.asarray(a, np.float64) for a in (got, ref))
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("sp", [2, 4])
def test_time_halo_matches_zero_padded_slices(ranks, sp):
    got, ref = ranks
    for i, per_rank in enumerate(ref[f"halo{sp}"]):
        for r, (y, dx) in enumerate(per_rank):
            y_r, dx_r = got[sp][r]["halo"][i]
            assert torch.equal(y_r, y), (i, r)
            assert torch.equal(dx_r, dx), (i, r)


def test_eval_forward_two_ranks_matches_one_process(ranks):
    got, ref = ranks
    for k, v in ref["eval"].items():
        whole = torch.cat([got[2][r]["eval"][k] for r in range(2)], dim=1)
        assert whole.shape == v.shape, k
        assert _rel(whole, v) < EVAL_RTOL, (k, _rel(whole, v))


def _assert_step_matches(results: list, one: dict):
    for res in results[1:]:
        for k, v in res["state"].items():
            assert torch.equal(results[0]["state"][k], v), k
    got = results[0]
    assert set(got["losses"]) == set(one["losses"])
    for k, v in one["losses"].items():
        assert got["losses"][k] == pytest.approx(v, rel=F64_RTOL), k
    top = max(g.abs().max().item() for g in one["grads"].values())
    for k, g in one["grads"].items():
        assert (got["grads"][k] - g).abs().max().item() <= F64_RTOL * top, k
    for k, v in one["state"].items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(got["state"][k], v) < F64_RTOL, k


@pytest.mark.parametrize("world", [2, 4], ids=["sp2", "dp2xsp2"])
def test_flagship_vat_step_matches_one_process(ranks, world):
    got, ref = ranks
    _assert_step_matches([got[world][r]["flagship64sp"]
                          for r in range(world)], ref["flagship64sp"])


def test_unet_onset_vat_step_two_ranks_matches_one_process(ranks):
    got, ref = ranks
    _assert_step_matches([got[2][r]["onset64sp"] for r in range(2)],
                         ref["onset64sp"])


@pytest.mark.parametrize("spec", ["Mel", "CQT"])
def test_streaming_two_ranks_returns_one_devices_roll(ranks, spec):
    got, ref = ranks
    one = ref[f"stream_{spec}"]
    assert one.shape[0] == 1 and one.shape[2] == 88
    for r in range(2):
        assert torch.equal(got[2][r][f"stream_{spec}"], one), r


@pytest.mark.parametrize("module", [cli, onset_cli],
                         ids=["train_UNet_VAT", "train_UNet_Onset_VAT"])
def test_bad_frame_split_raises_before_any_work(tmp_path, module):
    """24 frames over 2 ranks (12 a rank) and 32 over 4 (8) are not
    multiples of 16; 32 over 2 and 64 over dp 2 x sp 2 resolve."""
    for sp, frames in ((2, 24), (4, 32)):
        with pytest.raises(ValueError, match=f"mesh_sp={sp}"):
            module.ex.run(module.train, {
                "root": str(tmp_path), "device": "cpu", "train_on": "nowhere",
                "mesh_sp": sp, "sequence_length": frames * 512})
    assert os.listdir(tmp_path) == []
    cfg = {"device": "cpu", "batch_size": 2, "train_batch_size": 2,
           "VAT": True, "spec": "Mel"}
    assert driver.check_mesh(dict(cfg, mesh_sp=2,
                                  sequence_length=32 * 512)) == 2
    assert driver.check_mesh(dict(cfg, mesh_dp=2, mesh_sp=2,
                                  sequence_length=64 * 512)) == 4
    with pytest.raises(ValueError, match="multiples of 16"):
        pmesh.check_sp_frames(40, 2)


def test_onset_cli_trains_at_mesh_sp_2(tmp_path, monkeypatch):
    maps = str(tmp_path / "MAPS")
    synth_data.make_maps_like(maps, groups=("AkPnBcht",), files_per_group=4,
                              duration_s=3.0)
    for i, group in enumerate(("ENSTDkAm", "ENSTDkCl")):
        synth_data.make_maps_like(maps, groups=(group,), duration_s=2.0,
                                  seed=60 + i)
    synth_data.make_maestro_like(str(tmp_path / "MAESTRO"), n_files=2,
                                 duration_s=3.0)
    monkeypatch.setenv("RECONVAT_MAPS_ROOT", maps)
    monkeypatch.setenv("RECONVAT_MAESTRO_ROOT", str(tmp_path / "MAESTRO"))
    monkeypatch.setattr(distributed, "TIMEOUT", worker.TIMEOUT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    model, state, metrics = onset_cli.ex.run(onset_cli.train, dict(
        device="cpu", train_on="MAPS", small=True, supersmall=False,
        sequence_length=32 * 512, batch_size=2, train_batch_size=2,
        iteration=2, epoches=1, saving_freq=1, logging_freq=1,
        compute_dtype=None, mesh_sp=2, eval_host_workers=0,
        root=str(tmp_path / "runs")))
    logdir = onset_cli.ex.current_run.config["logdir"]
    names = sorted(os.listdir(logdir))
    assert len([n for n in names if n.startswith("events.out")]) == 1
    assert {"model-1", "result_dict", "MIDI_results"} <= set(names)
    assert state.step == 2 and metrics is not None
    saved = ckpt.load_state(os.path.join(logdir, "model-1"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
