"""The training CLIs of Segmentation (`train_baseline_Multi_Inst`) and
Thickstun (`train_baseline_Thickstun`) at `mesh_sp=2` on the CPU (rank 0
here, rank 1 started by the CLI, gloo, one torch thread each), and the
refusals of sequence parallelism, on files the test writes:

- Multi_Inst trains one short epoch at its defaults otherwise (VAT off;
  tests/test_torch_sequence_parallel_families.py holds the VAT step at
  mesh_sp=2) on crops of 32 frames (16 a rank) and Thickstun one
  full-epoch sweep on crops of 20 frames (10 a rank: its frames need only
  divide); rank 0 alone writes the run
  directory, whose checkpoint holds the returned model; a resume of the
  Multi_Inst run (`resume_iteration=latest`, no epoch, the same mesh)
  restores every tensor of the model and the optimizer bit-equal;
- a Segmentation crop whose frames do not split over mesh_sp into
  multiples of 16, and a Thickstun crop whose frames do not divide, raise
  ValueError before the run directory is written;
- the O&F and Prestack CLIs, and every attention model (which has no CLI:
  `train.driver.check_settings` and `make_spec` inside a
  sequence-parallel step), refuse mesh_sp=2 with NotImplementedError
  naming the JAX package's data-parallel-only families.
The test songs are a 2-s one in ENSTDkAm alone: every rank evaluates each
song whole at the 640-frame bucket, the largest part of the Thickstun run
on one CPU thread. Gloo all-reduces between CPU ranks take milliseconds,
and a Segmentation VAT step at mesh_sp=2 makes 921 of them (426 halo
exchanges, 495 BatchNorm all-reduces), so the Multi_Inst run keeps VAT
off.
"""
import os

import pytest
import torch

from reconvat_tpu_torch import train_baseline_Multi_Inst as multi_cli
from reconvat_tpu_torch import train_baseline_onset_frame_VAT as of_cli
from reconvat_tpu_torch import train_baseline_Prestack as prestack_cli
from reconvat_tpu_torch import train_baseline_Thickstun as thickstun_cli
from reconvat_tpu_torch.models import MODEL_REGISTRY, get_model
from reconvat_tpu_torch.parallel import distributed
from reconvat_tpu_torch.parallel import mesh as pmesh
from reconvat_tpu_torch.train import checkpoint as ckpt
from reconvat_tpu_torch.train import driver

from . import synth_data
from . import torch_dp_worker as worker
from .torch_threads import torch_one_thread  # noqa: F401

ARGS = dict(device="cpu", train_on="MAPS", small=True, supersmall=False,
            epoches=1, saving_freq=1, logging_freq=1, compute_dtype=None,
            mesh_sp=2, eval_host_workers=0)
DP_ONLY = "data-parallel only"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    maps = str(root / "MAPS")
    synth_data.make_maps_like(maps, groups=("AkPnBcht",), files_per_group=2,
                              duration_s=3.0)
    synth_data.make_maps_like(maps, groups=("ENSTDkAm",), duration_s=2.0,
                              seed=60)
    synth_data.make_maestro_like(str(root / "MAESTRO"), n_files=2,
                                 duration_s=3.0)
    return root


@pytest.fixture
def sp_env(corpus, monkeypatch):
    monkeypatch.setenv("RECONVAT_MAPS_ROOT", str(corpus / "MAPS"))
    monkeypatch.setenv("RECONVAT_MAESTRO_ROOT", str(corpus / "MAESTRO"))
    monkeypatch.setattr(distributed, "TIMEOUT", worker.TIMEOUT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return corpus


def _check_run(cli, model, root) -> str:
    """The run directory under root: rank 0's alone, its checkpoint
    holding `model`."""
    logdir = cli.ex.current_run.config["logdir"]
    assert os.listdir(root) == [os.path.basename(logdir)]
    names = sorted(os.listdir(logdir))
    assert len([n for n in names if n.startswith("events.out")]) == 1
    assert {"model-1", "result_dict", "MIDI_results"} <= set(names)
    saved = ckpt.load_state(os.path.join(logdir, "model-1"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    return logdir


def test_multi_inst_cli_trains_and_resumes_at_mesh_sp_2(sp_env):
    root = str(sp_env / "multi")
    model, state, metrics = multi_cli.ex.run(multi_cli.train, dict(
        ARGS, sequence_length=32 * 512, train_batch_size=2, iteration=2,
        root=root))
    assert state.step == 2 and metrics is not None
    logdir = _check_run(multi_cli, model, root)
    saved = ckpt.load_state(os.path.join(logdir, "model-1"))
    resumed, rstate, _ = multi_cli.ex.run(multi_cli.train, dict(
        ARGS, sequence_length=32 * 512, train_batch_size=2, epoches=0,
        resume_iteration="latest", trained_dir=logdir,
        root=str(sp_env / "multi_resumed")))
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    opt = rstate.optimizer.state_dict()["state"]
    for i, slots in saved["optimizer"]["state"].items():
        for name, v in slots.items():
            assert torch.equal(opt[i][name], v), (i, name)


def test_thickstun_cli_trains_at_mesh_sp_2(sp_env):
    root = str(sp_env / "thickstun")
    model, state, metrics = thickstun_cli.ex.run(thickstun_cli.train, dict(
        ARGS, sequence_length=20 * 512, root=root))
    assert state.step == 2 and metrics is not None
    _check_run(thickstun_cli, model, root)


@pytest.mark.parametrize("cli,frames", [(multi_cli, 24), (multi_cli, 40),
                                        (thickstun_cli, 21)],
                         ids=["multi_inst_24", "multi_inst_40",
                              "thickstun_21"])
def test_bad_frame_split_raises_before_any_work(tmp_path, cli, frames):
    """24 and 40 frames over 2 ranks (12 and 20 a rank) are not multiples
    of 16, Segmentation's time stride; 21 frames do not divide. 64 and 20
    frames resolve."""
    with pytest.raises(ValueError, match="mesh_sp=2"):
        cli.ex.run(cli.train, {"root": str(tmp_path), "device": "cpu",
                               "train_on": "nowhere", "mesh_sp": 2,
                               "sequence_length": frames * 512})
    assert os.listdir(tmp_path) == []
    cfg = {"spec": "Mel", "device": "cpu", "mesh_sp": 2, "batch_size": 2,
           "train_batch_size": 2}
    driver.check_settings(dict(cfg, sequence_length=64 * 512),
                          multi_cli.SemanticSegmentation)
    driver.check_settings(dict(cfg, sequence_length=20 * 512),
                          thickstun_cli.Thickstun)


@pytest.mark.parametrize("cli", [of_cli, prestack_cli],
                         ids=["onset_frame_VAT", "Prestack"])
def test_data_parallel_only_clis_refuse_mesh_sp(tmp_path, cli):
    with pytest.raises(NotImplementedError, match=DP_ONLY):
        cli.ex.run(cli.train, {"root": str(tmp_path), "device": "cpu",
                               "train_on": "nowhere", "mesh_sp": 2})
    assert os.listdir(tmp_path) == []


ATTENTION_MODELS = sorted(name for name, (module, _) in MODEL_REGISTRY.items()
                          if module.endswith(".attention_models"))


@pytest.mark.parametrize("name", ATTENTION_MODELS)
def test_attention_models_refuse_mesh_sp(name):
    model = get_model(name, device="cpu")
    with pytest.raises(NotImplementedError, match=DP_ONLY):
        driver.check_settings({"spec": "Mel", "device": "cpu", "mesh_sp": 2,
                               "sequence_length": 64 * 512}, type(model))
    ctx = pmesh.MeshContext(0, 2, torch.device("cpu"), sp=2)
    with pmesh.sharded_step(ctx), pytest.raises(NotImplementedError,
                                                match=DP_ONLY):
        model.make_spec(torch.zeros(1, 32 * 512))


@pytest.mark.parametrize("name,frames,ok", [
    ("Segmentation", 24, False), ("Segmentation", 64, True),
    ("Thickstun", 21, False), ("Thickstun", 20, True)])
def test_make_spec_checks_the_frame_multiple_under_a_mesh(name, frames, ok):
    """A library caller's step under a mesh (no CLI check before it):
    `make_spec` inside a sequence-parallel step raises ValueError for
    frames that do not split over mesh_sp=2 into multiples of the model's
    `SP_FRAME_MULTIPLE` (Segmentation's 16; Thickstun's 1), before any
    collective, and keeps this rank's half of the frames otherwise."""
    model = get_model(name, device="cpu")
    audio = torch.zeros(1, frames * 512)
    ctx = pmesh.MeshContext(1, 2, torch.device("cpu"), sp=2)
    with pmesh.sharded_step(ctx):
        if not ok:
            with pytest.raises(ValueError, match="mesh_sp=2"):
                model.make_spec(audio)
            return
        spec = model.make_spec(audio)
    assert spec.shape[1] == frames // 2
