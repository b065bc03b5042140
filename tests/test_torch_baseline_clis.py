"""The port's baseline training CLIs (`reconvat_tpu_torch.
train_baseline_onset_frame_VAT`, `train_baseline_Thickstun`,
`train_baseline_Prestack`, `train_baseline_Multi_Inst`) end to end on the
CPU, at full width, on a tiny
synthetic MAPS and MAESTRO corpus: 2 labeled songs of 1.2 s, one test
song of 0.6 s in each test group, 1 unlabeled song; Prestack, which runs
its U-Net and ResNet-18 once per frame, on 1 labeled song of 0.6 s and
test songs of 0.3 s.

Each run's first train step is held against the JAX package's
`run_on_batch` (train mode, no VAT) of the model the JAX CLI builds from
the same keys, on the same batch and the same initial weights (the port's
seeded init read by the JAX package's loader): every loss at rtol 1e-4
(atol 1e-7), the bound of tests/test_torch_train_cli.py. Dropout is off on
both sides for that (the port's `SharedDropout` and Flax's `Dropout` are
the identity in these tests). The VAT run (`model_name=frame VAT=True`)
holds its supervised loss so and its LDS loss positive. The final
evaluation's buckets are cut to 32 frames, Prestack's to 16
(`make_bucketed_runner`'s ladder), as the test songs are. The evaluation
CLI (`evaluate_cli`, the root CLI's `model_type=OnsetsAndFrames`) scores
the onset_frame run's `model-1`, equal (1e-12) to the port's evaluation
of those weights. `train_baseline_Multi_Inst` (Segmentation) runs one VAT
step; its resolved config is the JAX CLI's (its model is held against the
JAX package's in tests/test_torch_segmentation.py, in float64: its
train-mode step is too ill-conditioned at random init for an fp32 bound).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import flax.linen
import jax

import reconvat_tpu.models.onsets_frames as jof
import train_baseline_Multi_Inst as jax_multi_cli
from reconvat_tpu.data import audio_io as jaudio_io
from reconvat_tpu.models.prestack import Prestack as JaxPrestack
from reconvat_tpu.models.thickstun import Thickstun as JaxThickstun
from reconvat_tpu_torch import evaluate, evaluate_cli
from reconvat_tpu_torch import train_baseline_Multi_Inst as multi_cli
from reconvat_tpu_torch import train_baseline_onset_frame_VAT as of_cli
from reconvat_tpu_torch import train_baseline_Prestack as prestack_cli
from reconvat_tpu_torch import train_baseline_Thickstun as thickstun_cli
from reconvat_tpu_torch.data.datasets import MAPS
from reconvat_tpu_torch.models import get_model
from reconvat_tpu_torch.nn.layers import SharedDropout
from reconvat_tpu_torch.train import checkpoint as ckpt
from reconvat_tpu_torch.train import driver

from . import synth_data
from .torch_threads import torch_one_thread  # noqa: F401

LOSS_RTOL = 1e-4
ARGS = dict(device="cpu", train_on="MAPS", small=True, epoches=1,
            saving_freq=1, logging_freq=1)
# (CLI module, its overrides, the JAX model its CLI builds); Prestack runs
# on the short corpus
RUNS = {
    "onset_frame": (of_cli, dict(sequence_length=16 * 512, batch_size=2,
                                 train_batch_size=2, iteration=1),
                    lambda: jof.OnsetsAndFrames(xi=1e-6, eps=0.1)),
    "frame_vat": (of_cli, dict(sequence_length=16 * 512, batch_size=1,
                               train_batch_size=2, iteration=1,
                               model_name="frame", VAT=True),
                  lambda: jof.FrameStackVAT(xi=1e-6, eps=0.1)),
    "onset": (of_cli, dict(sequence_length=16 * 512, batch_size=2,
                           train_batch_size=2, iteration=1,
                           model_name="onset"),
              lambda: jof.OnsetStackVAT(xi=1e-6, eps=0.1)),
    "thickstun": (thickstun_cli, dict(sequence_length=16 * 512),
                  JaxThickstun),
    "prestack": (prestack_cli, dict(sequence_length=8 * 512), JaxPrestack),
}


def _song(path_wav, seconds, seed):
    """A short song whose notes lie inside it; returns its note rows."""
    rng = np.random.RandomState(seed)
    onsets = np.sort(rng.rand(3) * seconds * 0.5)
    rows = np.stack([onsets, onsets + 0.1 + rng.rand(3) * seconds * 0.4,
                     rng.randint(50, 80, 3), rng.randint(50, 110, 3)], 1)
    jaudio_io.write_wav(path_wav, synth_data.render_audio(rows, seconds),
                        16000)
    return rows


def _corpus(root, songs):
    """MAPS of `songs` [(group, seconds)] and MAESTRO of one song under
    root."""
    maps, maestro = root / "MAPS", root / "MAESTRO"
    for d in (maps / "flac", maps / "tsvs", maestro / "2004"):
        os.makedirs(d)
    for i, (group, seconds) in enumerate(songs):
        name = f"synth{i:02d}_{group}"
        rows = _song(str(maps / "flac" / f"{name}.wav"), seconds, i)
        synth_data.save_tsv(str(maps / "tsvs" / f"{name}.tsv"), rows)
    with open(maps / "overlapping.pkl", "wb") as f:
        pickle.dump(["__none__"], f)
    synth_data.make_maestro_like(str(maestro), n_files=1, duration_s=1.6)
    return root


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    return {
        "standard": _corpus(tmp_path_factory.mktemp("standard"), [
            ("AkPnBcht", 1.2), ("AkPnBcht", 1.2), ("ENSTDkAm", 0.6),
            ("ENSTDkCl", 0.6)]),
        "short": _corpus(tmp_path_factory.mktemp("short"), [
            ("AkPnBcht", 0.6), ("ENSTDkAm", 0.3), ("ENSTDkCl", 0.3)])}


def _run(name, corpora, monkeypatch):
    """(the port's first step: its batch, initial state_dict and losses;
    the run's logdir) of one CLI run, dropout off."""
    cli, overrides, _ = RUNS[name]
    corpus, ladder = ((corpora["short"], (16,)) if name == "prestack"
                      else (corpora["standard"], (32,)))
    monkeypatch.setenv("RECONVAT_MAPS_ROOT", str(corpus / "MAPS"))
    monkeypatch.setenv("RECONVAT_MAESTRO_ROOT", str(corpus / "MAESTRO"))
    first = {}

    def make_train_step(model, *args, **kw):
        step = make(model, *args, **kw)

        def run(state, batch_l, batch_ul, gen):
            if not first:
                first["state"] = {k: v.clone()
                                  for k, v in model.state_dict().items()}
                first["batch"] = {k: v.numpy() for k, v in batch_l.items()}
                first["losses"] = step(state, batch_l, batch_ul, gen)
                return first["losses"]
            return step(state, batch_l, batch_ul, gen)
        return run

    make = driver.make_train_step
    monkeypatch.setattr(driver, "make_train_step", make_train_step)
    real = evaluate.make_bucketed_runner
    monkeypatch.setattr(driver, "make_bucketed_runner",
                        lambda m: real(m, ladder))
    monkeypatch.setattr(SharedDropout, "forward", lambda self, x: x)
    cli.ex.run(cli.train, dict(ARGS, root=str(corpus / "runs" / name),
                               **overrides))
    return first, cli.ex.current_run.config["logdir"]


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_first_step_matches_jax(name, corpora, monkeypatch, tmp_path):
    first, logdir = _run(name, corpora, monkeypatch)
    assert {"config.json", "run.json", "model-1", "MIDI_results",
            "result_dict"} <= set(os.listdir(logdir))
    with open(os.path.join(logdir, "result_dict"), "rb") as f:
        result = pickle.load(f)
    assert any(k.startswith("metric/note/") for k in result)
    assert all(np.isfinite(v).all() for v in result.values())

    path = str(tmp_path / "init.pt")
    torch.save(first["state"], path)
    jmodel = RUNS[name][2]()
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=16)))
    variables = jmodel.load_reference_weights(path, template)
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **kw: x)
    ref = jax.jit(lambda v, b: jmodel.run_on_batch(
        v, b, None, jax.random.PRNGKey(0), vat=False, train=True)[1])(
        variables, first["batch"])
    got = first["losses"]
    assert set(got) == set(ref) | {"loss/total"}
    if name == "onset_frame":
        _evaluate_cli(logdir, tmp_path, monkeypatch)
    vat = name == "frame_vat"
    for k, v in ref.items():
        if vat and "LDS" in k:
            assert got[k].item() > 0, k
            continue
        np.testing.assert_allclose(got[k].item(), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


def _evaluate_cli(logdir, tmp_path, monkeypatch):
    """The evaluation CLI with the root CLI's model_type=OnsetsAndFrames on
    the run's model-1 (the buckets cut as in the run): its result_dict is
    the port's evaluation of those weights."""
    model_type = "OnsetsAndFrames"
    monkeypatch.setattr(evaluate, "make_bucketed_runner",
                        driver.make_bucketed_runner)
    evaluate_cli.ex.run(evaluate_cli.main, dict(
        device="cpu", model_type=model_type,
        weight_file=os.path.join(logdir, "model-1"),
        output_folder=str(tmp_path / "evaluated"), host_workers=0))
    result_dir = evaluate_cli.ex.current_run.config["logdir"]
    with open(os.path.join(result_dir, "result_dict_infer"), "rb") as f:
        result = pickle.load(f)
    model = get_model(model_type, device="cpu")
    model.load_reference_weights(ckpt.load_state(
        os.path.join(logdir, "model-1"))["model"])
    songs = MAPS(os.environ["RECONVAT_MAPS_ROOT"],
                 groups=["ENSTDkAm", "ENSTDkCl"], sequence_length=None,
                 verbose=False)
    mine = evaluate.evaluate_wo_velocity(
        songs, driver.make_bucketed_runner(model), reconstruction=False)
    assert list(result) == list(mine)
    for k in mine:
        np.testing.assert_allclose(result[k], mine[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_multi_inst_cli_runs(corpora, monkeypatch):
    """`train_baseline_Multi_Inst` with VAT (2 labeled + 1 unlabeled clips
    of 16 frames, one step): the JAX CLI's resolved config and run
    directory name, every artifact, the JAX package's loss keys with both
    LDS losses positive, finite metrics."""
    overrides = dict(ARGS, root=str(corpora["standard"] / "runs" / "multi"),
                     sequence_length=16 * 512, batch_size=1,
                     train_batch_size=2, iteration=1, VAT=True)
    got, ref = (c.ex._resolve({k: v for k, v in overrides.items()
                               if k != "device"})
                for c in (multi_cli, jax_multi_cli))
    assert (got.pop("device"), ref.pop("device")) == ("cuda", "tpu")
    assert got.pop("logdir")[:-13] == ref.pop("logdir")[:-13]
    assert got == ref
    monkeypatch.setenv("RECONVAT_MAPS_ROOT",
                       str(corpora["standard"] / "MAPS"))
    monkeypatch.setenv("RECONVAT_MAESTRO_ROOT",
                       str(corpora["standard"] / "MAESTRO"))
    real = evaluate.make_bucketed_runner
    monkeypatch.setattr(driver, "make_bucketed_runner",
                        lambda m: real(m, (32,)))
    steps = []
    make = driver.make_train_step

    def make_train_step(*args, **kw):
        step = make(*args, **kw)

        def run(*a):
            steps.append(step(*a))
            return steps[-1]
        return run

    monkeypatch.setattr(driver, "make_train_step", make_train_step)
    model, state, _ = multi_cli.ex.run(multi_cli.train, overrides)
    logdir = multi_cli.ex.current_run.config["logdir"]
    assert os.path.basename(logdir).startswith(
        "VAT_Segmentation=False-KL=False-XI=1e-06-eps=0.01-alpha=1-"
        "train_on=small_True_MAPS-w_size=31-n_heads=1-lr=0.001-")
    assert type(model).__name__ == "SemanticSegmentation"
    assert {"config.json", "run.json", "model-1", "MIDI_results",
            "result_dict"} <= set(os.listdir(logdir))
    assert len(steps) == state.step == 1
    assert set(steps[0]) == {
        "loss/train_frame", "loss/train_LDS_l", "loss/train_LDS_ul",
        "loss/train_r_norm_l", "loss/train_r_norm_ul", "loss/total"}
    assert steps[0]["loss/train_LDS_l"] > 0 < steps[0]["loss/train_LDS_ul"]
    with open(os.path.join(logdir, "result_dict"), "rb") as f:
        result = pickle.load(f)
    assert {k for k in result if k.startswith("loss/")} == {
        "loss/test_frame", "loss/test_LDS_l", "loss/test_r_norm_l"}
    assert all(np.isfinite(v).all() for v in result.values())


def test_clis_refuse_before_any_work(tmp_path, monkeypatch):
    """model_name other than the three raises before the run directory is
    written (as sequence parallelism, the CFP frontend and CUDA without a
    card do); the baselines' CLIs have no attn_impl or conv_layout, and
    check_settings reads them only where they are given."""
    with pytest.raises(ValueError, match="attention"):
        of_cli.ex.run(of_cli.train, {"root": str(tmp_path), "device": "cpu",
                                     "model_name": "attention"})
    with pytest.raises(NotImplementedError, match="item 3.3"):
        thickstun_cli.ex.run(thickstun_cli.train, {
            "root": str(tmp_path), "device": "cpu", "mesh_sp": 2})
    with pytest.raises(ValueError, match="T - 2"):
        prestack_cli.ex.run(prestack_cli.train, {
            "root": str(tmp_path), "device": "cpu", "spec": "CFP"})
    with pytest.raises(NotImplementedError, match="TPU"):
        multi_cli.ex.run(multi_cli.train, {
            "root": str(tmp_path), "device": "cpu",
            "conv_layout": "folded"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prestack_cli.ex.run(prestack_cli.train, {"root": str(tmp_path)})
    assert os.listdir(tmp_path) == []

    driver.check_settings({"spec": "Mel", "device": "cpu"})
    driver.check_settings({"spec": "CQT", "device": "cpu"})
    for extra, error in (({"attn_impl": "xla"}, ValueError),
                         ({"attn_impl": "other"}, ValueError),
                         ({"conv_layout": "folded"}, NotImplementedError),
                         ({"conv_layout": "other"}, ValueError)):
        with pytest.raises(error):
            driver.check_settings({"spec": "Mel", "device": "cpu", **extra})
