"""The port's UNet_Onset training CLI (`reconvat_tpu_torch.
train_UNet_Onset_VAT`) and evaluation CLI (`reconvat_tpu_torch.
evaluate_cli`) end to end on the CPU, and the evaluation against the JAX
package's on the same weights.

One run of the training CLI at full width on synthetic MAPS and MAESTRO
corpora (`tests/synth_data.py`): 32-frame crops, batch_size=2,
train_batch_size=2, iteration=2, epoches=2, saving_freq=2,
logging_freq=2, device=cpu, fp32. The evaluation CLI then reads its
`model-2` checkpoint; the same weights, carried into the JAX package by
`torch_to_flax`, go through the JAX package's `make_bucketed_runner` and
`evaluate_wo_velocity` on the same test songs.

Tolerances (those of tests/test_torch_train_cli.py):
- onset and frame posteriograms: atol 1e-4; losses rtol 1e-4.
- metrics: equal (1e-12) once the pitches with a JAX posteriogram element
  (onset or frame) within 1e-4 of the 0.5 threshold are set aside in both
  packages' predictions; but `micro_avg_P`, the average precision of the
  continuous frame posteriogram, within 1e-4: it ranks every element, and
  two elements less than 2e-4 apart may rank the other way in the other
  package (1.5e-6 apart on these songs).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from reconvat_tpu import evaluate as jevaluate
from reconvat_tpu.data.datasets import MAPS as JaxMAPS
from reconvat_tpu.models.unet_onset import UNetOnset as JaxUNetOnset
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import evaluate, evaluate_cli
from reconvat_tpu_torch import train_UNet_Onset_VAT as cli
from reconvat_tpu_torch.data.datasets import MAPS
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.models.segmentation import SemanticSegmentation

from . import synth_data
from .torch_threads import torch_one_thread  # noqa: F401

POST_ATOL, LOSS_RTOL = 1e-4, 1e-4
TEST_GROUPS = ["ENSTDkAm", "ENSTDkCl"]
FRAMES = 32
CLI_ARGS = dict(device="cpu", train_on="MAPS", small=True,
                sequence_length=FRAMES * 512, batch_size=2,
                train_batch_size=2, iteration=2, epoches=2, saving_freq=2,
                logging_freq=2, compute_dtype=None)
# the keys of the JAX package's result_dict of UNet_Onset
# (reconstruction=False: eval-mode run_on_batch losses, then the metrics)
LOSS_KEYS = {"loss/test_frame", "loss/test_onset", "loss/test_LDS_l_frame",
             "loss/test_LDS_l_onset", "loss/test_r_norm_l"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """MAPS (4 AkPnBcht songs, one test song of 2 s and one of 3 s) and
    MAESTRO (2 songs) under a temporary root, named by the
    RECONVAT_*_ROOT variables."""
    root = tmp_path_factory.mktemp("corpora")
    maps = str(root / "MAPS")
    synth_data.make_maps_like(maps, groups=("AkPnBcht",), files_per_group=4,
                              duration_s=3.0)
    for i, (group, seconds) in enumerate(zip(TEST_GROUPS, (2.0, 3.0))):
        synth_data.make_maps_like(maps, groups=(group,), duration_s=seconds,
                                  seed=50 + i)
    synth_data.make_maestro_like(str(root / "MAESTRO"), n_files=2,
                                 duration_s=3.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RECONVAT_MAPS_ROOT", maps)
        mp.setenv("RECONVAT_MAESTRO_ROOT", str(root / "MAESTRO"))
        yield root


@pytest.fixture(scope="module")
def trained(corpus):
    """(the training run's logdir, its model, its train state)."""
    model, state, _ = cli.ex.run(cli.train,
                                 dict(CLI_ARGS, root=str(corpus / "runs")))
    return cli.ex.current_run.config["logdir"], model, state


def _songs(cls, corpus):
    return cls(str(corpus / "MAPS"), groups=TEST_GROUPS,
               sequence_length=None, verbose=False)


def test_training_cli_writes_every_artifact(trained):
    logdir, model, state = trained
    assert os.path.basename(logdir).startswith(
        "Unet_Onset-recons=False-XI=1e-06-eps=2-alpha=1-train_on="
        "small_True_MAPS-w_size=31-n_heads=4-lr=0.001-")
    names = set(os.listdir(logdir))
    assert {"config.json", "run.json", "_sources", "model-2",
            "MIDI_results", "result_dict"} <= names
    assert any(n.startswith("events.out.tfevents.") for n in names)
    assert os.listdir(os.path.join(logdir, "_sources")) == [
        "train_UNet_Onset_VAT.py"]
    assert sorted(os.listdir(os.path.join(logdir, "MIDI_results"))) == \
        sorted(f"synth00_{g}.wav.{kind}" for g in TEST_GROUPS
               for kind in ("label.png", "pred.png", "pred.mid"))
    assert state.step == 4
    with open(os.path.join(logdir, "result_dict"), "rb") as f:
        result = pickle.load(f)
    assert LOSS_KEYS <= set(result)
    assert all(np.isfinite(v).all() for v in result.values())


def _once(runner):
    memo = {}

    def run(item):
        if item["path"] not in memo:
            memo[item["path"]] = runner(item)
        return memo[item["path"]]
    return run


def _masked(runner, near, to_array):
    """runner with the `near` pitches of both rolls set to 0."""
    def run(item):
        p, losses, spec = runner(item)
        keep = to_array(np.where(near, 0.0, 1.0).astype(np.float32))
        return ({k: (v * keep if k in ("frame", "onset") else v)
                 for k, v in p.items()}, losses, spec)
    return run


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_evaluate_cli_matches_jax_evaluation(trained, corpus):
    """The evaluation CLI on the training run's model-2: its result_dict is
    the port's evaluation of those weights; onset and frame posteriograms
    and losses match the JAX package's bucketed runner, and the metrics
    match its evaluate_wo_velocity outside the pitches near 0.5."""
    logdir, model, _ = trained
    out = str(corpus / "evaluated")
    means = evaluate_cli.ex.run(evaluate_cli.main, dict(
        device="cpu", model_type="UNet_Onset",
        weight_file=os.path.join(logdir, "model-2"), output_folder=out,
        host_workers=0))
    result_dir = evaluate_cli.ex.current_run.config["logdir"]
    assert sorted(os.listdir(result_dir)) == ["MIDI_results-infer",
                                              "result_dict_infer"]
    with open(os.path.join(result_dir, "result_dict_infer"), "rb") as f:
        result = pickle.load(f)
    assert means == {k: float(np.mean(v)) for k, v in result.items()
                     if k.startswith("metric/")}

    songs, jsongs = _songs(MAPS, corpus), _songs(JaxMAPS, corpus)
    port_runner = _once(evaluate.make_bucketed_runner(model))
    mine = evaluate.evaluate_wo_velocity(songs, port_runner,
                                         reconstruction=False)
    assert list(result) == list(mine)
    for k in mine:
        np.testing.assert_allclose(result[k], mine[k], rtol=0, atol=1e-12)

    jmodel = JaxUNetOnset(conv_layout="nhwc", reconstruction=False)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=FRAMES)))
    variables, report = torch_to_flax(model.state_dict(), template)
    assert report["skipped"] == []
    jax_runner = _once(jevaluate.make_bucketed_runner(jmodel, variables))
    near = np.zeros(88, bool)
    n_onsets = 0
    for item, jitem in zip(songs, jsongs):
        (p, la, _), (q, lb, _) = port_runner(item), jax_runner(jitem)
        for k in ("onset", "frame"):
            a, b = _np(p[k])[0], _np(q[k])[0]
            np.testing.assert_allclose(a, b, rtol=0, atol=POST_ATOL,
                                       err_msg=k)
            near |= (np.abs(b - 0.5) < POST_ATOL).any(axis=0)
        n_onsets += int((_np(q["onset"]) > 0.5).sum())
        assert set(la) == set(lb) == LOSS_KEYS
        for k in lb:
            np.testing.assert_allclose(float(la[k]), float(lb[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert near.sum() < 44, "most pitches sit on the threshold"
    assert n_onsets > 0, "no onset above the threshold: no note to compare"

    port_m = evaluate.evaluate_wo_velocity(
        songs, _masked(port_runner, near, torch.from_numpy),
        reconstruction=False)
    jax_m = jevaluate.evaluate_wo_velocity(
        jsongs, _masked(jax_runner, near, np.asarray), reconstruction=False)
    assert set(result) == set(port_m) == set(jax_m)
    for k in jax_m:
        if k.startswith("metric/"):
            np.testing.assert_allclose(
                port_m[k], jax_m[k], rtol=0, err_msg=k,
                atol=POST_ATOL if k.endswith("micro_avg_P") else 1e-12)


def test_evaluate_cli_reconvat_from_pt(corpus, tmp_path):
    """model_type=ReconVAT from a `.pt` of the reference's names, without
    onset inference: result_dict_no_infer holds the evaluation of those
    weights."""
    model = ReconVAT(device="cpu", reconstruction=False, seed=3)
    path = str(tmp_path / "weight.pt")
    torch.save(model.state_dict(), path)
    evaluate_cli.ex.run(evaluate_cli.main, dict(
        device="cpu", weight_file=path, output_folder=str(tmp_path / "out"),
        inference=False, batch_songs=2))
    result_dir = evaluate_cli.ex.current_run.config["logdir"]
    with open(os.path.join(result_dir, "result_dict_no_infer"), "rb") as f:
        result = pickle.load(f)
    mine = evaluate.evaluate_wo_velocity(
        _songs(MAPS, corpus), evaluate.make_bucketed_runner(model),
        reconstruction=False, onset=False)
    assert list(result) == list(mine)
    for k in mine:
        np.testing.assert_allclose(result[k], mine[k], rtol=0, atol=1e-12)


def test_evaluate_cli_segmentation_from_pt(corpus, tmp_path):
    """model_type=Segmentation (the root CLI's name) from a `.pt` of the
    reference's names: result_dict_infer holds the JAX package's keys and
    the port's evaluation of those weights (two songs in one forward in
    the CLI, one by one here)."""
    model = SemanticSegmentation(device="cpu", seed=3)
    path = str(tmp_path / "weight.pt")
    torch.save(model.state_dict(), path)
    evaluate_cli.ex.run(evaluate_cli.main, dict(
        device="cpu", model_type="Segmentation", weight_file=path,
        output_folder=str(tmp_path / "out"), batch_songs=2))
    result_dir = evaluate_cli.ex.current_run.config["logdir"]
    with open(os.path.join(result_dir, "result_dict_infer"), "rb") as f:
        result = pickle.load(f)
    mine = evaluate.evaluate_wo_velocity(
        _songs(MAPS, corpus), evaluate.make_bucketed_runner(model),
        reconstruction=False)
    assert {k for k in result if k.startswith("loss/")} == {
        "loss/test_frame", "loss/test_LDS_l", "loss/test_r_norm_l"}
    assert list(result) == list(mine)
    for k in mine:
        np.testing.assert_allclose(result[k], mine[k], rtol=0, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("override,error,match", [
    ({"model_type": "Segmentation", "spec": "CFP"}, ValueError, "T - 2"),
    ({"model_type": "VATSelfAttention1D", "spec": "CFP"}, ValueError,
     "T - 2"),
    ({"spec": "STFT"}, ValueError, "unknown spectrogram"),
    ({"weight_file": "orbax"}, ValueError, "orbax"),
    ({}, RuntimeError, "no CUDA device"),
    ({"model_type": "NoSuchModel"}, KeyError, "unknown model"),
    ({"model_type": "Reconstructor"}, ValueError, "transcribes nothing"),
])
def test_evaluate_cli_refuses_before_any_work(monkeypatch, tmp_path,
                                              override, error, match):
    """CFP (its spec has T - 2 frames for labels of T, for any model), an
    unknown frontend, a name not in the registry, the Reconstructor
    (nothing to evaluate), an orbax directory, and CUDA without a card
    raise before a dataset is read or a file written."""
    monkeypatch.setenv("RECONVAT_MAPS_ROOT", str(tmp_path / "nowhere"))
    out = tmp_path / "out"
    args = {"output_folder": str(out), "device": "cpu", **override}
    if override.get("weight_file") == "orbax":
        (tmp_path / "orbax").mkdir()
        args["weight_file"] = str(tmp_path / "orbax")
    if not override:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        del args["device"]
    with pytest.raises(error, match=match):
        evaluate_cli.ex.run(evaluate_cli.main, args)
    assert not out.exists()
    assert not (tmp_path / "nowhere").exists()
