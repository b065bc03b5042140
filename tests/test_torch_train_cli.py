"""The port's training CLI (`reconvat_tpu_torch.train_UNet_VAT`) end to end
on the CPU, its checkpoints, and its full-song evaluation against the JAX
package's.

One run of the CLI at the flagship's full width on synthetic MAPS and
MAESTRO corpora (`tests/synth_data.py`): 32-frame crops, batch_size=2,
train_batch_size=1, iteration=2, epoches=2, saving_freq=2, logging_freq=2,
device=cpu, fp32; then a second run that resumes from the first's latest
checkpoint. The final weights, carried into the JAX package by
`torch_to_flax`, go through the JAX package's `make_bucketed_runner` and
`evaluate_wo_velocity` on the same test songs.

Tolerances:
- posteriograms of the two packages' bucketed runners: atol 1e-4 (the
  fp32 U-Net and the normalized log-spec, tests/test_torch_reconvat.py);
  losses rtol 1e-4.
- notes and metrics: equal (1e-12) once the pitches with a JAX
  posteriogram element within 1e-4 of the 0.5 threshold are set aside in
  both packages' predictions (the rule of `chip_smoke.py:same_notes`).
- checkpoints: bit-equal tensors; a step after a save and a restore into a
  fresh model equals the step taken straight on (fp32, the same CPU
  kernels on the same values).
- `batch_songs=2` against one song at a time: atol 1e-6 on posteriograms
  and rtol 1e-6 on losses (one forward over two rows in eval mode; only
  the convolutions' batch blocking differs).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from reconvat_tpu import decode as jdecode
from reconvat_tpu import evaluate as jevaluate
from reconvat_tpu.data.datasets import MAPS as JaxMAPS
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import decode, evaluate
from reconvat_tpu_torch import train_UNet_VAT as cli
from reconvat_tpu_torch.data.datasets import MAPS
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.train import checkpoint as ckpt
from reconvat_tpu_torch.train.state import (create_train_state,
                                            make_train_step)

from . import synth_data
from .torch_threads import torch_one_thread  # noqa: F401

POST_ATOL, LOSS_RTOL = 1e-4, 1e-4
TEST_GROUPS = ["ENSTDkAm", "ENSTDkCl"]
FRAMES = 32
CLI_ARGS = dict(device="cpu", train_on="MAPS", small=True,
                sequence_length=FRAMES * 512, batch_size=2,
                train_batch_size=1, iteration=2, epoches=2, saving_freq=2,
                logging_freq=2, compute_dtype=None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """MAPS (4 AkPnBcht songs for supersmall, one test song of 2 s and
    one of 3 s) and MAESTRO (2 songs) under a temporary root, named by
    the RECONVAT_*_ROOT variables."""
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
def run(corpus):
    """(first run's logdir, its model and state, the resumed run's model
    and state)."""
    model, state, _ = cli.ex.run(cli.train,
                                 dict(CLI_ARGS, root=str(corpus / "runs")))
    logdir = cli.ex.current_run.config["logdir"]
    resumed = cli.ex.run(cli.train, dict(
        CLI_ARGS, root=str(corpus / "resumed"), epoches=0,
        resume_iteration="latest", trained_dir=logdir))
    return logdir, model, state, resumed[0], resumed[1]


def test_cli_writes_every_artifact_and_resumes(run):
    logdir, model, state, resumed, resumed_state = run
    names = set(os.listdir(logdir))
    assert {"config.json", "run.json", "_sources", "model-2",
            "MIDI_results", "result_dict"} <= names
    assert any(n.startswith("events.out.tfevents.") for n in names)
    assert os.listdir(os.path.join(logdir, "_sources")) == [
        "train_UNet_VAT.py"]
    assert sorted(os.listdir(os.path.join(logdir, "MIDI_results"))) == \
        sorted(f"synth00_{g}.wav.{kind}" for g in TEST_GROUPS
               for kind in ("label.png", "pred.png", "pred.mid"))
    assert state.step == 4 and resumed_state.step == 4
    saved = ckpt.load_state(ckpt.latest_checkpoint(logdir))
    assert saved["step"] == 4
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
        assert torch.equal(v, model.state_dict()[k]), k
    got_opt = resumed_state.optimizer.state_dict()["state"]
    for i, slots in saved["optimizer"]["state"].items():
        for name, v in slots.items():
            assert torch.equal(got_opt[i][name].cpu(), v), (i, name)
    assert resumed_state.scheduler.state_dict() == saved["scheduler"]


@pytest.fixture(scope="module")
def jax_side(run):
    """The JAX model and the first run's final weights as its variables."""
    _, model, _, _, _ = run
    jmodel = JaxReconVAT(conv_layout="nhwc", reconstruction=False)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=FRAMES)))
    variables, report = torch_to_flax(model.state_dict(), template)
    assert report["skipped"] == []
    return jmodel, variables


def _test_songs(cls, corpus):
    return cls(str(corpus / "MAPS"), groups=TEST_GROUPS,
               sequence_length=None, verbose=False)


def _rolls(runner, songs):
    """(posteriogram (T, 88), losses) of each song."""
    out = []
    for item in songs:
        p, losses, _ = runner(item)
        frame = p["frame"]
        frame = frame.numpy() if torch.is_tensor(frame) else np.asarray(frame)
        out.append((frame[0], {k: float(v) for k, v in losses.items()}))
    return out


def _once(runner):
    """runner with each song's outputs kept: each package runs a song's
    forward once however often the test reads it."""
    memo = {}

    def run(item):
        if item["path"] not in memo:
            memo[item["path"]] = runner(item)
        return memo[item["path"]]
    return run


def _masked(runner, near, to_array):
    """runner with the posteriogram's `near` pitches set to 0."""
    def run(item):
        p, losses, spec = runner(item)
        keep = to_array(np.where(near, 0.0, 1.0).astype(np.float32))
        return ({k: (v * keep if k in ("frame", "onset") else v)
                 for k, v in p.items()}, losses, spec)
    return run


def test_result_dict_matches_jax_evaluation(run, jax_side, corpus):
    """The port's result_dict against the JAX package's evaluation of the
    same final weights on the same test songs: posteriograms and losses
    within tolerance, and notes and metrics equal outside the pitches near
    the threshold; the keys are those of the JAX package's
    `run_training`."""
    logdir, model, _, _, _ = run
    jmodel, variables = jax_side
    with open(os.path.join(logdir, "result_dict"), "rb") as f:
        result = pickle.load(f)
    port_runner = _once(evaluate.make_bucketed_runner(model))
    jax_runner = _once(jevaluate.make_bucketed_runner(jmodel, variables))
    songs, jsongs = _test_songs(MAPS, corpus), _test_songs(JaxMAPS, corpus)
    got, ref = _rolls(port_runner, songs), _rolls(jax_runner, jsongs)
    near = np.zeros(88, bool)
    for (a, la), (b, lb) in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=POST_ATOL)
        assert la.keys() == lb.keys()
        for k in lb:
            np.testing.assert_allclose(la[k], lb[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
        near |= (np.abs(b - 0.5) < POST_ATOL).any(axis=0)
    assert near.sum() < 44, "most pitches sit on the threshold"

    # the notes of both packages' decoders, outside the pitches near 0.5
    n_notes = 0
    for (a, _), (b, _) in zip(got, ref):
        notes = [dec(np.where(near, 0.0, roll), np.where(near, 0.0, roll),
                     rule="rule2")
                 for dec, roll in ((decode.extract_notes_wo_velocity, a),
                                   (jdecode.extract_notes_wo_velocity, b))]
        for x, y in zip(*notes):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        n_notes += len(notes[0][0])
    assert n_notes > 0

    # the result_dict is the port's evaluation of these songs
    mine = evaluate.evaluate_wo_velocity(songs, port_runner,
                                         reconstruction=False)
    assert list(result) == list(mine)
    for k in mine:
        np.testing.assert_allclose(result[k], mine[k], rtol=0, atol=1e-12)

    to_t = torch.from_numpy
    port_m = evaluate.evaluate_wo_velocity(
        songs, _masked(port_runner, near, to_t), reconstruction=False)
    jax_m = jevaluate.evaluate_wo_velocity(
        jsongs, _masked(jax_runner, near, np.asarray), reconstruction=False)
    # the JAX package's result_dict holds what its evaluate_wo_velocity
    # returns: the same keys (its losses come back from a jit, sorted)
    assert set(result) == set(port_m) == set(jax_m)
    for k in jax_m:
        if k.startswith("metric/"):
            np.testing.assert_allclose(port_m[k], jax_m[k], rtol=0,
                                       atol=1e-12, err_msg=k)


def test_bucketed_runner_matches_jax(run, jax_side, corpus):
    """make_bucketed_runner at buckets=(256,) on the two test songs (63
    and 94 frames) against the JAX package's; batch_songs=2 (one forward
    over both, each masked by its own length) equals one song at a
    time."""
    _, model, _, _, _ = run
    jmodel, variables = jax_side
    songs, jsongs = _test_songs(MAPS, corpus), _test_songs(JaxMAPS, corpus)
    port_runner = evaluate.make_bucketed_runner(model, buckets=(256,))
    got = _rolls(port_runner, songs)
    ref = _rolls(jevaluate.make_bucketed_runner(jmodel, variables,
                                                buckets=(256,)), jsongs)
    assert [len(a) for a, _ in got] == [63, 94]
    for (a, la), (b, lb) in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=POST_ATOL)
        for k in lb:
            np.testing.assert_allclose(la[k], lb[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
    group = port_runner.run_group(list(songs), 2)
    for (p, losses, spec), (a, la) in zip(group, got):
        assert spec.shape[1] == len(a)
        np.testing.assert_allclose(p["frame"][0].numpy(), a, rtol=0,
                                   atol=1e-6)
        for k, v in losses.items():
            np.testing.assert_allclose(float(v), la[k], rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    one = evaluate.evaluate_wo_velocity(songs, port_runner,
                                        reconstruction=False)
    two = evaluate.evaluate_wo_velocity(songs, port_runner,
                                        reconstruction=False, batch_songs=2)
    assert list(one) == list(two)


def test_checkpoint_round_trip_and_resumed_step(tmp_path):
    """save -> latest_checkpoint -> restore gives bit-equal tensors; two
    steps straight equal one step, a save and a restore into a fresh
    model and state, then one step."""
    rng = np.random.RandomState(0)
    batch = {"audio": torch.from_numpy(
                 (rng.randn(1, FRAMES * 512) * 0.1).astype(np.float32)),
             "frame": torch.from_numpy(
                 (rng.rand(1, FRAMES, 88) < 0.05).astype(np.float32))}

    def fresh(seed):
        model = ReconVAT(device="cpu", reconstruction=False, seed=seed)
        return model, create_train_state(model, decay_steps=1)

    def step(model, state):
        make_train_step(model, 1.0, vat=False, use_unlabeled=False)(
            state, batch, batch, None)

    straight, s_state = fresh(0)
    step(straight, s_state)
    step(straight, s_state)

    model, state = fresh(0)
    step(model, state)
    path = ckpt.save_checkpoint(str(tmp_path), state.step, model, state)
    ckpt.save_checkpoint(str(tmp_path), 0, model, state)
    ckpt.wait_for_checkpoints()
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    assert sorted(os.listdir(tmp_path)) == ["model-0", "model-1"]
    restored, r_state = fresh(1)
    ckpt.restore_checkpoint(path, restored, r_state)
    for k, v in model.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k
    assert r_state.step == 1
    step(restored, r_state)
    for k, v in straight.state_dict().items():
        assert torch.equal(restored.state_dict()[k], v), k
    assert r_state.scheduler.get_last_lr() == s_state.scheduler.get_last_lr()
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore_checkpoint(str(tmp_path), restored, r_state)


@pytest.mark.parametrize("override,error,match", [
    ({"mesh_sp": 2}, NotImplementedError, "item 3.3"),
    ({"multihost": True}, ValueError, "launcher"),
    ({"conv_layout": "folded"}, NotImplementedError, "folded"),
    ({"attn_impl": "xla"}, ValueError, "plain attention"),
    ({}, RuntimeError, "no CUDA device"),
])
def test_cli_refuses_before_any_work(tmp_path, override, error, match):
    """Sequence parallelism, multihost without a launcher, the TPU-only
    settings and, without a card, the default device raise
    before a dataset or a model is built (the root names no corpus) and
    before the run directory is written."""
    args = {"root": str(tmp_path), "train_on": "nowhere", **override}
    if override:
        args["device"] = "cpu"
    with pytest.raises(error, match=match):
        cli.ex.run(cli.train, args)
    assert os.listdir(tmp_path) == []
