"""The port's training data path and host-side evaluation against the JAX
package, on the CPU: metrics, label rolls, MIDI parsing, the four training
corpora, the loader, evaluation of given predictions, the piano-roll PNG,
the TensorBoard event file and the loop's deferred loss readback.

Tolerances:
- metrics (note P/R/F1/overlap with and without offsets, multipitch
  scores, average precision): 1e-12 absolute; both sides are float64
  numpy on the same numbers (the JAX package's average precision is
  scikit-learn's, the port's a numpy copy of its algorithm).
- label rolls, parsed MIDI, dataset files and crops, loader batches: equal
  to the bit (the same integer and float64 arithmetic on the same files).
- `evaluate_wo_velocity` fed the same predictions: metric dicts within
  1e-12, MIDI files byte-equal.
- the piano-roll PNG: the pixels Pillow decodes, equal.
- the event file's scalars: equal to the float32 the loggers receive.
"""
import os
import pickle
import types

import numpy as np
import pytest
import torch

from reconvat_tpu import evaluate as jevaluate
from reconvat_tpu import metrics as jmetrics
from reconvat_tpu.data import datasets as jdatasets
from reconvat_tpu.data import labels as jlabels
from reconvat_tpu.data import loader as jloader
from reconvat_tpu.data import midi_io as jmidi
from reconvat_tpu.train import loop as jloop
from reconvat_tpu.utils import save_pianoroll as jsave_pianoroll
from reconvat_tpu_torch import evaluate, metrics, utils
from reconvat_tpu_torch.data import datasets, labels, loader, midi_io
from reconvat_tpu_torch.train import loop

from . import flac_encoder, synth_data
from .torch_threads import torch_one_thread  # noqa: F401


def _notes(rng, n, t_max=20.0):
    on = np.sort(rng.rand(n) * t_max)
    iv = np.stack([on, on + 0.05 + rng.rand(n) * 1.5], axis=1)
    return iv, 440.0 * 2 ** ((rng.randint(30, 90, n) - 69) / 12.0)


def test_metrics_match_jax():
    """Note metrics (ref notes jittered into est, plus misses and extras),
    multipitch scores of two rolls and average precision with tied
    scores."""
    rng = np.random.RandomState(0)
    for trial in range(4):
        ref_iv, ref_p = _notes(rng, 40 + trial)
        keep = rng.rand(len(ref_p)) < 0.8
        est_iv = ref_iv[keep] + rng.randn(keep.sum(), 2) * 0.03
        est_p = ref_p[keep] * 2 ** (rng.randn(keep.sum()) * 0.02)
        extra_iv, extra_p = _notes(rng, 5)
        est_iv = np.concatenate([est_iv, extra_iv])
        est_p = np.concatenate([est_p, extra_p])
        for ratio in (None, 0.2):
            got = metrics.precision_recall_f1_overlap(
                ref_iv, ref_p, est_iv, est_p, offset_ratio=ratio)
            ref = jmetrics.precision_recall_f1_overlap(
                ref_iv, ref_p, est_iv, est_p, offset_ratio=ratio)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        roll_ref = rng.rand(300, 88) < 0.05
        roll_est = roll_ref ^ (rng.rand(300, 88) < 0.02)
        got = metrics.evaluate_multipitch_rolls(roll_ref, roll_est, 21)
        ref = jmetrics.evaluate_multipitch_rolls(roll_ref, roll_est, 21)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12)
        score = np.round(rng.rand(300 * 88), 2 + trial % 2)
        truth = roll_ref.ravel().astype(float)
        assert abs(metrics.average_precision_score(truth, score)
                   - jmetrics.average_precision_score(truth, score)) < 1e-12


def test_labels_and_parse_midi_match_jax(tmp_path):
    """tsv_to_rolls, label_to_masks and the tsv round trip; parse_midi of
    a written file and of one with a sustain pedal and a tempo change."""
    rows = synth_data.synth_notes(6.0, seed=3, n_notes=20)
    rows[0, 2] = 10                    # out of the 88 keys: skipped
    for n in (6 * 16000, 6 * 16000 + 100):
        got, ref = labels.tsv_to_rolls(rows, n), jlabels.tsv_to_rolls(rows, n)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(labels.label_to_masks(got[0]),
                        jlabels.label_to_masks(ref[0])):
            np.testing.assert_array_equal(a, b)
    labels.save_tsv(str(tmp_path / "a.tsv"), rows)
    np.testing.assert_array_equal(labels.load_tsv(str(tmp_path / "a.tsv")),
                                  jlabels.load_tsv(str(tmp_path / "a.tsv")))

    path = str(tmp_path / "a.mid")
    midi_io.save_midi(path, midi_io.midi_to_hz(rows[1:, 2]), rows[1:, :2],
                      rows[1:, 3] / 127.0)
    pedal = str(tmp_path / "b.mid")
    jmidi.write_midi_events(pedal, [[
        (0, [0xFF, 0x51, 3, 0x07, 0xA1, 0x20]),   # 500000 us per beat
        (0, [0x90, 60, 90]), (240, [0xB0, 64, 127]), (480, [0x80, 60, 0]),
        (600, [0xFF, 0x51, 3, 0x0F, 0x42, 0x40]),  # tempo halves
        (700, [0x90, 64, 70]), (900, [0x90, 64, 0]),
        (1200, [0xB0, 64, 0]), (1300, [0x90, 67, 50]),
        (1500, [0x80, 67, 0])]], 480)
    for p in (path, pedal):
        np.testing.assert_array_equal(midi_io.parse_midi(p),
                                      jmidi.parse_midi(p))


def _write_clip(path, rows, duration):
    audio = synth_data.render_audio(rows, duration)
    if path.endswith(".flac"):
        with open(path, "wb") as f:
            f.write(flac_encoder.encode_flac(audio, 16000))
    else:
        from reconvat_tpu.data.audio_io import write_wav

        write_wav(path, audio, 16000)


def _musicnet(root):
    for d in ("train_data", "tsv_train_labels", "test_data",
              "tsv_test_labels"):
        os.makedirs(os.path.join(root, d))
    meta = [(1301, "Wind Quintet"), (1302, "Wind Quintet"),
            (1401, "Clarinet Quintet"), (1101, "String Quartet")]
    with open(os.path.join(root, "train_metadata.csv"), "w") as f:
        f.write("id,ensemble\n" + "".join(f"{i},{e}\n" for i, e in meta))
    with open(os.path.join(root, "test_metadata.csv"), "w") as f:
        f.write("id,ensemble\n1819,Wind Quintet\n")
    for mode, ids in (("train", [i for i, _ in meta]), ("test", [1819])):
        for i in ids:
            rows = synth_data.synth_notes(2.0, seed=i, n_notes=4)
            _write_clip(os.path.join(root, f"{mode}_data", f"{i}.wav"),
                        rows, 2.0)
            labels.save_tsv(os.path.join(root, f"tsv_{mode}_labels",
                                         f"{i}.tsv"), rows)
    return [["train_wind_l"], ["train_wind_ul"], ["test_wind"]]


def _guqin(root):
    os.makedirs(os.path.join(root, "audio"))
    os.makedirs(os.path.join(root, "tsv_label"))
    for i, song in enumerate(["jiou", "siang", "gu"]):
        rows = synth_data.synth_notes(2.0, seed=i, n_notes=4)
        _write_clip(os.path.join(root, "audio", song + ".flac"), rows, 2.0)
        labels.save_tsv(os.path.join(root, "tsv_label", song + ".tsv"),
                        rows)
    return [["train_l"], ["test"]]


def _corpus(name, root):
    """(class name, constructor kwargs per split) of a synthetic corpus."""
    if name == "MAPS":
        synth_data.make_maps_like(root, groups=("AkPnBcht", "ENSTDkAm"),
                                  files_per_group=4, duration_s=2.0)
        return [dict(groups=["AkPnBcht"], overlap=False, supersmall=True),
                dict(groups=["AkPnBcht"], overlap=False),
                dict(groups=["ENSTDkAm"], overlap=True)]
    if name == "MAESTRO":
        synth_data.make_maestro_like(root, n_files=3, duration_s=2.0)
        return [dict(groups=["train"]), dict(groups=["2004"])]
    return [dict(groups=g) for g in (_musicnet(root) if name == "MusicNet"
                                     else _guqin(root))]


@pytest.mark.parametrize("name", ["MAPS", "MAESTRO", "MusicNet", "Guqin"])
def test_datasets_match_jax(name, tmp_path, monkeypatch):
    """Each split's files, whole items and seeded crops (three draws per
    item), the port against the JAX package on the same files; the port
    reads the cache the JAX package wrote and writes the same one."""
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / name)
    os.makedirs(root)
    for kw in _corpus(name, root):
        for seq in (None, 16 * 512):
            ref = getattr(jdatasets, name)(root, sequence_length=seq,
                                           verbose=False, **kw)
            got = getattr(datasets, name)(root, sequence_length=seq,
                                          verbose=False, refresh=True, **kw)
            assert len(got) > 0 and len(got) == len(ref)
            assert [d["path"] for d in got.data] == \
                [d["path"] for d in ref.data]
            for _ in range(3 if seq else 1):
                for i in range(len(ref)):
                    a, b = got[i], ref[i]
                    assert list(a) == list(b)
                    for k in b:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loader_matches_jax(tmp_path):
    """Batch order and contents of the threaded loader for one seed, over
    three epochs, shuffled with drop_last and in order; `cycle` and the
    CPU path of `prefetch_to_device` pass them on unchanged."""
    root = str(tmp_path)
    synth_data.make_maps_like(root, groups=("AkPnBcht",), files_per_group=5,
                              duration_s=2.0)
    kw = dict(groups=["AkPnBcht"], sequence_length=16 * 512, verbose=False)
    got_set = datasets.MAPS(root, **kw)
    ref_set = jdatasets.MAPS(root, **kw)
    for shuffle, drop_last in ((True, True), (False, False)):
        got = loader.DataLoader(got_set, 2, shuffle=shuffle,
                                drop_last=drop_last, seed=7)
        ref = jloader.DataLoader(ref_set, 2, shuffle=shuffle,
                                 drop_last=drop_last, seed=7)
        assert len(got) == len(ref)
        cycled = loader.prefetch_to_device(loader.cycle(got), "cpu")
        ref_batches = [b for _ in range(3) for b in ref]
        for b in ref_batches:
            a = next(cycled)
            assert list(a) == list(b)
            for k in b:
                if k in loader.BATCH_KEYS:
                    assert a[k].dtype == torch.from_numpy(b[k]).dtype
                    np.testing.assert_array_equal(a[k].numpy(), b[k])
                else:
                    assert a[k] == b[k]
    with pytest.raises(ValueError, match="0 batches"):
        next(loader.cycle(loader.DataLoader(got_set, 6, drop_last=True)))


def test_evaluate_wo_velocity_matches_jax(tmp_path):
    """The same posteriograms and losses through both packages'
    `evaluate_wo_velocity` (pipeline, a thread pool, the artifacts)."""
    rng = np.random.RandomState(1)
    songs, preds = [], []
    for i, t in enumerate((120, 200, 77)):
        rows = synth_data.synth_notes(t / 31.25, seed=i, n_notes=15)
        label, _ = labels.tsv_to_rolls(rows, t * 512 - 1)
        onset, offset, frame = labels.label_to_masks(label)
        songs.append({"path": f"song{i}.wav", "onset": onset,
                      "offset": offset, "frame": frame})
        roll = np.clip(frame * 0.7 + rng.rand(*frame.shape) * 0.45, 0, 1)
        preds.append((roll.astype(np.float32)[None],
                       {"loss/test_frame": np.float32(rng.rand())}))
    by_path = {s["path"]: p for s, p in zip(songs, preds)}

    def runner(to):
        def run(item):
            roll, losses = by_path[item["path"]]
            p = {"frame": to(roll), "onset": to(roll)}
            return p, {k: to(v) for k, v in losses.items()}, None
        return run

    for workers in (0, 2):
        got = evaluate.evaluate_wo_velocity(
            songs, runner(lambda a: torch.as_tensor(np.asarray(a))),
            reconstruction=False,
            host_workers=workers, save_path=str(tmp_path / "port"))
        ref = jevaluate.evaluate_wo_velocity(
            songs, runner(np.asarray), reconstruction=False,
            host_workers=workers, save_path=str(tmp_path / "jax"))
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    for name in sorted(os.listdir(tmp_path / "jax")):
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        if name.endswith(".mid"):
            assert a == b, name


def test_pianoroll_png_matches_pillow(tmp_path):
    """The hand-written PNG decodes with Pillow to the JAX package's
    Pillow-written image (Pillow's bicubic x4 vertical resize included);
    a grayscale PNG decodes to its array."""
    from PIL import Image

    rng = np.random.RandomState(2)
    for t in (1, 7, 250):
        on, fr = rng.rand(t, 88), rng.rand(t, 88)
        utils.save_pianoroll(str(tmp_path / "a.png"), on, fr)
        jsave_pianoroll(str(tmp_path / "b.png"), on, fr)
        a = np.asarray(Image.open(tmp_path / "a.png"))
        b = np.asarray(Image.open(tmp_path / "b.png"))
        assert a.shape == b.shape == (88 * 4, t, 3)
        np.testing.assert_array_equal(a, b)
    gray = rng.randint(0, 256, (13, 29)).astype(np.uint8)
    (tmp_path / "g.png").write_bytes(utils.png_bytes(gray))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")),
                                  gray)


class _Recorder(jloop.NullLogger):
    def __init__(self):
        self.calls = []

    def add_scalar(self, key, value, step):
        self.calls.append(("scalar", key, float(value), step))

    def log_images(self, tag, arrays, step, cmap="jet"):
        self.calls.append(("images", tag, len(arrays), step))


class _FakeModel:
    """Fixed outputs for both packages' `tensorboard_log`: a JAX-style
    run_on_batch (4 values) or the port's (3)."""

    device = torch.device("cpu")

    def __init__(self, jax_style, preds, losses, mel):
        self.jax_style = jax_style
        self.out = preds, losses, mel

    def run_on_batch(self, *args, **kwargs):
        preds, losses, mel = self.out
        if self.jax_style:
            return ({k: (None if v is None else v.numpy())
                     for k, v in preds.items()},
                    {k: v.numpy() for k, v in losses.items()},
                    mel.numpy(), None)
        return preds, losses, mel


def test_event_file_has_the_jax_loops_tags_and_values(tmp_path):
    """Both packages' `tensorboard_log` over the same model outputs: the
    same scalar tags and values and image tags; the port's event file,
    read back by tensorboard's EventAccumulator, holds them (one image
    summary per array)."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    rng = np.random.RandomState(3)
    t = 40
    rows = synth_data.synth_notes(t / 31.25, seed=4, n_notes=6)
    onset, offset, frame = labels.label_to_masks(
        labels.tsv_to_rolls(rows, t * 512 - 1)[0])
    validation = [{"path": "v.wav", "audio": np.zeros(t * 512, np.float32),
                   "onset": onset, "offset": offset, "frame": frame}]
    roll = torch.from_numpy(rng.rand(1, t, 88).astype(np.float32))
    preds = {"frame": roll, "onset": roll, "frame2": None, "onset2": None,
             "reconstruction": torch.rand(1, t, 229, 1),
             "r_adv": torch.rand(1, t, 229) * 0.01,
             "attention": torch.rand(1, t, 4, 31)}
    losses = {"loss/test_frame": torch.tensor(0.25),
              "loss/test_LDS_l": torch.tensor(0.5)}
    mel = torch.rand(1, t, 229)
    batch = {"frame": torch.from_numpy(frame[None])}
    supervised = [{"audio": np.zeros((1, t * 512), np.float32),
                   "frame": frame[None]}] * 2

    rec = {True: _Recorder(), False: _Recorder()}
    for ep in (1, 2):
        jloop.tensorboard_log(
            rec[True], _FakeModel(True, preds, losses, mel),
            types.SimpleNamespace(variables=None),
            {"frame": frame[None]}, validation, supervised,
            lambda state, b, key: {k: v.numpy() for k, v in losses.items()},
            ep, 2, np.zeros(2, np.uint32), True, 0, False, verbose=False)
        loop.tensorboard_log(
            rec[False], _FakeModel(False, preds, losses, mel), batch,
            validation, supervised, lambda b, g: losses, ep, 2, None, True,
            0, False, verbose=False)
    # (the JAX package reads a step's losses back as a pytree, which
    # sorts their keys; the order of scalars within a step is not kept
    # by TensorBoard)
    assert sorted(rec[False].calls) == sorted(rec[True].calls)

    logger = loop.TensorboardLogger(str(tmp_path))
    for kind, tag, value, step in rec[False].calls:
        if kind == "scalar":
            logger.add_scalar(tag, value, step)
    logger.log_losses({"loss/train_frame": torch.tensor(0.125)}, 2)
    arrays = [rng.rand(t, 229) for _ in range(2)]
    logger.log_images("images/Original", arrays, 1)
    logger.close()
    acc = EventAccumulator(str(tmp_path),
                           size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    scalars = {(e.step, tag, e.value) for tag in acc.Tags()["scalars"]
               for e in acc.Scalars(tag)}
    expect = {(step, tag, float(np.float32(value)))
              for kind, tag, value, step in rec[False].calls
              if kind == "scalar"} | {(2, "loss/train_frame", 0.125)}
    assert scalars == expect
    images = acc.Images("images/Original")
    assert [(e.step, e.width, e.height) for e in images] == [(1, t, 229)] * 2


def test_step_drain_totals_equal_at_any_depth():
    """`_StepDrain` reads the same totals and calls `on_step` in step
    order at pipeline 0 and 1 (and as the JAX package's drain adds)."""
    rng = np.random.RandomState(4)
    steps = [{"loss/train_frame": float(rng.rand()),
              "loss/train_LDS_l": float(rng.rand()),
              "loss/total": None} for _ in range(5)]
    for s in steps:
        s["loss/total"] = s["loss/train_frame"] + s["loss/train_LDS_l"] / 2
    out = []
    for depth in (0, 1):
        seen = []
        drain = loop._StepDrain(depth, None, True,
                                on_step=lambda i, h: seen.append(i))
        for i, s in enumerate(steps):
            drain.push(i, {k: torch.tensor(v) for k, v in s.items()})
            assert len(seen) == i + 1 - depth
        out.append(drain.flush())
        assert seen == list(range(5))
    ref = jloop._StepDrain(0, None, False)
    for i, s in enumerate(steps):
        ref.push(i, {k: np.float32(v) for k, v in s.items()})
    assert out[0] == out[1] == pytest.approx(ref.flush(), rel=1e-7)
    with pytest.raises(FloatingPointError):
        bad = loop._StepDrain(0, None, True)
        bad.push(0, {"loss/train_frame": torch.tensor(float("nan"))})
    assert pickle.loads(pickle.dumps(loop.strip_total(steps[0]))) == {
        k: v for k, v in steps[0].items() if k != "loss/total"}
