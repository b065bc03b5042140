"""Full-song evaluation: losses, note and frame metrics, artifacts (the
port's counterpart of `reconvat_tpu/evaluate.py`, reference
`evaluate_wo_velocity`, `model/evaluate_functions.py:20-127`), with the same
metric keys, the port's native note decoder (`decode.py`), its numpy
metrics (`metrics.py`) and its MIDI writer.

`make_bucketed_runner` pads each song to a doubling ladder of frame counts
(`models/common.BUCKET_LADDER`), masks the normalization statistics and the
losses to the true frames and trims the predictions: they differ from the
exact-length path only inside the receptive field's halo at the song end.
Its `run_group` stacks same-bucket songs into one eval-mode forward; each
row is masked by its own length and its losses are its own means
(eval-mode BatchNorm keeps the rows independent), so a group's songs get
what they get one at a time.
"""
from __future__ import annotations

import os
import sys
from collections import defaultdict, deque

import numpy as np
import torch

from . import constants as C
from . import decode, metrics
from .data.loader import BATCH_KEYS
from .data.midi_io import midi_to_hz, save_midi
from .models.common import (BUCKET_LADDER, frames_in, next_bucket,
                            pad_song_batch)
from .models.reconvat import fp32_math
from .utils import save_pianoroll

eps = sys.float_info.epsilon


def _hmean2(a, b):
    return 2.0 / (1.0 / a + 1.0 / b)


def _to_host(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _eval_forward(model, batch, t_true):
    """One eval-mode `run_on_batch` of host arrays on the model's device,
    without gradients, TF32 off."""
    batch = {k: torch.as_tensor(np.asarray(v)).to(model.device)
             for k, v in batch.items() if k in BATCH_KEYS}
    with torch.no_grad(), fp32_math():
        return model.run_on_batch(batch, None, None, vat=False, train=False,
                                  t_true=t_true)


def make_bucketed_runner(model, buckets=None):
    """Full-song runner for `evaluate_wo_velocity` (counterpart of
    `reconvat_tpu/evaluate.py:30-163`): runner(item) -> (predictions,
    losses, spec) of one song, padded to its bucket (+2 frames, so the
    reflect fill covers the frontend's centre padding and the true frames
    are exact), trimmed to its true frames. `runner.run_group(items,
    group_size)` runs same-bucket songs as one batch; `runner.bucket_of`
    names an item's bucket."""
    buckets = tuple(buckets) if buckets is not None else BUCKET_LADDER

    def bucket_of(item):
        return next_bucket(
            frames_in(np.asarray(item["audio"]).shape[-1]) + 2, buckets)

    def trim(preds, spec, row, t_pad, t_true):
        """Row `row` of a batch's outputs, cut to its t_true frames."""
        p = {k: (v[row:row + 1, :t_true] if torch.is_tensor(v)
                 and v.dim() >= 2 and v.shape[1] == t_pad else v)
             for k, v in preds.items()}
        return p, spec[row:row + 1, :t_true]

    def runner(item):
        t_pad = bucket_of(item)
        batch, t_true = pad_song_batch(item, t_pad)
        preds, losses, spec = _eval_forward(model, batch, t_true)
        preds, spec = trim(preds, spec, 0, t_pad, t_true)
        return preds, losses, spec

    def run_group(items, group_size=None):
        """One forward over same-bucket songs, each masked by its own
        length; a list of per-song (predictions, losses, spec)."""
        if len(items) <= 1:
            return [runner(it) for it in items]
        t_pads = {bucket_of(it) for it in items}
        if len(t_pads) != 1:
            raise ValueError(f"run_group needs same-bucket songs, got "
                             f"buckets {sorted(t_pads)}")
        t_pad = t_pads.pop()
        pairs = [pad_song_batch(it, t_pad) for it in items]
        batch = {k: np.concatenate([b[k] for b, _ in pairs])
                 for k in pairs[0][0]}
        t_trues = [t for _, t in pairs]
        preds, losses, spec = _eval_forward(model, batch,
                                            torch.tensor(t_trues))
        out = []
        for g, t_true in enumerate(t_trues):
            p, s = trim(preds, spec, g, t_pad, t_true)
            out.append((p, {k: (v[g] if v.dim() else v)
                            for k, v in losses.items()}, s))
        return out

    runner.bucket_of = bucket_of
    runner.run_group = run_group
    return runner


def _score_song(label, pred, losses, onset_threshold, frame_threshold,
                save_path, reconstruction, onset, pseudo_onset, rule):
    """All host-side work for one song (decode + matching + metrics +
    artifact dumps), returned as an ordered {key: value} dict. Pure
    per-song function so `evaluate_wo_velocity` can run songs on a
    thread pool without changing any value or the corpus order."""
    results = {}
    for key, loss in losses.items():
        results[key] = float(loss)

    pred = {k: (np.maximum(_to_host(v)[0], 0)
                if k in ("frame", "onset", "frame2", "onset2")
                and v is not None else v)
            for k, v in pred.items()}
    label_onset = _to_host(label["onset"]).reshape(-1, C.N_KEYS)
    label_frame = _to_host(label["frame"]).reshape(-1, C.N_KEYS)

    if onset:
        if pseudo_onset:
            p_ref, i_ref = decode.extract_notes_wo_velocity(
                label_onset, label_frame, rule=rule)
            p_est, i_est = decode.extract_notes_wo_velocity(
                label_onset, pred["frame"], onset_threshold,
                frame_threshold, rule=rule)
        else:
            p_ref, i_ref = decode.extract_notes_wo_velocity(
                label_onset, label_frame, rule=rule)
            p_est, i_est = decode.extract_notes_wo_velocity(
                pred["onset"], pred["frame"], onset_threshold,
                frame_threshold, rule=rule)
    else:
        p_ref, i_ref = decode.extract_notes_wo_velocity(
            label_frame, label_frame, rule=rule)
        p_est, i_est = decode.extract_notes_wo_velocity(
            pred["frame"], pred["frame"], onset_threshold,
            frame_threshold, rule=rule)

    # binary rolls feed metrics.evaluate_multipitch_rolls directly —
    # identical scores to the reference's per-frame Hz-list path
    # (tests/test_metrics.py::test_multipitch_rolls_equals_lists)
    # without the frame-by-frame list/Hz round-trip.
    roll_ref = decode.notes_to_roll(p_ref, i_ref, label_frame.shape)
    roll_est = decode.notes_to_roll(p_est, i_est, pred["frame"].shape)
    if roll_ref.shape[0] != roll_est.shape[0]:
        # a model/dataset pair with an off-by-a-few frame count (no
        # t_true support) shouldn't crash the eval: score on the
        # shared prefix, like the reference's nearest-neighbour
        # time-base resample tolerated (`evaluate_functions.py:60-66`)
        t = min(roll_ref.shape[0], roll_est.shape[0])
        roll_ref, roll_est = roll_ref[:t], roll_est[:t]

    scaling = C.HOP_LENGTH / C.SAMPLE_RATE
    i_ref = (np.asarray(i_ref) * scaling).reshape(-1, 2)
    p_ref = midi_to_hz(C.MIN_MIDI + np.asarray(p_ref, dtype=float))
    i_est = (np.asarray(i_est) * scaling).reshape(-1, 2)
    p_est = midi_to_hz(C.MIN_MIDI + np.asarray(p_est, dtype=float))

    p, r, f, o = metrics.precision_recall_f1_overlap(
        i_ref, p_ref, i_est, p_est, offset_ratio=None)
    results["metric/note/precision"] = p
    results["metric/note/recall"] = r
    results["metric/note/f1"] = f
    results["metric/note/overlap"] = o

    p, r, f, o = metrics.precision_recall_f1_overlap(
        i_ref, p_ref, i_est, p_est)
    results["metric/note-with-offsets/precision"] = p
    results["metric/note-with-offsets/recall"] = r
    results["metric/note-with-offsets/f1"] = f
    results["metric/note-with-offsets/overlap"] = o

    frame_metrics = metrics.evaluate_multipitch_rolls(
        roll_ref, roll_est, C.MIN_MIDI)
    results["metric/frame/f1"] = (
        _hmean2(frame_metrics["Precision"] + eps,
                frame_metrics["Recall"] + eps) - eps)

    avp = metrics.average_precision_score(label_frame.flatten(),
                                          pred["frame"].flatten())
    results["metric/MusicNet/micro_avg_P"] = avp

    if reconstruction:
        p_est2, i_est2 = decode.extract_notes_wo_velocity(
            pred["onset2"], pred["frame2"], onset_threshold,
            frame_threshold)
        roll_est2 = decode.notes_to_roll(p_est2, i_est2,
                                         pred["frame2"].shape)
        i_est2 = (np.asarray(i_est2) * scaling).reshape(-1, 2)
        p_est2 = midi_to_hz(C.MIN_MIDI + np.asarray(p_est2, dtype=float))

        p2, r2, f2, o2 = metrics.precision_recall_f1_overlap(
            i_ref, p_ref, i_est2, p_est2, offset_ratio=None)
        results["metric/note/precision_2"] = p2
        results["metric/note/recall_2"] = r2
        results["metric/note/f1_2"] = f2
        results["metric/note/overlap_2"] = o2

        frame_metrics2 = metrics.evaluate_multipitch_rolls(
            roll_ref, roll_est2, C.MIN_MIDI)
        frame_metrics["Precision_2"] = frame_metrics2["Precision"]
        frame_metrics["Recall_2"] = frame_metrics2["Recall"]
        frame_metrics["accuracy_2"] = frame_metrics2["Accuracy"]
        results["metric/frame/f1_2"] = (
            _hmean2(frame_metrics["Precision_2"] + eps,
                    frame_metrics["Recall_2"] + eps) - eps)
        avp = metrics.average_precision_score(label_frame.flatten(),
                                              pred["frame2"].flatten())
        results["metric/MusicNet/micro_avg_P2"] = avp

        p2, r2, f2, o2 = metrics.precision_recall_f1_overlap(
            i_ref, p_ref, i_est2, p_est2)
        results["metric/note-with-offsets/precision_2"] = p2
        results["metric/note-with-offsets/recall_2"] = r2
        results["metric/note-with-offsets/f1_2"] = f2
        results["metric/note-with-offsets/overlap_2"] = o2

    for key, value in frame_metrics.items():
        results["metric/frame/" + key.lower().replace(" ", "_")] = value

    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        base = os.path.basename(str(label["path"]))
        save_pianoroll(os.path.join(save_path, base + ".label.png"),
                       label_onset, label_frame)
        save_pianoroll(os.path.join(save_path, base + ".pred.png"),
                       pred["onset"], pred["frame"])
        save_midi(os.path.join(save_path, base + ".pred.mid"),
                  p_est, i_est, [127] * len(p_est))
    return results


def evaluate_wo_velocity(data, run_on_batch, onset_threshold=0.5,
                         frame_threshold=0.5, save_path=None,
                         reconstruction=True, onset=True, pseudo_onset=False,
                         rule="rule2", verbose=False, pipeline=2,
                         batch_songs=1, host_workers=0):
    """data: iterable of per-song label dicts (batch axis of 1 or absent).

    run_on_batch(item) -> (predictions, losses, spec): an eval-mode
    closure over the model.

    `pipeline` songs' forwards stay queued ahead of the host decode and
    metrics (CUDA runs asynchronously, so song i+1 runs on the device
    while the host scores song i); 0 is the reference's synchronous
    per-song order. Results are identical at any depth.

    `batch_songs=G` (needs a `make_bucketed_runner` runner) groups
    same-bucket songs G at a time into one forward; per-song masking and
    losses stay exact, so the metrics are the per-song path's. Results
    are reported in corpus order. Default 1: one song at a time.

    `host_workers=W` runs the per-song host scoring (`_score_song`:
    note decode, bipartite matching, multipitch counts, artifact dumps)
    on a W-thread pool — songs are independent and the heavy pieces
    (numpy, the ctypes note decoder) release the GIL, so scoring
    overlaps both other songs' scoring and the device forwards. Values
    and corpus order are identical to W=0 (the reference's synchronous
    loop): results merge in submission order.
    """
    results = defaultdict(list)
    pending = deque()
    depth = max(0, int(pipeline))
    group_size = max(1, int(batch_songs))
    workers = max(0, int(host_workers))

    if group_size > 1 and hasattr(run_on_batch, "run_group"):
        data = list(data)
        by_bucket = defaultdict(list)
        for i, item in enumerate(data):
            by_bucket[run_on_batch.bucket_of(item)].append(i)
        groups = sorted(
            (idxs[j:j + group_size]
             for idxs in by_bucket.values()
             for j in range(0, len(idxs), group_size)),
            key=lambda g: g[0])
        song_group = {i: gid for gid, g in enumerate(groups) for i in g}
        results_by_idx = {}
        state = {"dispatched": 0}

        def _ensure(gid):
            # keep `depth` groups of forwards in flight past the one
            # the host is consuming
            while state["dispatched"] <= min(gid + depth, len(groups) - 1):
                g = groups[state["dispatched"]]
                outs = run_on_batch.run_group([data[i] for i in g],
                                              group_size)
                for i, res in zip(g, outs):
                    results_by_idx[i] = res
                state["dispatched"] += 1

        def _run_all():
            for i, item in enumerate(data):
                _ensure(song_group[i])
                yield item, results_by_idx.pop(i)
    else:
        def _run_all():
            for label in data:
                pending.append((label, run_on_batch(label)))
                if len(pending) > depth:
                    yield pending.popleft()
            while pending:
                yield pending.popleft()

    def score(label, pred, losses):
        return _score_song(label, pred, losses, onset_threshold,
                           frame_threshold, save_path, reconstruction,
                           onset, pseudo_onset, rule)

    def merge(song_results, label):
        for key, value in song_results.items():
            results[key].append(value)
        if verbose:
            print(f"evaluated {label.get('path', '?')}")

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = deque()
            for label, (pred, losses, _) in _run_all():
                futures.append((label, pool.submit(score, label, pred,
                                                   losses)))
                # bounded in-flight scoring keeps memory flat; draining in
                # submission order keeps the per-song lists in corpus order
                while len(futures) > 2 * workers:
                    lab, fut = futures.popleft()
                    merge(fut.result(), lab)
            while futures:
                lab, fut = futures.popleft()
                merge(fut.result(), lab)
    else:
        for label, (pred, losses, _) in _run_all():
            merge(score(label, pred, losses), label)
    return results


def print_metrics(results):
    """`category name: mean ± std` table (reference
    `train_UNet_Onset_VAT.py:164-167`)."""
    lines = []
    for key, values in results.items():
        if key.startswith("metric/"):
            _, category, name = key.split("/")
            line = (f"{category:>32} {name:25}: "
                    f"{np.mean(values):.3f} ± {np.std(values):.3f}")
            print(line)
            lines.append(line)
    return lines
