"""mir_eval-compatible transcription & multipitch metrics, numpy only (the
port's copy of `reconvat_tpu/metrics.py`).

The environment has no mir_eval; these reimplement the exact metric
definitions the reference consumes (`model/evaluate_functions.py:68-117`):

* `precision_recall_f1_overlap` — note-level P/R/F1/average-overlap-ratio
  with 50 ms onset tolerance, 50-cent pitch tolerance, and optional offset
  criterion max(50 ms, 0.2 * ref duration); matching is *maximum* bipartite
  matching over admissible pairs, like `mir_eval.transcription`.
* `evaluate_multipitch` — framewise Poliner-Ellis scores incl. chroma
  variants, like `mir_eval.multipitch.evaluate` (identical time bases).
"""
from __future__ import annotations

import collections

import numpy as np


def _max_bipartite_matching(pairs, n_ref, n_est):
    """Maximum bipartite matching (augmenting paths). pairs: iterable of
    (ref_idx, est_idx) admissible edges. Returns list of matched pairs."""
    adj = collections.defaultdict(list)
    for r, e in pairs:
        adj[r].append(e)
    match_est = {}

    def try_assign(r, seen):
        for e in adj[r]:
            if e in seen:
                continue
            seen.add(e)
            if e not in match_est or try_assign(match_est[e], seen):
                match_est[e] = r
                return True
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000 + n_ref))
    try:
        for r in range(n_ref):
            if adj[r]:
                try_assign(r, set())
    finally:
        sys.setrecursionlimit(old)
    return [(r, e) for e, r in match_est.items()]


def match_notes(ref_intervals, ref_pitches, est_intervals, est_pitches,
                onset_tolerance=0.05, pitch_tolerance=50.0,
                offset_ratio=0.2, offset_min_tolerance=0.05):
    """Admissible-pair matching following mir_eval.transcription.

    Candidate pairs come from a sorted-onset window search (O((R+E) log E
    + candidates) instead of the dense R x E admissibility matrix); every
    candidate is then re-checked with the exact elementwise tolerance
    predicates, and the surviving pairs are fed to the matcher in the
    same row-major (ref, est) order the dense argwhere produced — so the
    matching (not just its cardinality) is unchanged.
    """
    ref_intervals = np.atleast_2d(np.asarray(ref_intervals, dtype=float))
    est_intervals = np.atleast_2d(np.asarray(est_intervals, dtype=float))
    ref_pitches = np.asarray(ref_pitches, dtype=float)
    est_pitches = np.asarray(est_pitches, dtype=float)
    n_ref, n_est = len(ref_pitches), len(est_pitches)
    if n_ref == 0 or n_est == 0:
        return []

    # window slightly widened so ulp-level differences between
    # "est <= ref +- tol" and the exact "|ref - est| <= tol" can never
    # drop a boundary candidate; the exact predicate below decides.
    slack = onset_tolerance * 1e-9 + 1e-12
    est_on = est_intervals[:, 0]
    order = np.argsort(est_on, kind="stable")
    est_on_sorted = est_on[order]
    lo = np.searchsorted(est_on_sorted,
                         ref_intervals[:, 0] - (onset_tolerance + slack),
                         side="left")
    hi = np.searchsorted(est_on_sorted,
                         ref_intervals[:, 0] + (onset_tolerance + slack),
                         side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return []
    r_idx = np.repeat(np.arange(n_ref), counts)
    within = (np.arange(total)
              - np.repeat(np.cumsum(counts) - counts, counts))
    e_idx = order[np.repeat(lo, counts) + within]

    ok = (np.abs(ref_intervals[r_idx, 0] - est_intervals[e_idx, 0])
          <= onset_tolerance)
    cents = np.abs(1200.0 * np.log2(est_pitches[e_idx]
                                    / ref_pitches[r_idx]))
    ok &= cents <= pitch_tolerance
    if offset_ratio is not None:
        durations = ref_intervals[r_idx, 1] - ref_intervals[r_idx, 0]
        tol = np.maximum(offset_min_tolerance, offset_ratio * durations)
        ok &= (np.abs(ref_intervals[r_idx, 1] - est_intervals[e_idx, 1])
               <= tol)

    r_idx, e_idx = r_idx[ok], e_idx[ok]
    perm = np.lexsort((e_idx, r_idx))  # argwhere's row-major order
    pairs = list(zip(r_idx[perm].tolist(), e_idx[perm].tolist()))
    return _max_bipartite_matching(pairs, n_ref, n_est)


def precision_recall_f1_overlap(ref_intervals, ref_pitches, est_intervals,
                                est_pitches, onset_tolerance=0.05,
                                pitch_tolerance=50.0, offset_ratio=0.2,
                                offset_min_tolerance=0.05, beta=1.0):
    """mir_eval.transcription.precision_recall_f1_overlap equivalent."""
    n_ref, n_est = len(ref_pitches), len(est_pitches)
    if n_ref == 0 or n_est == 0:
        return 0.0, 0.0, 0.0, 0.0
    matching = match_notes(ref_intervals, ref_pitches, est_intervals,
                           est_pitches, onset_tolerance, pitch_tolerance,
                           offset_ratio, offset_min_tolerance)
    precision = len(matching) / n_est
    recall = len(matching) / n_ref
    if precision + recall == 0:
        f_measure = 0.0
    else:
        f_measure = ((1 + beta ** 2) * precision * recall
                     / (beta ** 2 * precision + recall))

    if matching:
        ref_intervals = np.atleast_2d(np.asarray(ref_intervals, float))
        est_intervals = np.atleast_2d(np.asarray(est_intervals, float))
        ratios = []
        for r, e in matching:
            t0 = max(ref_intervals[r, 0], est_intervals[e, 0])
            t1 = min(ref_intervals[r, 1], est_intervals[e, 1])
            u0 = min(ref_intervals[r, 0], est_intervals[e, 0])
            u1 = max(ref_intervals[r, 1], est_intervals[e, 1])
            ratios.append((t1 - t0) / (u1 - u0) if u1 > u0 else 0.0)
        avg_overlap_ratio = float(np.mean(ratios))
    else:
        avg_overlap_ratio = 0.0
    return precision, recall, f_measure, avg_overlap_ratio


# ---------------------------------------------------------------------------
# Multipitch (framewise)
# ---------------------------------------------------------------------------

def _freqs_to_midi(freqs):
    return [12.0 * np.log2(np.asarray(f, dtype=float) / 440.0) + 69.0
            if len(f) else np.array([]) for f in freqs]


def _frame_matching_count(ref_midi, est_midi, window=0.5):
    """Number of matched pitches in one frame (maximum matching with
    +-window semitone tolerance)."""
    if len(ref_midi) == 0 or len(est_midi) == 0:
        return 0
    ok = np.abs(ref_midi[:, None] - est_midi[None, :]) <= window
    pairs = [tuple(p) for p in np.argwhere(ok)]
    return len(_max_bipartite_matching(pairs, len(ref_midi), len(est_midi)))


def _int_count_matrix(midi_list, tol=1e-6):
    """(T, 128) per-frame pitch-count matrix when every value is within
    `tol` of an integer in [0, 127]; None otherwise (caller falls back to
    the general bipartite path)."""
    lengths = np.array([len(m) for m in midi_list], dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros((len(midi_list), 128), dtype=np.int64)
    flat = np.concatenate([np.asarray(m, dtype=float).ravel()
                           for m in midi_list if len(m)])
    rounded = np.rint(flat)
    if (np.abs(flat - rounded).max() >= tol
            or rounded.min() < 0 or rounded.max() > 127):
        return None
    frame_idx = np.repeat(np.arange(len(midi_list)), lengths)
    counts = np.zeros((len(midi_list), 128), dtype=np.int64)
    np.add.at(counts, (frame_idx, rounded.astype(np.int64)), 1)
    return counts


def _counts_to_scores(ref_counts, est_counts):
    """Poliner-Ellis scores from per-frame pitch-count matrices. Exact:
    when admissible edges only connect equal bins, the bipartite graph is
    a disjoint union of complete blocks, so the (unique) maximum-matching
    cardinality per frame is sum_bin min(ref_count, est_count)."""
    n_ref_f = ref_counts.sum(axis=1)
    n_est_f = est_counts.sum(axis=1)
    tp_f = np.minimum(ref_counts, est_counts).sum(axis=1)
    n_ref_total = int(n_ref_f.sum())
    n_est_total = int(n_est_f.sum())
    tp_total = int(tp_f.sum())
    e_sub = int((np.minimum(n_ref_f, n_est_f) - tp_f).sum())
    e_miss = int(np.maximum(0, n_ref_f - n_est_f).sum())
    e_fa = int(np.maximum(0, n_est_f - n_ref_f).sum())
    e_tot = int((np.maximum(n_ref_f, n_est_f) - tp_f).sum())
    precision = tp_total / n_est_total if n_est_total else 0.0
    recall = tp_total / n_ref_total if n_ref_total else 0.0
    fp = n_est_total - tp_total
    fn = n_ref_total - tp_total
    accuracy = (tp_total / (tp_total + fp + fn)
                if tp_total + fp + fn else 0.0)
    denom = max(n_ref_total, 1)
    return dict(precision=precision, recall=recall, accuracy=accuracy,
                e_sub=e_sub / denom, e_miss=e_miss / denom,
                e_fa=e_fa / denom, e_tot=e_tot / denom)


def _chroma_fold(counts):
    """(T, 128) pitch counts -> (T, 12) chroma counts."""
    return counts[:, :120].reshape(counts.shape[0], 10, 12).sum(axis=1) \
        + np.pad(counts[:, 120:], ((0, 0), (0, 4)))


def _pack_result(plain, chroma):
    return {
        "Precision": plain["precision"],
        "Recall": plain["recall"],
        "Accuracy": plain["accuracy"],
        "Substitution Error": plain["e_sub"],
        "Miss Error": plain["e_miss"],
        "False Alarm Error": plain["e_fa"],
        "Total Error": plain["e_tot"],
        "Chroma Precision": chroma["precision"],
        "Chroma Recall": chroma["recall"],
        "Chroma Accuracy": chroma["accuracy"],
        "Chroma Substitution Error": chroma["e_sub"],
        "Chroma Miss Error": chroma["e_miss"],
        "Chroma False Alarm Error": chroma["e_fa"],
        "Chroma Total Error": chroma["e_tot"],
    }


def evaluate_multipitch(ref_time, ref_freqs, est_time, est_freqs,
                        window=0.5):
    """mir_eval.multipitch.evaluate equivalent (shared time base).

    Returns the same key set: Precision/Recall/Accuracy, Poliner-Ellis
    error scores, and Chroma variants.

    Fast path: when every MIDI value is integer-valued (the transcription
    pipeline always is — pianoroll bins -> Hz -> back) and the tolerance
    window sits strictly between the rounding error and one semitone,
    per-frame maximum matching reduces to histogram intersection and the
    whole song is scored with a handful of vectorized ops. Non-integer
    pitches fall back to the general per-frame bipartite matcher.
    """
    ref_time = np.asarray(ref_time)
    est_time = np.asarray(est_time)
    if len(ref_time) != len(est_time) or not np.allclose(ref_time, est_time):
        # nearest-neighbour resample of the estimate onto the ref time base
        idx = np.searchsorted(est_time, ref_time)
        idx = np.clip(idx, 0, len(est_time) - 1)
        prev = np.clip(idx - 1, 0, len(est_time) - 1)
        use_prev = (np.abs(est_time[prev] - ref_time)
                    < np.abs(est_time[idx] - ref_time))
        idx = np.where(use_prev, prev, idx)
        est_freqs = [est_freqs[i] for i in idx] if len(est_time) else \
            [np.array([]) for _ in ref_time]

    ref_midi = _freqs_to_midi(ref_freqs)
    est_midi = _freqs_to_midi(est_freqs)

    # integer fast path: exact iff rounding error << window < 1 - error
    if 1e-3 <= window <= 1 - 1e-3:
        ref_counts = _int_count_matrix(ref_midi)
        est_counts = (None if ref_counts is None
                      else _int_count_matrix(est_midi))
        if ref_counts is not None and est_counts is not None:
            return _pack_result(
                _counts_to_scores(ref_counts, est_counts),
                _counts_to_scores(_chroma_fold(ref_counts),
                                  _chroma_fold(est_counts)))

    def _scores(ref_list, est_list, count_fn):
        n_ref_total = n_est_total = tp_total = 0
        e_sub = e_miss = e_fa = e_tot = 0
        for r, e in zip(ref_list, est_list):
            n_ref, n_est = len(r), len(e)
            tp = count_fn(r, e)
            n_ref_total += n_ref
            n_est_total += n_est
            tp_total += tp
            e_sub += min(n_ref, n_est) - tp
            e_miss += max(0, n_ref - n_est)
            e_fa += max(0, n_est - n_ref)
            e_tot += max(n_ref, n_est) - tp
        precision = tp_total / n_est_total if n_est_total else 0.0
        recall = tp_total / n_ref_total if n_ref_total else 0.0
        fp = n_est_total - tp_total
        fn = n_ref_total - tp_total
        accuracy = (tp_total / (tp_total + fp + fn)
                    if tp_total + fp + fn else 0.0)
        denom = max(n_ref_total, 1)
        return dict(precision=precision, recall=recall, accuracy=accuracy,
                    e_sub=e_sub / denom, e_miss=e_miss / denom,
                    e_fa=e_fa / denom, e_tot=e_tot / denom)

    def _chroma_count(r, e):
        if len(r) == 0 or len(e) == 0:
            return 0
        d = np.abs(r[:, None] - e[None, :])
        d = np.minimum(d, 12 - d)  # circular chroma distance
        pairs = [tuple(p) for p in np.argwhere(d <= window)]
        return len(_max_bipartite_matching(pairs, len(r), len(e)))

    plain = _scores(ref_midi, est_midi,
                    lambda r, e: _frame_matching_count(r, e, window))
    chroma = _scores([np.mod(r, 12) for r in ref_midi],
                     [np.mod(e, 12) for e in est_midi], _chroma_count)
    return _pack_result(plain, chroma)


def evaluate_multipitch_rolls(ref_roll, est_roll, min_midi, window=0.5):
    """evaluate_multipitch on binary pianorolls (T, keys) directly.

    Equivalent to converting each roll's active bins to Hz per frame
    (`decode.notes_to_frames` + midi_to_hz) and calling
    `evaluate_multipitch` — proven equal in tests — but skips the
    per-frame list/Hz round-trip entirely. Requires a shared time base
    (same T) and 1e-3 <= window <= 1 - 1e-3 (integer-bin exactness).
    """
    if ref_roll.shape[0] != est_roll.shape[0]:
        raise ValueError("rolls must share a time base")
    if not (1e-3 <= window <= 1 - 1e-3):
        raise ValueError("window outside the integer-exact regime")

    def _counts(roll):
        counts = np.zeros((roll.shape[0], 128), dtype=np.int64)
        hi = min(128, min_midi + roll.shape[1])
        counts[:, min_midi:hi] = (np.asarray(roll) > 0)[:, :hi - min_midi]
        return counts

    ref_counts, est_counts = _counts(ref_roll), _counts(est_roll)
    return _pack_result(
        _counts_to_scores(ref_counts, est_counts),
        _counts_to_scores(_chroma_fold(ref_counts),
                          _chroma_fold(est_counts)))


def average_precision_score(y_true, y_score):
    """Micro average precision, as scikit-learn's binary
    `average_precision_score` computes it (used for
    `metric/MusicNet/micro_avg_P`): the precision-recall curve over the
    distinct scores, ties of a score taken together, then sum of
    (R_n - R_{n-1}) P_n. numpy only; the JAX package calls scikit-learn
    where it is installed."""
    y_true = (np.asarray(y_true).ravel() == 1).astype(np.float64)
    y_score = np.asarray(y_score).ravel()
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    last = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[last]
    fps = 1 + last - tps
    precision = np.divide(tps, tps + fps, out=np.zeros_like(tps),
                          where=(tps + fps) != 0)
    recall = (np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1])
    precision = np.hstack((precision[::-1], 1))
    recall = np.hstack((recall[::-1], 0))
    return float(-np.sum(np.diff(recall) * precision[:-1]))
