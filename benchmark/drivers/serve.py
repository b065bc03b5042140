"""Batched serving: a closed loop of `depth` batches in flight through
the program's serving path (`serve.submit` -> `PendingBatch.packed` ->
`PendingBatch.notes`, one copy stream), the loop of
`chip_smoke.py:serve_loop` with a latency for each batch.

Traffic parameters (`traffic/<mix>.json`): `batch` clips of `samples`
int16 samples a batch, `pool_batches` batches made from `pool_clips`
synthetic songs (each batch a seeded choice of the clips, each clip
turned by a seeded circular shift), `depth` batches in flight,
`warm_batches` through the loop in set-up, `probe_clips` clips of the
first batch on which the transcriber's BatchNorm statistics are set
(`models.calibrate_batchnorm`) and the frame head's bias is then shifted
to put a share `density` of the bins over 0.5, `trace_batches` batches under the profiler with
`--trace 1`, `check_batches` finished batches compared with the
reference.

End-to-end: `serve_audio_s_per_s`, audio seconds of the batches whose
notes were decoded in the window over its seconds; `serve_p95_ms`, the
95th percentile over those batches of the time from the start of their
`submit` to their notes decoded.
"""
from __future__ import annotations

import math
import statistics
import time
from collections import deque

import numpy as np
import torch

from .. import models, synth
from ..harness import log
from ..counts.attn_fwd import attn_fwd
from ..counts.mel import mel
from ..counts.model import pass_flops
from ..reference import decode as ref_decode
from ..reference import model as ref_model

KIND = "serve"
SAMPLE_RATE = 16000


def p95(values) -> float:
    """The 95th percentile of all values (`statistics.quantiles`,
    inclusive method)."""
    if not values:
        raise RuntimeError("no batch finished in the window")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


class Driver:
    KIND = KIND

    def __init__(self, config, traffic, seed, device, spans, limits):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device, self.spans = seed, device, spans
        self.model = None

    # -- set-up ------------------------------------------------------------

    def _pool(self):
        t = self.traffic
        rng = np.random.default_rng([self.seed, 0])
        base = synth.clips(rng, t["pool_clips"], t["samples"])
        pool = []
        for _ in range(t["pool_batches"]):
            rows = rng.choice(t["pool_clips"], t["batch"],
                              replace=t["batch"] > t["pool_clips"])
            shifts = rng.integers(0, t["samples"], t["batch"])
            pool.append(np.ascontiguousarray(np.stack(
                [np.roll(base[r], s) for r, s in zip(rows, shifts)])))
        return pool

    def setup(self):
        from reconvat_tpu_torch import serve

        self.serve = serve
        t = self.traffic
        self.pool = self._pool()
        model = models.build(self.config, self.device)
        models.draw_weights(model, self.seed)
        self.params, self.stats = models.split_state(model)
        probe = self._audio(0)[:t["probe_clips"]]
        models.calibrate_batchnorm(model, probe)
        shift = models.density_shift(model.transcribe(probe)["frame"],
                                     t["density"])
        head = dict(model.named_parameters())[
            self.config["frame_head"] + ".bias"]
        with torch.no_grad():
            head += shift
        self.model = model
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._loop(t["warm_batches"], None, None)

    def _audio(self, slot):
        return (torch.from_numpy(self.pool[slot]).to(self.device).float()
                / 32768.0)

    # -- the loop ----------------------------------------------------------

    def _loop(self, n_batches, seconds, tracer):
        """Submit batches of the pool in turn with `depth` in flight,
        until `n_batches` have finished or `seconds` have passed. Returns
        the finished batches, in order: (index, pool slot, latency s,
        packed bits, notes), and the seconds the loop ran."""
        depth, span = self.traffic["depth"], self.spans.span
        pending, done = deque(), []
        trace_n = self.traffic["trace_batches"] if tracer else 0
        if trace_n:
            tracer.start()
        t0 = time.perf_counter()
        end = t0 + seconds if seconds is not None else math.inf
        i = 0

        def finish():
            # the slice holds the device work of every batch submitted by
            # its end (stop waits for it): those are its units
            idx, slot, start, p = pending.popleft()
            with span("serve.wait"):
                packed = p.packed()
            with span("serve.decode"):
                notes = p.notes()
            latency = time.perf_counter() - start
            done.append((idx, slot, latency, packed.numpy().copy(), notes))
            if trace_n and len(done) == trace_n:
                tracer.stop(i)

        while time.perf_counter() < end and len(done) < n_batches:
            if len(pending) < depth:
                slot = i % len(self.pool)
                start = time.perf_counter()
                with span("serve.submit"):
                    p = self.serve.submit(self.model, self.pool[slot],
                                          self.copy_stream)
                pending.append((i, slot, start, p))
                i += 1
            else:
                finish()
        elapsed = time.perf_counter() - t0
        counted = len(done)
        while pending:
            finish()
        if trace_n and tracer.open:
            tracer.stop(i)
        return done[:counted], elapsed, i

    def window(self, seconds, tracer):
        done, elapsed, submitted = self._loop(math.inf, seconds, tracer)
        self.done = done
        t = self.traffic
        audio_s = len(done) * t["batch"] * t["samples"] / SAMPLE_RATE
        return {"units": len(done), "window_s": elapsed,
                "attempted": submitted, "failed": 0,
                "metrics": {
                    "serve_audio_s_per_s": (audio_s / elapsed, "audio-s/s"),
                    "serve_p95_ms": (p95([d[2] for d in done]) * 1e3, "ms")}}

    # -- counts ------------------------------------------------------------

    def _frames(self):
        return ref_model.n_frames(self.traffic["samples"])

    def unit_flops(self) -> float:
        """Model FLOPs of one batch: the mel and one transcriber pass."""
        ref = ref_model.MODELS[self.config["reference"]]()
        b = self.traffic["batch"]
        per = pass_flops(ref, self.params, self.stats, b, self._frames())
        return mel(b, self.traffic["samples"])[0] + per["transcriber"]

    def calls(self) -> dict:
        """{op: [(flops, bytes) of each call in one batch]}."""
        t, frames = self.traffic, self._frames()
        calls = self.config["calls"]["serve"]
        att = self.config["attention"]
        out = {"mel": [mel(t[r], t["samples"]) for r in calls["mel"]],
               "attn_fwd": []}
        for layer, role, count in calls["attn_fwd"]:
            a = att[layer]
            out["attn_fwd"] += [attn_fwd(t[role], frames, a["heads"],
                                         a["head_dim"], a["window"])] * count
        return out

    # -- correctness -------------------------------------------------------

    def release(self):
        self.model = self.serve = None

    @torch.no_grad()
    def check(self) -> dict:
        """Over a seeded sample of the window's finished batches: the
        widest margin by which a served bit lies on the other side of 0.5
        from the reference's probability, as the reference's frame logit
        over the spread (standard deviation) of its batch's logits (0
        where every bit agrees: random weights put every logit near 0, so
        the margin is read in the logits' own scale); and the clips whose
        notes differ from the reference decode of their served bits."""
        t = self.traffic
        ref = ref_model.MODELS[self.config["reference"]]()
        p, s = self.params, self.stats
        with ref_model.fp32_math():
            signal = ref_model.Signal(self.device)
            probe = self._audio(0)[:t["probe_clips"]]
            s = dict(s)
            ref.transcriber(signal(probe), p, s, "calibrate")
            probs = torch.sigmoid(ref_model.frame_logits(ref, signal, probe,
                                                         p, s))
            head = ref.frame_head + ".bias"
            p = dict(p, **{head: p[head] + models.density_shift(
                probs, t["density"])})
            rng = np.random.default_rng([self.seed, 1])
            picks = rng.choice(len(self.done), min(t["check_batches"],
                                                   len(self.done)),
                               replace=False)
            gap = raw = wrong_bits = 0.0
            mismatched, bits_seen = 0, 0
            rows = t.get("check_block", 8)
            for k in sorted(picks):
                _, slot, _, packed, notes = self.done[k]
                audio = self._audio(slot)
                logits = torch.cat([
                    ref_model.frame_logits(ref, signal, audio[r:r + rows], p,
                                           s)
                    for r in range(0, len(audio), rows)]).cpu().numpy()
                bits = ref_decode.unpack(packed)
                wrong = bits != (logits > 0)
                bits_seen += wrong.size
                wrong_bits += wrong.sum()
                if wrong.any():
                    margin = float(np.abs(logits[wrong]).max())
                    raw = max(raw, margin)
                    gap = max(gap, margin / float(logits.std()))
                mismatched += sum(
                    not ref_decode.same_notes(notes[b],
                                              ref_decode.notes(bits[b]))
                    for b in range(len(bits)))
        self.readings = {"roll_gap": gap, "roll_gap_logit": raw,
                         "bits_disagreeing": wrong_bits / bits_seen,
                         "note_mismatch": mismatched}
        log(f"checked {len(picks)} batches: {self.readings}")
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in self.readings.items() if k in self.limits}
