"""Semi-supervised training: the program's training loop
(`train/loop.py:train_VAT_model`, epochs of `iteration` steps of
`train/state.py:make_train_step(vat=True, use_unlabeled=True)`), fed
labelled and unlabelled batches by `data/loader.py:prefetch_to_device`.

Traffic parameters (`traffic/<mix>.json`): `labelled` and `unlabelled`
clips of `samples` samples a step, drawn from pools of `pool_labelled` and
`pool_unlabelled` synthetic songs with their frame and onset labels (the
first `checked_steps` steps take rows that all differ; later batches are
seeded draws of the pools), `warm_steps` more steps in set-up,
`trace_epochs` epochs under the profiler with `--trace 1`.

Set-up builds one model, optimizer and loop, drives them from the seed
through their first `checked_steps` steps, one `train_VAT_model` call of
one step each, keeps each step's losses, the first gradient as Adam holds
it after one step, the running statistics after the first step and the
last, the parameters after the last, and the rolls of the first step's
first transcriber pass (the unlabelled chain's clean forward, read by a
forward hook that is removed before the window), and hands the same
objects to the window. After the window the reference takes the same
steps from the same weights, batches and generator seed.

End-to-end: `train_audio_s_per_s`, labelled plus unlabelled audio seconds
of the steps completed in the window over its seconds.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import models, synth
from ..harness import log
from ..counts.attn_bwd import attn_bwd
from ..counts.attn_fwd import attn_fwd
from ..counts.mel import mel
from ..counts.model import pass_flops
from ..reference import model as ref_model
from ..reference import train as ref_train

KIND = "train"
SAMPLE_RATE = 16000
ADAM_BETA1 = 0.9


def roll_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between the program's and the reference's rolls,
    over the reference's standard deviation; rows that the program did
    not put out compare as zeros."""
    out = torch.zeros_like(ref)
    n = min(len(prog), len(ref))
    out[:n] = prog[:n].to(ref)
    return float((out - ref).abs().max() / ref.std())


def worst_leaf(prog: dict, ref: dict, keep) -> tuple[float, str]:
    """The largest gap between the program's and the reference's norm of
    a leaf, over the larger of the reference's norm of that leaf and of
    the median leaf, among the leaves `keep`."""
    median = float(np.median([ref[k] for k in keep]))
    gaps = [(abs(prog[k] - ref[k]) / max(ref[k], median), k) for k in keep]
    return max(gaps)


class Driver:
    KIND = KIND

    def __init__(self, config, traffic, seed, device, spans, limits):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device, self.spans = seed, device, spans
        self.hp = config["train"]
        self.model = None

    # -- traffic -----------------------------------------------------------

    def _pools(self):
        t = self.traffic
        rng = np.random.default_rng([self.seed, 0])
        audio, frame, onset = synth.clips(rng, t["pool_labelled"],
                                          t["samples"], with_labels=True)
        ul = synth.clips(rng, t["pool_unlabelled"], t["samples"])
        self.pool_l = {"audio": audio.astype(np.float32) / 32768.0,
                       "frame": frame, "onset": onset}
        self.pool_ul = {"audio": ul.astype(np.float32) / 32768.0}
        self.rng = rng

    def _batches(self, pool, size):
        """Host batches of `size` rows: the first `checked_steps` from one
        permutation (rows that all differ), then seeded draws."""
        n = len(pool["audio"])
        first = self.rng.permutation(n)
        checked = self.traffic["checked_steps"]
        if checked * size > n:
            raise ValueError(f"{checked} checked steps of {size} rows need "
                             f"{checked * size} clips, the pool has {n}")
        rng = np.random.default_rng(self.rng.integers(2 ** 63))
        step = 0
        while True:
            rows = (first[step * size:(step + 1) * size] if step < checked
                    else rng.choice(n, size, replace=False))
            yield {k: np.ascontiguousarray(v[rows]) for k, v in pool.items()}
            step += 1

    def _recorded(self, it, store):
        """Pass host batches on, keeping the first `checked_steps`."""
        for batch in it:
            if len(store) < self.traffic["checked_steps"]:
                store.append(batch)
            yield batch

    def _timed(self, it, name):
        while True:
            with self.spans.span(name):
                batch = next(it)
            yield batch

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from reconvat_tpu_torch.data.loader import prefetch_to_device
        from reconvat_tpu_torch.train.loop import train_VAT_model
        from reconvat_tpu_torch.train.state import (create_train_state,
                                                    make_train_step)

        t, hp = self.traffic, self.hp
        self._pools()
        model = models.build(self.config, self.device)
        models.draw_weights(model, self.seed)
        self.p0, self.s0 = models.split_state(model)
        state = create_train_state(
            model, learning_rate=hp["learning_rate"],
            decay_steps=hp["decay_steps"], decay_rate=hp["decay_rate"],
            clip_gradient_norm=hp["clip_gradient_norm"])
        step = make_train_step(model, hp["alpha"], vat=True,
                               use_unlabeled=True)

        def timed(*args):
            with self.spans.span("train_step.host"):
                return step(*args)

        # train_VAT_model takes the step by whether VAT is on: it is
        self.steps = {True: timed}
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 1)
        self.host_l, self.host_ul = [], []
        l_iter = prefetch_to_device(self._recorded(
            self._batches(self.pool_l, t["labelled"]), self.host_l),
            self.device)
        ul_iter = prefetch_to_device(self._recorded(
            self._batches(self.pool_ul, t["unlabelled"]), self.host_ul),
            self.device)
        self.l_iter = self._timed(l_iter, "loader.next")
        self.ul_iter = self._timed(ul_iter, "loader.next")
        self.model, self.state = model, state
        self.loop = train_VAT_model
        self.epoch = 0

        # the first transcriber pass of the first step is the unlabelled
        # chain's clean forward (`vat.vat_loss`'s y_ref)
        first_pass = []

        def keep_first(_module, _args, out):
            if not first_pass:
                first_pass.append(out[0].detach().float().clone())

        hook = model.transcriber.register_forward_hook(keep_first)
        self.prog_losses = []
        for i in range(t["checked_steps"]):
            losses = self._epoch(1)
            self.prog_losses.append({k: float(v) for k, v in losses.items()})
            if i == 0:
                hook.remove()
                self.ul_rolls = first_pass[0]
                self.s1 = models.split_state(model)[1]
                held = state.optimizer.state
                self.g1 = {n: float((held[p]["exp_avg"] / (1 - ADAM_BETA1))
                                    .norm()) for n, p in
                           model.named_parameters() if p in held}
        self.p3, self.s3 = models.split_state(model)
        for _ in range(t["warm_steps"]):
            self._epoch(1)

    def _epoch(self, iteration):
        self.epoch += 1
        return self.loop(self.model, self.state, self.steps, iteration,
                         self.epoch, self.l_iter, self.ul_iter, self.gen,
                         vat=True, verbose=False, pipeline=self.hp["pipeline"])

    # -- the window --------------------------------------------------------

    def window(self, seconds, tracer):
        iteration = self.hp["iteration"]
        traced = self.traffic["trace_epochs"] if tracer else 0
        steps, epochs = 0, 0
        if traced:
            tracer.start()
        t0 = time.perf_counter()
        end = t0 + seconds
        epoch_s = []
        while time.perf_counter() < end:
            t = time.perf_counter()
            self._epoch(iteration)
            epoch_s.append(time.perf_counter() - t)
            steps += iteration
            epochs += 1
            if traced and epochs == traced:
                tracer.stop(steps)
        elapsed = time.perf_counter() - t0
        log(f"epochs of {iteration} steps: {len(epoch_s)}, seconds each "
            f"{[round(e, 4) for e in epoch_s]}")
        if traced and tracer.open:
            tracer.stop(steps)
        t = self.traffic
        per_step = (t["labelled"] + t["unlabelled"]) * t["samples"] \
            / SAMPLE_RATE
        return {"units": steps, "window_s": elapsed, "attempted": steps,
                "failed": 0,
                "metrics": {"train_audio_s_per_s": (steps * per_step / elapsed,
                                                    "audio-s/s")}}

    # -- counts ------------------------------------------------------------

    def _frames(self):
        return ref_model.n_frames(self.traffic["samples"])

    def unit_flops(self) -> float:
        """Model FLOPs of one step: each forward pass once, each backward
        that reaches the weights twice, the power iteration's backward
        (to the input only) once, and both mels. Per chain of B rows, with
        T and R a transcriber and a reconstructor forward:
        unlabelled: 3 T forward, 1 T input backward, 1 T full backward;
        labelled: 4 T + 1 R forward, 1 T input backward, 3 T + 1 R full
        backward."""
        ref = ref_model.MODELS[self.config["reference"]]()
        t, frames = self.traffic, self._frames()
        ul = pass_flops(ref, self.p0, self.s0, t["unlabelled"], frames)
        lab = pass_flops(ref, self.p0, self.s0, t["labelled"], frames)
        return (mel(t["labelled"], t["samples"])[0]
                + mel(t["unlabelled"], t["samples"])[0]
                + ul["transcriber"] * (3 + 1 + 2)
                + lab["transcriber"] * (4 + 1 + 2 * 3)
                + lab["reconstructor"] * (1 + 2))

    def calls(self) -> dict:
        """{op: [(flops, bytes) of each call in one step]}, from the
        configuration's calls per step and the traffic's rows."""
        t, frames = self.traffic, self._frames()
        rows = {"labelled": t["labelled"], "unlabelled": t["unlabelled"]}
        att = self.config["attention"]
        out = {"mel": [mel(rows[r], t["samples"])
                       for r in self.config["calls"]["train"]["mel"]]}
        for op, fn in (("attn_fwd", attn_fwd), ("attn_bwd", attn_bwd)):
            out[op] = []
            for layer, role, count in self.config["calls"]["train"][op]:
                a = att[layer]
                out[op] += [fn(rows[role], frames, a["heads"], a["head_dim"],
                               a["window"])] * count
        return out

    # -- correctness -------------------------------------------------------

    def release(self):
        self.model = self.state = self.steps = self.loop = None
        self.l_iter = self.ul_iter = None

    def check(self) -> dict:
        """The reference's `checked_steps` steps from the same weights,
        batches and generator seed, against the program's: the unlabelled
        chain's first rolls, each step's losses, the first gradient's norm
        by leaf, the parameters' change by leaf after the last step, the
        running statistics' change by leaf after the first step and the
        last."""
        hp = self.hp
        ref = ref_model.MODELS[self.config["reference"]]()
        signal = ref_model.Signal(self.device)
        p = {k: v.clone() for k, v in self.p0.items()}
        s = {k: v.clone() for k, v in self.s0.items()}
        opt = ref_train.Adam(hp["learning_rate"], hp["decay_steps"],
                             hp["decay_rate"])
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        cfg = dict(self.config["constructor"], **hp)

        def dev(batch):
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}

        with torch.no_grad(), ref_model.fp32_math():
            ul_rolls = ref.transcriber(signal(dev(self.host_ul[0])["audio"]),
                                       p, s, "frozen")[0]["frame"]
        ul_gap = roll_gap(self.ul_rolls, ul_rolls)
        del ul_rolls
        ref_losses = []
        for i in range(self.traffic["checked_steps"]):
            losses, grads = ref_train.step(ref, signal, p, s, opt,
                                           dev(self.host_l[i]),
                                           dev(self.host_ul[i]), gen, cfg)
            ref_losses.append({k: float(v) for k, v in losses.items()})
            if i == 0:
                g1 = {k: float(g.norm()) for k, g in grads.items()}
                s1 = {k: v.clone() for k, v in s.items()}
            log(f"step {i + 1} losses, program / reference: "
                + ", ".join(f"{k[5:]} {self.prog_losses[i][k]} / {v}"
                            for k, v in ref_losses[i].items()))

        def loss_gap(steps, pick):
            return max(abs(self.prog_losses[i][k] - ref_losses[i][k])
                       / abs(ref_losses[i][k])
                       for i in steps for k in ref_losses[i] if pick(k))

        def supervised(k):
            return "LDS" not in k and "r_norm" not in k

        first, later = [0], range(1, self.traffic["checked_steps"])
        floor = self.limits["leaf_floor"] * float(np.median(list(g1.values())))
        keep = [k for k in g1 if g1[k] >= floor]
        grad_gap, grad_leaf = worst_leaf(self.g1, g1, keep)
        moved_p = {k: float((self.p3[k] - self.p0[k]).norm()) for k in keep}
        moved_r = {k: float((p[k] - self.p0[k]).norm()) for k in keep}
        step_gap, step_leaf = worst_leaf(moved_p, moved_r, keep)

        def stats_change(prog, ref):
            return worst_leaf(
                {k: float((prog[k] - self.s0[k]).norm()) for k in ref},
                {k: float((ref[k] - self.s0[k]).norm()) for k in ref},
                list(ref))

        stats1_gap, stats1_leaf = stats_change(self.s1, s1)
        stats_gap, stats_leaf = stats_change(self.s3, s)
        median = float(np.median(list(g1.values())))
        norm_p = float(np.sqrt(sum(self.g1[k] ** 2 for k in g1)))
        norm_r = float(np.sqrt(sum(v ** 2 for v in g1.values())))
        readings = {
            "ul_forward_gap": ul_gap,
            "grad_norm_gap": abs(norm_p - norm_r) / norm_r,
            "lds_ul_gap": loss_gap(first, lambda k: "LDS_ul" in k),
            "loss_gap": loss_gap(first, supervised),
            "lds_gap": loss_gap(first, lambda k: "LDS" in k),
            "r_norm_gap": loss_gap(first, lambda k: "r_norm" in k),
            "later_loss_gap": (loss_gap(later, lambda k: True)
                               if len(later) else 0.0),
            "grad_gap": grad_gap,
            "grad_median_gap": float(np.median(
                [abs(self.g1[k] - g1[k]) / max(g1[k], median)
                 for k in keep])),
            "step_gap": step_gap,
            "stats1_gap": stats1_gap,
            "stats_gap": stats_gap}
        self.readings = readings
        log(f"leaves compared {len(keep)} of {len(g1)}; worst: gradient "
            f"{grad_leaf}, change {step_leaf}, statistics {stats1_leaf} "
            f"(step 1), {stats_leaf}; "
            f"readings {readings}")
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in readings.items() if k in self.limits}
