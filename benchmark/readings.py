"""Readings the limits of `limits/<cell>.json` are set from: the numbers
the comparison reads for sound runs of the program over many seeds, for
the control (the program's own bf16 path, one precision below the
configuration's fp32) and for planted faults, each at the cell's own
sizes, in one process.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults half,altered] [--seconds 3]

Each reading is a set-up, a short window (serving: enough to finish the
batches the check samples) and the check. Prints one JSON line per
reading. The benchmark's own runs never run this.

Faults, planted in the program's modules for one reading:
- `half`: half of each batch left out. Serving: the second half of a
  batch's packed rolls are copies of the first half's. Training: each
  step takes the first half of its labelled and unlabelled rows (at
  least one), its losses the means over them.
- `altered`: serving: one bit of each batch's packed roll flipped where
  the device packs it.
- `unchanged`: training: the optimizer's update left out, so the step
  returns its state unchanged.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from .harness import ROOT, driver_of, load_cell, load_json, log, run_cell


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted in it for the block."""
    if fault is None:
        yield
        return
    import torch
    from reconvat_tpu_torch import serve
    from reconvat_tpu_torch.train import state

    saved = {}

    def patch(mod, name, fn):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)

    pack = serve.pack_roll_device
    make = state.make_train_step
    if fault == "altered":
        def altered(probs, threshold=0.5):
            out = pack(probs, threshold)
            out[0, out.shape[1] // 2, 0] ^= 1
            return out
        patch(serve, "pack_roll_device", altered)
    elif fault == "half":
        def half_rows(probs, threshold=0.5):
            out = pack(probs, threshold)
            b = out.shape[0]
            out[b - b // 2:] = out[:b // 2]
            return out

        def half_step(model, alpha, vat, use_unlabeled, application=False):
            step = make(model, alpha, vat, use_unlabeled, application)

            def halved(st, batch_l, batch_ul, generator):
                def cut(batch):
                    n = max(1, len(batch["audio"]) // 2)
                    return {k: v[:n] for k, v in batch.items()}
                return step(st, cut(batch_l), cut(batch_ul), generator)
            return halved
        patch(serve, "pack_roll_device", half_rows)
        patch(state, "make_train_step", half_step)
    elif fault == "unchanged":
        def frozen_step(model, alpha, vat, use_unlabeled, application=False):
            step = make(model, alpha, vat, use_unlabeled, application)

            def no_update(st, batch_l, batch_ul, generator):
                before = [p.detach().clone() for p in model.parameters()]
                losses = step(st, batch_l, batch_ul, generator)
                with torch.no_grad():
                    for p, b in zip(model.parameters(), before):
                        p.copy_(b)
                return losses
            return no_update
        patch(state, "make_train_step", frozen_step)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def reading(driver_mod, config, traffic, limits, seed, seconds, device,
            fault=None) -> dict:
    """Every number the check read in one set-up, short window and check,
    by name (those the cell compares among them)."""
    with planted(fault):
        result = run_cell(driver_mod, config, traffic, limits, seed,
                          seconds, False, device, time.time())
    return result["readings"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, limits = load_cell(args.workload, bench)
    drv = driver_of(traffic["kind"])

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    runs = [("sound", s, config, None) for s in seeds(args.seeds)]
    control = dict(config, compute_dtype="bfloat16")
    runs += [("control", s, control, None) for s in seeds(args.control_seeds)]
    for fault in (f for f in args.faults.split(",") if f):
        runs += [(fault, s, config, fault)
                 for s in seeds(args.fault_seeds or args.control_seeds)]
    for what, seed, cfg, fault in runs:
        t0 = time.time()
        got = reading(drv, cfg, traffic, limits, seed, args.seconds, device,
                      fault)
        print(json.dumps({"cell": cell["name"], "what": what, "seed": seed,
                          "checks": got, "s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
