"""One run of one cell: set-up, the measured window, the comparison that
decides `correct`, and the result line. Everything that belongs to one
configuration, traffic mix or per-layer metric is found by name:
`configs/<config>.json`, `traffic/<mix>.json` (whose `kind` names the
driver `drivers/<kind>.py`) and `metrics/<metric>.py`."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "reconvat_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict) -> tuple[dict, dict, dict, dict]:
    """(cell, config, traffic, limits) of a `workloads` entry of
    BENCHMARK.json; the limits of its comparison are
    `limits/<cell>.json`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, files[cell["config"]]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    return cell, config, traffic, limits


def driver_of(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by their whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def listed(entries: list, cell: str) -> list:
    """Names of the metric entries that this cell reports."""
    return [m["name"] for m in entries
            if "workloads" not in m or cell in m["workloads"]]


class Run:
    """What the metric readers read: the driver's kind and counts, the
    window's spans and units, and the traced slice (or None)."""

    def __init__(self, driver, spans, window, slice_):
        self.kind = driver.KIND
        self.spans = spans.times
        self.units = window["units"]
        self.unit_flops = driver.unit_flops()
        self.calls = driver.calls()
        self.slice = slice_


def run_cell(driver_mod, config: dict, traffic: dict, limits: dict,
             seed: int, seconds: float, trace: bool, device, t_start: float,
             e2e_names=None, layer_names=None) -> dict:
    """Set up, measure, check. Returns the result's fields (without
    `device`). `e2e_names` / `layer_names` select the metrics reported
    (None: every one that has a value)."""
    import torch

    from .spans import Spans
    from .trace import Tracer

    spans = Spans()
    tracer = Tracer(spans) if trace else None
    drv = driver_mod.Driver(config, traffic, seed, device, spans, limits)
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    spans.reset()
    window = drv.window(seconds, tracer)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    slice_ = tracer.slice if tracer is not None else None
    run = Run(drv, spans, window, slice_)
    metrics = {}
    if not trace:
        values = dict(window["metrics"], setup_s=(setup_s, "s"))
        for name, (value, unit) in values.items():
            if e2e_names is None or name in e2e_names:
                metrics[name] = {"value": value, "unit": unit}
    else:
        names = layer_names
        if names is None:
            names = sorted(f[:-3] for f in os.listdir(
                os.path.join(HERE, "metrics")) if f.endswith(".py"))
        for name in names:
            got = reader(name)(run)
            if got is not None:
                metrics[name] = {"value": got[0], "unit": got[1]}
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "memory_peak_bytes": memory_peak, "checks": checks,
              "readings": getattr(drv, "readings", None)}
    if slice_ is not None:
        result["busy_s"] = slice_.busy_s
        result["window_s"] = slice_.window_s
        gaps = sorted(slice_.gaps.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in slice_.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in gaps]}
    return result
