"""Cells cut to a size the CPU runs in seconds, for the tests: the
published widths (229 bins, U-Net 16-128, the attention heads), 64-frame
clips, batches of 2 to 3."""
from __future__ import annotations

import copy

from benchmark import harness

SAMPLES = 64 * 512


def config(name: str) -> dict:
    cfg = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    cfg = copy.deepcopy(cfg)
    cfg["train"]["iteration"] = 2
    return cfg


def serve_traffic() -> dict:
    return dict(harness.load_json(f"{harness.HERE}/traffic/serve-b64.json"),
                batch=2, samples=SAMPLES, pool_clips=4, pool_batches=2,
                warm_batches=1, probe_clips=2, check_batches=2,
                trace_batches=2)


def train_traffic() -> dict:
    return dict(harness.load_json(
        f"{harness.HERE}/traffic/train-vat-16x16.json"), labelled=1,
        unlabelled=2, samples=SAMPLES, pool_labelled=3, pool_unlabelled=6,
        warm_steps=0)
