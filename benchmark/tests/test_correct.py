"""The comparison that decides `correct`, driven on the CPU at a small
size through a whole run of each kind of cell (the harness's look for a
card left out): the port against the reference reads as sound; the
control, the port's bf16 path one precision below the configuration's
fp32, and each fault the cell can have, planted in the port, read past
what sound runs read. The limits here are this size's; the cells' own are
set from readings on the card at their sizes (`benchmark.readings`)."""
from __future__ import annotations

import pytest
import torch

from benchmark.drivers import serve, train
from benchmark.readings import reading
from benchmark.tests import tiny

CPU = torch.device("cpu")
CONFIGS = ["reconvat-mel-fp32", "unetonset-mel-fp32"]
TRAIN_LIMITS = {"leaf_floor": 1e-3}


def serve_reading(name, seed, fault=None, bf16=False, batch=2, seconds=0.5):
    cfg = tiny.config(name)
    if bf16:
        cfg["compute_dtype"] = "bfloat16"
    # one pool batch: every batch the check samples is the same, so the
    # readings do not hang on how many batches the CPU finished
    traffic = dict(tiny.serve_traffic(), batch=batch, pool_batches=1)
    return reading(serve, cfg, traffic, {}, seed, seconds, CPU, fault)


def train_reading(name, seed, fault=None, bf16=False):
    cfg = tiny.config(name)
    if bf16:
        cfg["compute_dtype"] = "bfloat16"
    traffic = tiny.train_traffic()
    if name.startswith("unetonset"):
        traffic.update(labelled=2, pool_labelled=6)
    return reading(train, cfg, traffic, TRAIN_LIMITS, seed, 0.0, CPU, fault)


@pytest.mark.parametrize("name", CONFIGS)
def test_serving_sound_and_faults(name):
    sound = serve_reading(name, 11)
    assert sound["roll_gap"] < 1e-3 and sound["note_mismatch"] == 0
    for fault in ("altered", "half"):
        assert serve_reading(name, 11, fault, batch=4)["roll_gap"] > 0.1, \
            fault


@pytest.mark.parametrize("name", CONFIGS)
def test_serving_control_reads_past_sound(name):
    # bf16 puts some bins on the other side of 0.5 by a margin that fp32
    # rounding never reaches; a batch of 8 has enough bins near it
    # a window long enough to finish a bf16 batch on a CPU without bf16
    # units
    got = serve_reading(name, 12, bf16=True, batch=8, seconds=8.0)
    assert got["roll_gap"] > 1e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_training_sound_control_and_faults(name):
    sound = train_reading(name, 13)
    assert sound["loss_gap"] < 1e-4
    assert sound["step_gap"] < 0.5
    assert sound["ul_forward_gap"] < 1e-2
    assert sound["stats1_gap"] < 1e-4
    control = train_reading(name, 13, bf16=True)
    assert control["loss_gap"] > 1e-3
    assert control["ul_forward_gap"] > 0.1
    assert control["stats1_gap"] > 3e-4
    unchanged = train_reading(name, 13, "unchanged")
    assert unchanged["step_gap"] > 0.99


@pytest.mark.parametrize("name", CONFIGS)
def test_training_half_batch_fails(name):
    # the flagship keeps its one labelled row; its unlabelled chain's
    # rolls show the rows left out
    half = train_reading(name, 13, "half")
    assert half["ul_forward_gap"] > 1.0
