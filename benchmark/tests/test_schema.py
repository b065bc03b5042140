"""BENCHMARK.json against the contract's form, every file it names found
by name, and the last line's schema."""
from __future__ import annotations

import json
import os
import re

from benchmark import harness
from benchmark.run import result_line

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"])
            names.add(e["name"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_named_file_is_found():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell, config, traffic, limits = harness.load_cell(w["name"], BENCH)
        assert config["name"] == w["config"]
        assert os.path.exists(os.path.join(
            harness.HERE, "drivers", traffic["kind"] + ".py"))
        assert limits
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in e2e
        # every cell a layer metric lists reports the metric it moves
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")


def test_roofline_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^\w+_roofline(\.\w+)?$", m["name"])
            assert m["unit"] == "%"


def test_last_line_schema():
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"x": {"value": 1.5, "unit": "ms"}},
              "memory_peak_bytes": 7, "busy_s": 0.5, "window_s": 1.0,
              "breakdown": {"device_ops": [["k", 0.1]],
                            "idle_gaps": [["serve.decode", 0.2]]},
              "checks": {"roll_gap": {"value": 0.0, "limit": 1.0}}}
    line = result_line(result, "NVIDIA H100 80GB HBM3", 1, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 7, "busy_s": 0.5,
                              "window_s": 1.0}
    plain = result_line(dict(result, breakdown=None), "card", 1, False)
    assert "busy_s" not in plain["device"]
    json.dumps(line)
