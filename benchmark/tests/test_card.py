"""A run of each cell on the card, as the check runs it, short: exit code
0, the last line's form, `correct` true. Skips without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]


def test_no_card_no_result(monkeypatch, capsys):
    """Without a card the harness exits with another code than 0 and
    prints no result."""
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", BENCH["workloads"][0]["name"],
                     "--seed", "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""
