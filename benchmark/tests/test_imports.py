"""What the harness loads: neither JAX nor the JAX package (top-level
module names compared whole: `reconvat_tpu_torch` begins with
`reconvat_tpu`), through a whole run of a cell on the CPU; and nothing of
the program in the reference."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import harness

RUN = """
import json, sys, time, torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.drivers import serve, train
from benchmark.tests import tiny
for drv, traffic, limits in (
        (serve, tiny.serve_traffic(), {"roll_gap": 1.0}),
        (train, tiny.train_traffic(), {"leaf_floor": 1e-3, "loss_gap": 1,
                                       "grad_gap": 1, "step_gap": 1,
                                       "stats_gap": 1})):
    harness.run_cell(drv, tiny.config("reconvat-mel-fp32"), traffic, limits,
                     3, 0.5, False, torch.device("cpu"), time.time())
import benchmark.run, benchmark.readings
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import benchmark.reference.model, benchmark.reference.train
import benchmark.reference.decode
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    loaded = top_level(RUN)
    assert "reconvat_tpu_torch" in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = top_level(REFERENCE)
    assert not set(loaded) & ({"reconvat_tpu_torch"}
                              | set(harness.FORBIDDEN))
