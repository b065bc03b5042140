"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It builds the program's kernels into `build/` of the checkout (the
first run of a cell there), sets the cell up from the seed, measures for
`--seconds`, checks what the measured window produced against the plain
reference under `benchmark/reference/`, and prints one JSON line last on
standard output: the end-to-end metrics with `--trace 0`, the per-layer
metrics with `--trace 1`. It exits with another code than 0, and prints
no result, when there is no card or too few, or when JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .harness import (ROOT, forbidden_modules, listed, load_cell,  # noqa: E402
                      load_json, log, run_cell, driver_of)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def result_line(result: dict, kind: str, count: int, trace: bool) -> dict:
    """The last line of standard output: `correct`, `attempted`, `failed`,
    `metrics`, `device`, with a trace `breakdown`, and last the numbers
    compared beside their limits (`checks`)."""
    dev = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": result["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = result["busy_s"]
        dev["window_s"] = result["window_s"]
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": dev}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, limits = load_cell(args.workload, bench)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and does not "
            "fall back to the CPU")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{cell['name']} needs {cell['chips']} cards, found "
            f"{torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    result = run_cell(
        driver_of(traffic["kind"]), config, traffic, limits, args.seed,
        args.seconds, bool(args.trace), device, T_START,
        e2e_names=listed(bench["end_to_end"], cell["name"]),
        layer_names=listed(bench["per_layer"], cell["name"]))
    found = forbidden_modules()
    if found:
        log(f"loaded in this process, which the benchmark forbids: {found}")
        return 3
    log(f"peak GB {result['memory_peak_bytes'] / 1e9}; attempted "
        f"{result['attempted']}, failed {result['failed']}")
    if args.trace and "busy_s" not in result:
        log("the profiler recorded no device operation in the traced slice")
        return 4
    line = result_line(result, torch.cuda.get_device_name(device),
                       cell["chips"], bool(args.trace))
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
