"""Phase times of the tensor-core attention kernels on the card: the first
passes of the backward and the forward.

    python -m reconvat_tpu_torch.kernels.bwd_phases [fp32|bf16|fwd_fp32|fwd_bf16 ...]

For each kernel asked for (all four by default: `bwd_partials_tf32x3_kernel`
and `bwd_partials_mma_kernel` of `csrc/banded_attention_bwd.cu`,
`banded_attention_fwd_tf32x3_kernel` and `banded_attention_fwd_mma_kernel`
of `csrc/banded_attention.cu`), writes a copy of its source (headers
inlined) in which thread 0 of each block reads the global timer at the
kernel's start, after each of its block barriers and at its end, builds it
with the port's nvcc flags into `build/kernels/`, and runs it at the
training shape (B=8, L=640, H=4, Dh=229, W=31; random inputs from seed 0).
Prints the card, the time per block of each phase (mean and 90th
percentile) and the kernel's time by CUDA events (L2 flushed before each
launch), the stamped copy's beside the unstamped kernel's, in turns.
Phases: the backward's staging, scores, band and gradients (with their
stores); the forward's staging, scores, band (the softmax, and V's wait
or store), and PV with the stores of out. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from . import _build

MAX_BLOCKS = 4096
BWD_PHASES = ("staging", "scores", "band", "gradients")
FWD_PHASES = ("staging", "scores", "band", "pv_store")
# name -> (source, the kernel's signature start, its C entry point, phases)
KERNELS = {
    "fp32": ("banded_attention_bwd", "bwd_partials_tf32x3_kernel(const float*",
             "banded_attention_bwd_partials_launch", BWD_PHASES),
    "bf16": ("banded_attention_bwd", "bwd_partials_mma_kernel(const bf16*",
             "banded_attention_bwd_partials_bf16_launch", BWD_PHASES),
    "fwd_fp32": ("banded_attention", "banded_attention_fwd_tf32x3_kernel(\n",
                 "banded_attention_fwd_launch", FWD_PHASES),
    "fwd_bf16": ("banded_attention", "banded_attention_fwd_mma_kernel(\n",
                 "banded_attention_fwd_bf16_launch", FWD_PHASES)}

_STAMP = ("  if (threadIdx.x == 0) stamps[(blockIdx.y * gridDim.x + blockIdx.x)"
          " * 8 + {k}] = global_ns();\n")
_HEADER = f"""
__device__ unsigned long long stamps[8 * {MAX_BLOCKS}];
__device__ __forceinline__ unsigned long long global_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
"""
_READ = """
extern "C" int read_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, stamps, sizeof(*out) * n);
}
"""


def stamped_source(kernel: str) -> str:
    """The kernel's source with the phase stamps in `kernel`."""
    source, signature, _, phases = KERNELS[kernel]
    src = _build.expanded_source(source)
    start = src.index(signature)
    end = src.index("\n}\n", start) + 3      # past the closing brace
    body = src[start:end]
    head, *rest = body.split("  __syncthreads();\n")
    if len(rest) != len(phases) - 1:
        raise RuntimeError(f"expected {len(phases) - 1} block barriers in "
                           f"{kernel}, found {len(rest)}")
    brace = head.index("{\n") + 2
    body = head[:brace] + _STAMP.format(k=0) + head[brace:]
    for k, part in enumerate(rest, 1):
        body += "  __syncthreads();\n" + _STAMP.format(k=k) + part
    body = (body[:-2] + "  __syncthreads();\n"
            + _STAMP.format(k=len(phases)) + "}\n")
    decl = src.rindex("__global__", 0, start)
    return (src[:decl] + _HEADER + src[decl:start] + body + src[end:]
            + _READ)


def build_stamped(kernel: str) -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    source, _, entry, _ = KERNELS[kernel]
    name = f"{source}_stamped_{kernel}"
    cu = os.path.join(_build.BUILD_DIR, f"{name}.cu")
    so = os.path.join(_build.BUILD_DIR, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(stamped_source(kernel))
    subprocess.run(_build.nvcc_command(cu, so), check=True)
    lib = ctypes.CDLL(so)
    getattr(lib, entry).argtypes = _build.ENTRY_POINTS[source][entry]
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for fn in (getattr(lib, entry), lib.read_stamps):
        fn.restype = ctypes.c_int
    return lib


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        for _ in range(8):
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def run(kernel: str, card: str) -> None:
    from ..ops import banded_attention_kernel as bak

    _, _, entry, phases = KERNELS[kernel]
    B, L, H, D, W = 8, 640, 4, 229, 31
    g = torch.Generator(device="cuda").manual_seed(0)
    op = torch.bfloat16 if kernel.endswith("bf16") else torch.float32

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=g) * scale)

    q = randn(B, L, H, D, scale=D ** -0.25).to(op)
    kpad = randn(B, L + W - 1, H, D, scale=D ** -0.25).to(op)
    vpad = randn(B, L + W - 1, H, D).to(op)
    rel = randn(H, D, W, scale=0.1)
    d_out = randn(B, L, H, D).to(op)
    n = -(-L // bak.BWD_TILE)
    blocks = n * B * H
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{blocks} blocks, the stamps hold {MAX_BLOCKS}")
    if kernel.startswith("fwd"):
        ins, tile = (q, kpad, vpad, rel), ()
        outs = (torch.empty_like(q),
                torch.empty((B, L, H, W), device="cuda"))

        def wrapper():
            bak.banded_attention_fwd(q, kpad, vpad, rel, W)
    else:
        ins, tile = (q, kpad, vpad, rel, d_out), (bak.BWD_TILE,)
        outs = (torch.empty_like(q),
                torch.empty((B, H, n, bak.BWD_TILE + W - 1, D), device="cuda"),
                torch.empty((B, H, n, bak.BWD_TILE + W - 1, D), device="cuda"),
                torch.empty((B, H, n, D, W), device="cuda"))

        def wrapper():
            bak.banded_attention_bwd_partials(q, kpad, vpad, rel, d_out, W)
    lib = build_stamped(kernel)
    launch = getattr(lib, entry)

    def stamped():
        err = launch(*(t.data_ptr() for t in ins + outs), B, L, H, D, W,
                     *tile,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(err, f"stamped {kernel}")

    times = {"stamped": [], "kernel": []}
    for name in ("stamped", "kernel", "kernel", "stamped"):
        times[name].append(event_ms(stamped if name == "stamped"
                                    else wrapper))
    stamped()
    torch.cuda.synchronize()
    ns = np.zeros(8 * MAX_BLOCKS, np.uint64)
    _build.check(lib.read_stamps(ns.ctypes.data, ns.size), "read_stamps")
    ns = ns[:8 * blocks].reshape(blocks, 8)[:, :len(phases) + 1]
    per_phase = np.diff(ns.astype(np.int64), axis=1)
    print(f"{card}; {kernel} (B={B}, L={L}, H={H}, Dh={D}, W={W}), "
          f"{blocks} blocks")
    print(f"ms in turns (stamped, kernel, kernel, stamped): {times}")
    print("ns per block, mean:",
          dict(zip(phases, per_phase.mean(0).tolist())),
          "total", per_phase.sum(1).mean())
    print("ns per block, 90th percentile:",
          dict(zip(phases, np.percentile(per_phase, 90, axis=0).tolist())))
    print("first start to last end, ms:",
          (int(ns[:, -1].max()) - int(ns[:, 0].min())) / 1e6)


def main(kernels=None) -> None:
    kernels = kernels or list(KERNELS)
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        raise SystemExit(f"unknown kernel {sorted(unknown)}: "
                         f"{sorted(KERNELS)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    for kernel in kernels:
        run(kernel, card)


if __name__ == "__main__":
    main(sys.argv[1:])
