"""The fp32 first pass of the attention backward against two variants of
its 3xTF32 arithmetic, on the card.

    python -m reconvat_tpu_torch.kernels.bwd_variants

Writes copies of `csrc/banded_attention_bwd.cu` (with the header it
includes, `csrc/mma_tiles.cuh`) in which `bwd_partials_tf32x3_kernel`
rounds to TF32 by `cvt.rna.tf32.f32` instead
of integer ops ("cvt"), or chains its three mmas per depth-8 step into
one accumulator instead of summing each step from zero ("one
accumulator"), builds each with the port's nvcc flags into
`build/kernels/`, and runs the kernel and each copy at the training shape
(B=8, L=640, H=4, Dh=229, W=31; `chip_smoke.attention_inputs`). Prints the
card, whether each copy's outputs equal the kernel's bit for bit, each
one's largest and rms error against the float64 first pass over
max|truth| beside the fp32 plain version's, and the times in turns
(kernel, copy, copy, kernel; L2 flushed before each launch). Needs one
CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from . import _build
from .bwd_phases import event_ms

ENTRY = "banded_attention_bwd_partials_launch"
# name -> (text in the kernel's source, its replacement)
VARIANTS = {
    "cvt": ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
            "  unsigned r;\n"
            "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
            "  return r;"),
    "one accumulator": (
        "      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, "
        "0.f, 0.f};\n"
        "      mma_1688(big, ab, bb[n][0], bb[n][1]);\n"
        "      mma_1688(small, as, bb[n][0], bb[n][1]);\n"
        "      mma_1688(small, ab, bs[n][0], bs[n][1]);\n"
        "#pragma unroll\n"
        "      for (int i = 0; i < 4; ++i) acc[n][i] += big[i] + small[i];",
        "      mma_1688(acc[n], as, bb[n][0], bb[n][1]);\n"
        "      mma_1688(acc[n], ab, bs[n][0], bs[n][1]);\n"
        "      mma_1688(acc[n], ab, bb[n][0], bb[n][1]);"),
}


def build_variant(name: str) -> ctypes.CDLL:
    src = _build.expanded_source("banded_attention_bwd")
    old, new = VARIANTS[name]
    if src.count(old) != 1:
        raise RuntimeError(f"variant {name!r}: its text is not in the "
                           f"kernel's source once")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    stem = "banded_attention_bwd_" + name.replace(" ", "_")
    cu = os.path.join(_build.BUILD_DIR, f"{stem}.cu")
    so = os.path.join(_build.BUILD_DIR, f"lib{stem}.so")
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    subprocess.run(_build.nvcc_command(cu, so), check=True)
    lib = ctypes.CDLL(so)
    fn = getattr(lib, ENTRY)
    fn.argtypes = _build.ENTRY_POINTS["banded_attention_bwd"][ENTRY]
    fn.restype = ctypes.c_int
    return lib


def main() -> None:
    import sys

    from ..ops import banded_attention_kernel as bak

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from chip_smoke import attention_inputs, nvidia_smi

    torch.backends.cuda.matmul.allow_tf32 = False
    q, kpad, vpad, rel, d_out = attention_inputs()
    B, L, H, D = q.shape
    W = rel.shape[2]
    args = (q, kpad, vpad, rel, d_out, W)
    truth = bak.banded_attention_bwd_partials_plain(
        *(t.double() for t in args[:5]), W)
    plain = bak.banded_attention_bwd_partials_plain(*args)
    names = ("dq", "dk_part", "dv_part", "drel_part")

    def errors(got):
        out = {}
        for name, a, t in zip(names, got, truth):
            top = t.abs().max().item()
            d = a.double() - t
            out[name] = (d.abs().max().item() / top,
                         d.pow(2).mean().sqrt().item() / top)
        return out

    def kernel():
        return bak.banded_attention_bwd_partials(*args)

    ref = [t.clone() for t in kernel()]
    torch.cuda.synchronize()
    print(f"{nvidia_smi()}; fp32 first pass (B={B}, L={L}, H={H}, Dh={D}, "
          f"W={W})")
    print("largest and rms error against float64 over max|truth|: fp32 "
          f"plain {errors(plain)}; kernel {errors(ref)}")
    n = -(-L // bak.BWD_TILE)
    outs = (torch.empty_like(q),
            torch.empty((B, H, n, bak.BWD_TILE + W - 1, D), device="cuda"),
            torch.empty((B, H, n, bak.BWD_TILE + W - 1, D), device="cuda"),
            torch.empty((B, H, n, D, W), device="cuda"))
    for name in VARIANTS:
        launch = getattr(build_variant(name), ENTRY)

        def variant():
            err = launch(
                *(t.data_ptr() for t in (q, kpad, vpad, rel, d_out) + outs),
                B, L, H, D, W, bak.BWD_TILE,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            _build.check(err, f"{name} banded_attention_bwd_partials")
            return outs

        got = [t.clone() for t in variant()]
        torch.cuda.synchronize()
        times = [event_ms(kernel if i in (0, 3) else variant)
                 for i in range(4)]
        print(f"{name}: bit for bit the kernel's "
              f"{[torch.equal(a, b) for a, b in zip(got, ref)]}; errors "
              f"{errors(got)}; ms in turns (kernel, {name}, {name}, "
              f"kernel) {times}")


if __name__ == "__main__":
    main()
