"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W limit). fp32 operands are held to the dense TF32 rate, not to the
67 TFLOP/s of the CUDA cores: no fp32-accurate kernel multiplies faster
than the tensor cores do in TF32 (3xTF32 runs on them), so no share of it
can pass 100 %."""
from __future__ import annotations

TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = TF32_FLOPS):
    """Least seconds the card could take for this work."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
