"""Model FLOPs of one pass of the transcriber or the reconstructor,
counted from shapes by running the plain reference on the meta device
(no data, no kernel) and adding up every convolution, transposed
convolution, projection and attention band it computes:

    conv2d            2 x output elements x C_in / groups x kh x kw
    conv_transpose2d  2 x input elements x C_out x kh x kw
    matmul (x @ W^T)  2 x M x N x K
    einsum (the band) 2 x the product of the sizes of every index

Elementwise work (activations, BatchNorm, softmax) is not counted. The
mel frontend is counted by `counts/mel.py`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


class _Count(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is F.conv2d:
            w = args[1]
            self.flops += 2 * out.numel() * w[0].numel()
        elif func is F.conv_transpose2d:
            x, w = args[0], args[1]
            self.flops += 2 * x.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        elif getattr(func, "__name__", "") in ("matmul", "__matmul__"):
            a, b = args[0], args[1]
            self.flops += 2 * a.numel() * b.shape[-1]
        elif func is torch.einsum:
            eq, ops = args[0], args[1:]
            sizes = {}
            for sub, t in zip(eq.split("->")[0].split(","), ops):
                sizes.update(zip(sub, t.shape))
            self.flops += 2 * math.prod(sizes.values())
        return out


def pass_flops(ref_model, params: dict, stats: dict, batch: int,
               frames: int, n_bins: int = 229) -> dict:
    """{"transcriber": flops, "reconstructor": flops} of one forward of
    each at (batch, frames); `params` and `stats` are only read for their
    shapes."""
    meta = {k: torch.empty(v.shape, device="meta") for k, v in params.items()}
    mstats = {k: torch.empty(v.shape, device="meta")
              for k, v in stats.items()}
    spec = torch.empty((batch, frames, n_bins, 1), device="meta")
    roll = torch.empty((batch, frames, 88), device="meta")
    counts = {}
    with torch.no_grad():
        with _Count() as c:
            ref_model.transcriber(spec, meta, mstats, "eval")
        counts["transcriber"] = c.flops
        with _Count() as c:
            ref_model.reconstructor(roll, meta, mstats, "eval")
        counts["reconstructor"] = c.flops
    return counts
