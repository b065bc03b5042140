"""Local windowed multi-head self-attention (PyTorch counterpart of
`reconvat_tpu/nn/attention.py`, reference `MutliHeadAttention1D`,
`model/self_attention.py:6-82`).

Window-W attention where K/V are projected from the zero-padded input, a
learned relative-position embedding `rel` enters as q.rel, and energies are
plain dot products (no 1/sqrt(d) scaling). The attention probabilities are
returned beside the output.

With `compute_dtype=torch.bfloat16` the projections run in bf16 (the JAX
package's `Dense(dtype=bfloat16)`), so q, k, v and the output are bf16;
`rel`, the softmax and the probabilities stay fp32.

The attention models' options (`reconvat_tpu/nn/attention.py:215-282`):
`position=False` has no `rel` (the kernel route is given a zero one, as
the JAX package's Pallas route is, and its gradient is dropped);
`use_bias` gives the three projections biases; `return_probs=False`
returns None in place of the probabilities.

Inside a sequence-parallel step (`parallel.mesh.sharded_step` with sp >
1) K/V are projected from this rank's frames with the (W - 1) / 2 frames
of each neighbouring rank (`parallel.mesh.time_halo`), so the attention
core (kernels or plain) runs as it does on the whole clip.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.banded_attention_kernel import BandedAttention, banded_attention
from ..parallel import mesh as pmesh
from .precision import cast

__all__ = ["banded_attention", "BandedAttention", "MultiHeadAttention1D"]


class MultiHeadAttention1D(nn.Module):
    """(B, L, in_features) -> (out (B, L, out_features),
    attention (B, L, groups, kernel_size)).

    `use_kernel` (default True) routes the attention core through
    `BandedAttention`, whose forward and backward are the CUDA kernels
    on a CUDA tensor and their plain versions on a CPU tensor; False runs
    the plain forward, differentiated by autograd, on any device."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int = 31, groups: int = 1,
                 compute_dtype=None, position: bool = True,
                 use_bias: bool = False, return_probs: bool = True):
        super().__init__()
        assert out_features % groups == 0
        assert (kernel_size - 1) % 2 == 0, "kernel size must be odd"
        self.out_features = out_features
        self.kernel_size = kernel_size
        self.groups = groups
        self.return_probs = return_probs
        self.W_k = nn.Linear(in_features, out_features, bias=use_bias)
        self.W_q = nn.Linear(in_features, out_features, bias=use_bias)
        self.W_v = nn.Linear(in_features, out_features, bias=use_bias)
        self.rel = (nn.Parameter(torch.empty(1, out_features, kernel_size))
                    if position else None)
        self.use_kernel = True
        self.compute_dtype = compute_dtype

    def forward(self, x):
        B, L, _ = x.shape
        H = self.groups
        Dh = self.out_features // H
        W = self.kernel_size
        hw = (W - 1) // 2
        # K/V from the zero-padded sequence (reference pads x before the
        # bias-free projections, `model/self_attention.py:44-47`); inside a
        # sequence-parallel step the pad rows between ranks are the
        # neighbouring ranks' frames, zeros only at the clip's ends
        x, wq, wk, wv, bq, bk, bv = cast(
            self.compute_dtype, x, self.W_q.weight, self.W_k.weight,
            self.W_v.weight, self.W_q.bias, self.W_k.bias, self.W_v.bias)
        xpad = pmesh.time_halo(x, hw, hw, pmesh.sp_context(), dim=1)
        q = F.linear(x, wq, bq).reshape(B, L, H, Dh)
        k = F.linear(xpad, wk, bk).reshape(B, L + 2 * hw, H, Dh)
        v = F.linear(xpad, wv, bv).reshape(B, L + 2 * hw, H, Dh)
        if self.rel is not None:
            rel = self.rel[0].reshape(H, Dh, W)
        elif self.use_kernel:
            rel = torch.zeros((H, Dh, W), device=x.device,
                              dtype=torch.promote_types(x.dtype,
                                                        torch.float32))
        else:
            rel = None
        fn = BandedAttention.apply if self.use_kernel else banded_attention
        out, probs = fn(q, k, v, rel, W)
        return (out.reshape(B, L, self.out_features),
                probs if self.return_probs else None)

