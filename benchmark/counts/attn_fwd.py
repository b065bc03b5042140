"""The banded attention forward (`banded_attention_fwd`, one call per
attention layer and pass): q.k and q.rel over the window, softmax, p.v,
as `chip_smoke.py` phase 3 counts it; q, kpad, vpad, rel read once, out
and the probabilities written once, 4 bytes an element (fp32)."""
from __future__ import annotations


def attn_fwd(batch: int, length: int, heads: int, head_dim: int,
             window: int = 31, elem: int = 4):
    flops = batch * length * heads * window * (3 * 2 * head_dim + 5)
    blhd = batch * length * heads * head_dim
    pad = batch * (length + window - 1) * heads * head_dim
    nbytes = elem * (2 * blhd + 2 * pad + heads * head_dim * window
                     + batch * length * heads * window)
    return flops, nbytes
