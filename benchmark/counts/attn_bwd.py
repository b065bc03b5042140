"""The banded attention backward (`banded_attention_bwd`, both passes,
one call per attention layer that the backward crosses): the gradients of
q, kpad, vpad and rel, as `chip_smoke.py` phase 3c counts them; q, kpad,
vpad, rel and d_out read once, dq, dkpad, dvpad, drel written once."""
from __future__ import annotations


def attn_bwd(batch: int, length: int, heads: int, head_dim: int,
             window: int = 31, elem: int = 4):
    flops = batch * length * heads * window * (15 * head_dim + 10)
    blhd = batch * length * heads * head_dim
    pad = batch * (length + window - 1) * heads * head_dim
    rel = heads * head_dim * window
    nbytes = elem * (3 * blhd + 4 * pad + 2 * rel)
    return flops, nbytes
