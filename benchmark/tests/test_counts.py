"""The byte and FLOP counts against hand counts at small shapes."""
from __future__ import annotations

import math

import pytest
import torch

from benchmark.counts.attn_bwd import attn_bwd
from benchmark.counts.attn_fwd import attn_fwd
from benchmark.counts.mel import mel
from benchmark.counts.model import _Count, pass_flops
from benchmark.peaks import HBM_BYTES, TF32_FLOPS, bound_s
from benchmark.reference.model import ReconVATRef, UNetOnsetRef


def test_attention_forward_by_hand():
    # B=1, L=2, H=1, D=2, W=3: per (row, head) 3 window entries, each a
    # q.k (2 mul-adds), q.rel (2) and p.v (2) over D=2 and 5 for softmax
    flops, nbytes = attn_fwd(1, 2, 1, 2, 3)
    assert flops == 2 * 3 * (3 * 2 * 2 + 5)
    # q 4, kpad 8, vpad 8, rel 6, out 4, probs 6 elements of 4 bytes
    assert nbytes == 4 * (4 + 8 + 8 + 6 + 4 + 6)


def test_attention_backward_by_hand():
    flops, nbytes = attn_bwd(1, 2, 1, 2, 3)
    assert flops == 2 * 3 * (15 * 2 + 10)
    # read q, kpad, vpad, rel, d_out; write dq, dkpad, dvpad, drel
    assert nbytes == 4 * ((4 + 8 + 8 + 6 + 4) + (4 + 8 + 8 + 6))


def test_attention_at_the_kernel_table_shape():
    # PERF.md's kernel table, rows 2 and 3: 79.5 MB and 135.1 MB
    assert attn_fwd(8, 640, 4, 229)[1] / 1e6 == pytest.approx(79.45, abs=0.01)
    assert attn_bwd(8, 640, 4, 229)[1] / 1e6 == pytest.approx(135.06,
                                                              abs=0.01)


def test_mel_by_hand():
    # 2 clips of 1025 samples: the chain drops one, 1024 // 512 + 1 = 3
    # frames; 1.25 n log2 n + 2 x nonzeros each
    flops, nbytes = mel(2, 1025, n_fft=2048, hop=512, n_mels=229,
                        basis_nonzeros=10)
    assert flops == 2 * 3 * (1.25 * 2048 * 11 + 20)
    assert nbytes == 4 * (2 * 1024 + 2048 + 1025 * 229 + 2 * 3 * 229)


def test_bound_takes_the_larger():
    assert bound_s(TF32_FLOPS, 0) == pytest.approx(1.0)
    assert bound_s(0, HBM_BYTES) == pytest.approx(1.0)
    assert bound_s(TF32_FLOPS, 2 * HBM_BYTES) == pytest.approx(2.0)


def test_count_mode_by_hand():
    x = torch.empty((1, 2, 5, 7), device="meta")
    w = torch.empty((3, 2, 3, 3), device="meta")
    with _Count() as c:
        torch.nn.functional.conv2d(x, w, None, 1, 1)
    assert c.flops == 2 * (3 * 5 * 7) * (2 * 3 * 3)
    with _Count() as c:
        torch.nn.functional.conv_transpose2d(x, w.transpose(0, 1))
    assert c.flops == 2 * x.numel() * 3 * 3 * 3
    a, b = torch.empty((4, 6), device="meta"), torch.empty((6, 5),
                                                          device="meta")
    with _Count() as c:
        a @ b
    assert c.flops == 2 * 4 * 6 * 5
    with _Count() as c:
        torch.einsum("blhd,blhdw->blhw", torch.empty((1, 2, 3, 4), device="meta"),
                     torch.empty((1, 2, 3, 4, 5), device="meta"))
    assert c.flops == 2 * math.prod((1, 2, 3, 4, 5))


@pytest.mark.parametrize("name", ["reconvat-mel-fp32",
                                  "unetonset-mel-fp32"])
def test_pass_flops_scale_with_rows_and_frames(name):
    from benchmark import models
    from benchmark.tests import tiny

    cfg = tiny.config(name)
    ref = {"reconvat": ReconVATRef, "unetonset": UNetOnsetRef}[
        cfg["reference"]]()
    p, s = models.split_state(models.build(cfg, torch.device("cpu")))
    one = pass_flops(ref, p, s, 1, 64)
    two = pass_flops(ref, p, s, 2, 64)
    assert two["transcriber"] == 2 * one["transcriber"]
    assert two["reconstructor"] == 2 * one["reconstructor"]
    # the attention band alone: 3 products of 2 x D x W per (row, head)
    att = ref.heads["transcriber"]
    assert one["transcriber"] > 3 * 2 * 64 * att * 31
