"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py

The kernel tests carry the `cuda` marker and skip without a CUDA device;
the wrapper-argument checks run anywhere.

Tolerances: mel power rtol 1e-4 (atol 1e-6), attention out and probs
atol 1e-5 (rtol 1e-4): fp32 on both sides, different summation orders.
The mel kernel is also held to float64: its largest error against
`mel_power_plain` in float64 may be at most 1.5x that of `mel_power_plain`
in fp32 (on a clip with near-empty mel bins no relative bound applies).
Attention gradients: each divided by its largest magnitude, then atol 1e-5
(rtol 1e-4): fp32 on both sides; dk and dv add up to 31 terms per row in
another order, drel sums over every (batch, row) of a head.
bf16 attention (q, kpad, vpad, out bf16; rel, probs fp32): probs atol 1e-5
(fp32 on both sides); out within 2**-7 |ref| + 1e-3 max |ref|, one bf16 ulp
of a value rounded from fp32 sums taken in another order, plus a p that
rounds to bf16 the other way; and at most 1 % of the out elements may
differ at all: sums in another order round the other way for ~1e-4 of
them, a kernel that skips the rounding of p for ~40 %.
bf16 attention backward (q, kpad, vpad, d_out, dq, dk, dv bf16; rel, drel
and the first pass's partials fp32): the kernel, and the bf16 plain
version beside it, against the float64 sums with the Pallas kernel's
rounding points (`_bwd_float64(..., round_p=True, round_ds=True)`). dq,
dk and dv by the rule of bf16 out above. Every side rounds dS and p to
bf16 before their products; where two sides' dS lie on either side of a
bf16 rounding boundary, one term of a sum moves by a bf16 ulp of dS. The
partials are fp32 sums over at most 32 rows: each within 2**-7 of its max
|ref| everywhere, and at most 1 % of its elements further than 1e-5 of
max |ref| (the fp32 gradients' atol) from it; another order moves ~0.03 %
of them that far, by up to ~8e-4 of max |ref|, while a backward that skips
the rounding of dS (or p) moves 80-93 %. drel sums over all B x L rows of
a head, so such moves fall in most of its columns (1.5 % of its elements
beyond 1e-5 at B=8 x 640): it is held to 5e-4 of its max |ref| instead,
where another order reads up to 2.3e-4 (B=2 x 640) and 6e-5 (B=8 x 640)
and a missing rounding of dS 1.6e-3. Those fixed bounds were measured at
B=2..8 x 640 frames; with few rows summed one flipped dS weighs more
against max |ref| (at 2 x 33 rows it moves drel by 1.2e-3 of it), so each
element's magnitude bound also takes one flip of the largest term summed
into it, 2**-7 x max |dS x| (max |p dO| for dv; `_one_flip`). The share
bounds take none of it, and they still see a missing rounding at every
size (`test_bf16_bwd_rule_sees_unrounded_ds_and_p`, and `..._at_ragged_tile`).
fp32 attention forward on the 3xTF32 tensor cores: against the plain
version and its tile-by-tile model at ATTN_TOL, and against the float64
forward within TF32X3_TRUTH_FACTOR of the plain version's error (below);
the bf16 forward against its tile model by the bf16 rules above.
fp32 attention backward on the 3xTF32 tensor cores: its first pass against
the plain version and against its tile-by-tile model at GRAD_TOL; against
the float64 backward, each output's largest error over max |truth| at
most TF32X3_TRUTH_FACTOR times the fp32 plain version's. Each operand is
split into two TF32 values and the small x small product dropped, so a
product keeps about 2**-22 of relative error (four fp32 ulps) where fp32
keeps 2**-24, and a sum of such products may land up to a few times
further from float64 than the plain version's; on the card the kernel
reads at most 1.17x (`chip_smoke.py` phase 3b).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reconvat_tpu_torch.kernels import _build
from reconvat_tpu_torch.ops import banded_attention_kernel as bak
from reconvat_tpu_torch.ops import mel_kernel
from reconvat_tpu_torch.ops.spectrogram import make_frontend

MEL_TOL = dict(rtol=1e-4, atol=1e-6)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)   # on gradients over their max |.|
BF16_OUT_MOVED = 1e-2     # share of bf16 out elements that may differ
TF32X3_TRUTH_FACTOR = 4.0  # 3xTF32 vs fp32 plain, distance to float64
BF16_DREL_RTOL = 5e-4     # bf16 backward's drel, over its max |ref|
BF16_BWD_NAMES = ("dq", "dk", "dv", "drel")
BF16_PART_NAMES = ("dq", "dk_part", "dv_part", "drel_part")


def _assert_bf16_out_close(out, ref_out):
    got, ref = out.float(), ref_out.float()
    err = (got - ref).abs()
    assert (err <= 2 ** -7 * ref.abs() + 1e-3 * ref.abs().max()).all(), \
        err.max()
    assert (err > 0).float().mean().item() <= BF16_OUT_MOVED


def _bf16_bwd_misses(got, ref, names, flips=None):
    """The outputs of a bf16-operand backward that break the module
    docstring's rule, by name: bf16 outputs (dq, dk, dv) by the rule of
    bf16 out, drel by BF16_DREL_RTOL, the fp32 partials by the share
    rule. `flips` (from `_one_flip`), where given, widens each element's
    magnitude bound by one bf16 flip of the largest term summed into it;
    the share bounds take no part of it."""
    missed = []
    flips = flips if flips is not None else (0.0,) * len(names)
    for name, a, b, flip in zip(names, got, ref, flips):
        assert a.dtype == b.dtype, name
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        err, top = (a - b).abs(), b.abs().max()
        if bf16:
            within = err <= 2 ** -7 * b.abs() + 1e-3 * top + flip
            moved = err > 0
        elif name == "drel":
            within = err <= BF16_DREL_RTOL * top + flip
            moved = torch.zeros(())
        else:
            within = err <= 2 ** -7 * top + flip
            moved = err > 1e-5 * top
        if not (torch.isfinite(a).all() and within.all()
                and moved.float().mean().item() <= BF16_OUT_MOVED):
            missed.append(name)
    return missed


def _assert_grads_close(got, ref, names=("dq", "dk", "dv", "drel")):
    for name, a, b in zip(names, got, ref):
        scale = max(b.abs().max().item(), 1e-30)
        torch.testing.assert_close(a / scale, b / scale, **GRAD_TOL,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attn_inputs(L, window, Dh, B=2, H=4, seed=4):
    g = torch.Generator().manual_seed(seed)
    hw = (window - 1) // 2
    q = torch.randn((B, L, H, Dh), generator=g) * Dh ** -0.25
    k = torch.randn((B, L, H, Dh), generator=g) * Dh ** -0.25
    v = torch.randn((B, L, H, Dh), generator=g)
    rel = torch.randn((H, Dh, window), generator=g) * 0.1
    pad = (0, 0, 0, 0, hw, window - 1 - hw)    # L + window - 1 rows
    return q, F.pad(k, pad), F.pad(v, pad), rel


@pytest.mark.parametrize("name,shape,bad", [
    ("dtype", (2, 3), torch.zeros((2, 3), dtype=torch.float64)),
    ("shape", (2, 3), torch.zeros((3, 2))),
    ("contiguous", (2, 3), torch.zeros((3, 2)).t()),
])
def test_check_tensor_rejects(name, shape, bad):
    with pytest.raises((TypeError, ValueError)):
        _build.check_tensor(name, bad, shape, torch.device("cpu"))
    _build.check_tensor(name, torch.zeros(shape), shape, torch.device("cpu"))


def test_lib_path_hashes_the_headers(tmp_path, monkeypatch):
    """A library is named by its source and by every header of `csrc/`:
    an edited header alone gives another name, so a build that includes
    it is not loaded stale; the headers are inlined by `expanded_source`."""
    (tmp_path / "k.cu").write_text('#include "t.cuh"\nint k;\n')
    header = tmp_path / "t.cuh"
    header.write_text("#pragma once\nint t;\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    assert _build.expanded_source("k") == "int t;\n\nint k;\n"
    header.write_text("#pragma once\nint t = 1;\n")
    assert _build._lib_path("k") != first
    assert (tmp_path / "k.cu").read_text() == '#include "t.cuh"\nint k;\n'


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64 * 512 - 1, 10000])   # 64 frames, ragged 20
def test_mel_kernel_matches_plain(cuda_device, n):
    fe, _ = make_frontend("Mel")
    fe = fe.to(cuda_device)
    x = torch.from_numpy((np.random.RandomState(6).randn(3, n)
                          * 0.1).astype(np.float32)).to(cuda_device)
    args = (fe.stft.wcos, fe.stft.wsin, fe.mel_basis, 512)
    before = mel_kernel.mel_power.launches
    got = mel_kernel.mel_power(x, *args, fe.stft.window, fe.twiddle, fe.band)
    torch.cuda.synchronize()
    assert mel_kernel.mel_power.launches == before + 1
    ref = mel_kernel.mel_power_plain(x, *args)
    torch.testing.assert_close(got, ref, **MEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64 * 512 - 1, 10000])
def test_mel_kernel_matches_fft_model(cuda_device, n):
    """The kernel against the step-by-step PyTorch model of its arithmetic
    (same passes, same twiddle table, same banded mel sum)."""
    fe, _ = make_frontend("Mel")
    fe = fe.to(cuda_device)
    x = torch.from_numpy((np.random.RandomState(7).randn(3, n)
                          * 0.1).astype(np.float32)).to(cuda_device)
    got = fe(x)
    torch.cuda.synchronize()
    ref = mel_kernel.mel_power_fft_plain(x, fe.stft.window, fe.mel_basis, 512)
    torch.testing.assert_close(got, ref, **MEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["noise", "tonal"])
def test_mel_kernel_against_float64(cuda_device, clip):
    """float64 `mel_power_plain` is the truth; the kernel may be no further
    from it than fp32 `mel_power_plain` is (x1.5). The tonal clip is a
    440 Hz sine at 0.1 whose second half is silent."""
    fe, _ = make_frontend("Mel")
    fe = fe.to(cuda_device)
    n = 64 * 512 - 1
    if clip == "noise":
        x = np.random.RandomState(8).randn(2, n) * 0.1
    else:
        x = np.tile(0.1 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000),
                    (2, 1))
        x[:, n // 2:] = 0
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    bases = (fe.stft.wcos, fe.stft.wsin, fe.mel_basis)
    truth = mel_kernel.mel_power_plain(x.double(),
                                       *(b.double() for b in bases), 512)
    plain = mel_kernel.mel_power_plain(x, *bases, 512)
    got = mel_kernel.mel_power(x, *bases, 512, fe.stft.window, fe.twiddle,
                               fe.band)
    torch.cuda.synchronize()
    err = (got.double() - truth).abs().max().item()
    plain_err = (plain.double() - truth).abs().max().item()
    assert err <= 1.5 * plain_err, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [40, 300])
def test_mel_kernel_takes_any_basis(cuda_device, n_mels):
    """A dense basis (every column's band is all rows) and more columns
    than the block has threads."""
    fe, _ = make_frontend("Mel")
    fe = fe.to(cuda_device)
    basis = torch.from_numpy(np.random.RandomState(9).rand(
        1025, n_mels).astype(np.float32)).to(cuda_device)
    basis[:, 1] = 0
    x = torch.from_numpy((np.random.RandomState(10).randn(2, 5000)
                          * 0.1).astype(np.float32)).to(cuda_device)
    args = (fe.stft.wcos, fe.stft.wsin, basis, 512)
    got = mel_kernel.mel_power(x, *args, fe.stft.window, fe.twiddle,
                               mel_kernel.mel_band(basis))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mel_kernel.mel_power_plain(x, *args),
                               **MEL_TOL)
    assert got[..., 1].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("L,window,Dh,with_rel", [(100, 31, 229, True),
                                                  (33, 7, 57, True),
                                                  (40, 15, 64, False)])
def test_attention_kernel_matches_plain(cuda_device, L, window, Dh,
                                        with_rel):
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh))
    rel = rel if with_rel else None
    before = bak.banded_attention_fwd.launches
    out, probs = bak.banded_attention_fwd(q, kpad, vpad, rel, window)
    torch.cuda.synchronize()
    assert bak.banded_attention_fwd.launches == before + 1
    ref_out, ref_probs = bak.banded_attention(q, kpad, vpad, rel, window)
    torch.testing.assert_close(out, ref_out, **ATTN_TOL)
    torch.testing.assert_close(probs, ref_probs, **ATTN_TOL)


def test_bf16_wrapper_is_plain_on_cpu():
    q, kpad, vpad, rel = _attn_inputs(40, 31, 229)
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    before = (bak.banded_attention_fwd.launches,
              bak.banded_attention_fwd.launches_bf16)
    out, probs = bak.banded_attention_fwd(q, kpad, vpad, rel, 31)
    ref_out, ref_probs = bak.banded_attention(q, kpad, vpad, rel, 31)
    assert out.dtype == torch.bfloat16 and probs.dtype == torch.float32
    assert torch.equal(out, ref_out) and torch.equal(probs, ref_probs)
    assert (bak.banded_attention_fwd.launches,
            bak.banded_attention_fwd.launches_bf16) == before


@pytest.mark.parametrize("p_rounded", [True, False])
def test_bf16_out_share_sees_unrounded_p(p_rounded):
    """The share gate on bf16 out tells the two forms apart: the PV sums
    in float64 (another order) move few elements, skipping the rounding
    of p to bf16 moves many."""
    q, kpad, vpad, rel = _attn_inputs(160, 31, 229, B=1, seed=1)
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    ref_out, probs = bak.banded_attention(q, kpad, vpad, rel, 31)
    p = probs.to(torch.bfloat16) if p_rounded else probs
    out = torch.einsum("blhw,blhdw->blhd", p.double(),
                       vpad.double().unfold(1, 31, 1)).to(torch.bfloat16)
    moved = (out != ref_out).float().mean().item()
    if p_rounded:
        _assert_bf16_out_close(out, ref_out)
    else:
        assert moved > 10 * BF16_OUT_MOVED, moved


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh,with_rel", [
    (8, 640, 31, 229, True),      # full width
    (2, 33, 7, 57, True),         # ragged tile
    (2, 40, 15, 64, False)])
def test_attention_bf16_kernel_matches_plain(cuda_device, B, L, window, Dh,
                                             with_rel):
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh, B=B))
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    rel = rel if with_rel else None
    fp32_before = bak.banded_attention_fwd.launches
    before = bak.banded_attention_fwd.launches_bf16
    out, probs = bak.banded_attention_fwd(q, kpad, vpad, rel, window)
    torch.cuda.synchronize()
    assert bak.banded_attention_fwd.launches_bf16 == before + 1
    assert bak.banded_attention_fwd.launches == fp32_before
    assert out.dtype == torch.bfloat16 and probs.dtype == torch.float32
    ref_out, ref_probs = bak.banded_attention(q, kpad, vpad, rel, window)
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=1e-5)
    _assert_bf16_out_close(out, ref_out)


@pytest.mark.cuda
def test_attention_module_bf16_launches_kernel(cuda_device):
    """On the card: the bf16 attention module runs the bf16 kernel (and not
    the fp32 one) and agrees with its plain route, and its backward runs
    the bf16 backward kernel (and not the fp32 one), reaching the input
    and every parameter with fp32 gradients."""
    from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D

    torch.manual_seed(0)
    mod = MultiHeadAttention1D(229, 916, 31, 4, compute_dtype=torch.bfloat16
                               ).to(cuda_device)
    torch.nn.init.normal_(mod.rel, std=0.1)
    x = torch.randn((2, 80, 229), device=cuda_device)
    fp32_before = bak.banded_attention_fwd.launches
    before = bak.banded_attention_fwd.launches_bf16
    with torch.no_grad():
        out, probs = mod(x)
        mod.use_kernel = False
        ref_out, ref_probs = mod(x)
    torch.cuda.synchronize()
    assert bak.banded_attention_fwd.launches_bf16 == before + 1
    assert bak.banded_attention_fwd.launches == fp32_before
    assert out.dtype == torch.bfloat16 and probs.dtype == torch.float32
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=1e-5)
    _assert_bf16_out_close(out, ref_out)
    mod.use_kernel = True
    x.requires_grad_(True)
    bwd = (bak.banded_attention_bwd, bak.banded_attention_bwd_partials)
    counts = [(f.launches, f.launches_bf16) for f in bwd]
    mod(x)[0].float().square().sum().backward()
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in bwd] == [
        (n, n16 + 1) for n, n16 in counts]
    for g in [x.grad] + [p.grad for p in mod.parameters()]:
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert g.abs().max().item() > 0


@pytest.mark.cuda
def test_attention_kernel_refuses_mixed_dtypes(cuda_device):
    q, kpad, vpad, rel = (t.to(cuda_device) for t in _attn_inputs(40, 31, 64))
    with pytest.raises(TypeError):     # bf16 q with fp32 kpad / vpad
        bak.banded_attention_fwd(q.to(torch.bfloat16), kpad, vpad, rel, 31)
    with pytest.raises(TypeError):     # rel must stay fp32
        bak.banded_attention_fwd(*(t.to(torch.bfloat16)
                                   for t in (q, kpad, vpad, rel)), 31)


# the forward's tile models and card tests: (B, L, window, Dh, with_rel)
FWD_MODEL_SIZES = [(2, 64, 31, 229, True),     # full-width tiles
                   (2, 33, 7, 57, True),       # ragged tile
                   (2, 40, 15, 64, False),     # no rel
                   (1, 64, 32, 256, True),     # one chunk's limits
                   (2, 70, 31, 128, True),     # UNetOnset's Stack heads
                   (2, 70, 31, 176, True),     # CQT's heads
                   (2, 70, 31, 386, True),     # CFP's: two column chunks
                   (1, 64, 32, 512, True)]     # two chunks' limits
FWD_CARD_SIZES = [(8, 640, 31, 229, True)] + FWD_MODEL_SIZES[1:]


def _fwd_inputs(B, L, window, Dh, with_rel, dtype=torch.float32,
                device="cpu"):
    q, kpad, vpad, rel = (t.to(device)
                          for t in _attn_inputs(L, window, Dh, B=B))
    q, kpad, vpad = (t.to(dtype) for t in (q, kpad, vpad))
    return q, kpad, vpad, rel if with_rel else None, window


def _float64(args):
    return (*(None if t is None else t.double() for t in args[:4]), args[4])


@pytest.mark.parametrize("B,L,window,Dh,with_rel", FWD_MODEL_SIZES)
def test_fwd_tf32x3_model_matches_plain(B, L, window, Dh, with_rel):
    """The CPU model of the fp32 tensor-core forward (32 x 64 tiles, zero
    padding to D8, 3xTF32 products) against the plain forward at
    ATTN_TOL, and no further from the float64 forward than
    TF32X3_TRUTH_FACTOR x the plain version."""
    args = _fwd_inputs(B, L, window, Dh, with_rel)
    got = bak.banded_attention_fwd_tf32x3_plain(*args)
    ref = bak.banded_attention(*args)
    assert [(a.shape, a.dtype) for a in got] == [(b.shape, b.dtype)
                                                 for b in ref]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **ATTN_TOL)
    _assert_nearer_float64(got, ref, bak.banded_attention(*_float64(args)),
                           ("out", "probs"))


@pytest.mark.parametrize("B,L,window,Dh,with_rel", FWD_MODEL_SIZES)
def test_fwd_mma_model_matches_plain(B, L, window, Dh, with_rel):
    """The CPU model of the bf16 tensor-core forward (bf16 tiles, zero
    padding to D16, rel as three bf16 terms, p rounded into P) against the
    bf16 plain forward: probs atol 1e-5, out by the rule of bf16 out."""
    args = _fwd_inputs(B, L, window, Dh, with_rel, torch.bfloat16)
    out, probs = bak.banded_attention_fwd_mma_plain(*args)
    ref_out, ref_probs = bak.banded_attention(*args)
    assert out.dtype == torch.bfloat16 and probs.dtype == torch.float32
    assert out.shape == ref_out.shape and probs.shape == ref_probs.shape
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=1e-5)
    _assert_bf16_out_close(out, ref_out)


@pytest.mark.parametrize("p_rounded", [True, False])
def test_bf16_out_rule_sees_fwd_model_without_p_rounding(p_rounded):
    """The rule of bf16 out tells the bf16 tile model from the same tiles
    without the rounding of p: the fp32 tile model on the bf16 operands
    widened to fp32 (exact; their TF32 splits drop nothing) leaves p
    unrounded and moves many out elements."""
    q, kpad, vpad, rel, window = _fwd_inputs(2, 64, 31, 229, True,
                                             torch.bfloat16)
    ref_out, _ = bak.banded_attention(q, kpad, vpad, rel, window)
    if p_rounded:
        out, _ = bak.banded_attention_fwd_mma_plain(q, kpad, vpad, rel,
                                                    window)
        _assert_bf16_out_close(out, ref_out)
    else:
        out, _ = bak.banded_attention_fwd_tf32x3_plain(
            q.float(), kpad.float(), vpad.float(), rel, window)
        moved = (out.to(torch.bfloat16) != ref_out).float().mean().item()
        assert moved > 10 * BF16_OUT_MOVED, moved


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh,with_rel", FWD_CARD_SIZES)
def test_attention_kernel_matches_tf32x3_model(cuda_device, B, L, window,
                                               Dh, with_rel):
    """The fp32 forward on the card against its tile-by-tile model
    (`banded_attention_fwd_tf32x3_plain`) at ATTN_TOL, and no further from
    the float64 forward than TF32X3_TRUTH_FACTOR x the fp32 plain
    version."""
    args = _fwd_inputs(B, L, window, Dh, with_rel, device=cuda_device)
    before = bak.banded_attention_fwd.launches
    got = bak.banded_attention_fwd(*args)
    torch.cuda.synchronize()
    assert bak.banded_attention_fwd.launches == before + 1
    for a, b in zip(got, bak.banded_attention_fwd_tf32x3_plain(*args)):
        torch.testing.assert_close(a, b, **ATTN_TOL)
    _assert_nearer_float64(got, bak.banded_attention(*args),
                           bak.banded_attention(*_float64(args)),
                           ("out", "probs"))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh,with_rel", FWD_CARD_SIZES)
def test_attention_bf16_kernel_matches_mma_model(cuda_device, B, L, window,
                                                 Dh, with_rel):
    """The bf16 forward on the card against its tile-by-tile model
    (`banded_attention_fwd_mma_plain`): probs atol 1e-5, out by the rule
    of bf16 out."""
    args = _fwd_inputs(B, L, window, Dh, with_rel, torch.bfloat16,
                       cuda_device)
    before = bak.banded_attention_fwd.launches_bf16
    out, probs = bak.banded_attention_fwd(*args)
    torch.cuda.synchronize()
    assert bak.banded_attention_fwd.launches_bf16 == before + 1
    ref_out, ref_probs = bak.banded_attention_fwd_mma_plain(*args)
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=1e-5)
    _assert_bf16_out_close(out, ref_out)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh", [(8, 640, 31, 229),   # full width
                                           (2, 100, 7, 57),
                                           (2, 33, 31, 229),    # ragged tile
                                           (2, 70, 31, 176)])   # CQT
def test_attention_bwd_kernel_matches_plain(cuda_device, B, L, window, Dh):
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh, B=B))
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)
                        ).to(cuda_device)
    before = bak.banded_attention_bwd.launches
    got = bak.banded_attention_bwd(q, kpad, vpad, rel, d_out, window)
    torch.cuda.synchronize()
    assert bak.banded_attention_bwd.launches == before + 1
    _assert_grads_close(got, bak.banded_attention_bwd_plain(
        q, kpad, vpad, rel, d_out, window))


@pytest.mark.cuda
def test_attention_bwd_first_pass_matches_plain(cuda_device):
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(70, 31, 229))
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)
                        ).to(cuda_device)
    before = bak.banded_attention_bwd_partials.launches
    got = bak.banded_attention_bwd_partials(q, kpad, vpad, rel, d_out, 31)
    torch.cuda.synchronize()
    assert bak.banded_attention_bwd_partials.launches == before + 1
    _assert_grads_close(got, bak.banded_attention_bwd_partials_plain(
        q, kpad, vpad, rel, d_out, 31), ("dq", "dk_part", "dv_part",
                                         "drel_part"))


def _assert_nearer_float64(got, plain, truth, names):
    """Each output's largest error against float64 `truth`, over max
    |truth|, at most TF32X3_TRUTH_FACTOR x the fp32 plain version's."""
    for name, a, b, t in zip(names, got, plain, truth):
        err = (a.double() - t).abs().max().item()
        plain_err = (b.double() - t).abs().max().item()
        assert err <= TF32X3_TRUTH_FACTOR * plain_err, (name, err, plain_err)


@pytest.mark.parametrize("values", ["normal", "port_init"])
def test_split_tf32x2(values):
    """big and small are TF32 values (the low 13 mantissa bits zero) and
    big + small equals x to within 2**-22 |x|, on N(0, 1) values and on
    `rel` as the port initialises it."""
    from reconvat_tpu_torch.models.reconvat import init_parameters
    from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D

    if values == "normal":
        x = torch.from_numpy(np.random.RandomState(13).randn(
            4, 229, 31).astype(np.float32))
    else:
        mod = MultiHeadAttention1D(229, 916, 31, 4)
        init_parameters(mod, torch.Generator().manual_seed(12))
        x = mod.rel.detach()[0].reshape(4, 229, 31)
    big, small = bak.split_tf32x2(x)
    for t in (big, small):
        assert t.dtype == torch.float32
        assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert (small != 0).float().mean().item() > 0.9      # x is not TF32
    assert (err > 0).any()                               # nor two of them


@pytest.mark.parametrize("B,L,window,Dh", [(2, 100, 31, 229),
                                           (2, 33, 7, 57),      # ragged tile
                                           (2, 70, 31, 128),    # UNetOnset
                                           (2, 70, 31, 176)])   # CQT
def test_fp32_first_pass_tf32x3_model_matches_plain(B, L, window, Dh):
    """The CPU model of the fp32 tensor-core first pass (dense 32 x 64
    tiles, zero padding to D8, 3xTF32 products) against the plain first
    pass at GRAD_TOL, and no further from the float64 first pass than
    TF32X3_TRUTH_FACTOR x the plain version."""
    q, kpad, vpad, rel = _attn_inputs(L, window, Dh, B=B)
    args = (q, kpad, vpad, rel, _d_out(q, 5), window)
    got = bak.banded_attention_bwd_partials_tf32x3_plain(*args)
    ref = bak.banded_attention_bwd_partials_plain(*args)
    assert [(a.shape, a.dtype) for a in got] == [(b.shape, b.dtype)
                                                 for b in ref]
    _assert_grads_close(got, ref, BF16_PART_NAMES)
    truth = bak.banded_attention_bwd_partials_plain(
        *(t.double() for t in args[:5]), window)
    _assert_nearer_float64(got, ref, truth, BF16_PART_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh", [(8, 640, 31, 229),   # full width
                                           (2, 33, 7, 57),      # ragged tile
                                           (2, 70, 31, 176)])   # CQT
def test_attention_bwd_first_pass_matches_tf32x3_model(cuda_device, B, L,
                                                       window, Dh):
    """The fp32 first pass on the card against its tile-by-tile model
    (`banded_attention_bwd_partials_tf32x3_plain`) at GRAD_TOL."""
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh, B=B))
    args = (q, kpad, vpad, rel, _d_out(q, 7), window)
    before = bak.banded_attention_bwd_partials.launches
    got = bak.banded_attention_bwd_partials(*args)
    torch.cuda.synchronize()
    assert bak.banded_attention_bwd_partials.launches == before + 1
    _assert_grads_close(
        got, bak.banded_attention_bwd_partials_tf32x3_plain(*args),
        BF16_PART_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh", [(8, 640, 31, 229),   # full width
                                           (2, 33, 7, 57),      # ragged tile
                                           (2, 70, 31, 176)])   # CQT
def test_attention_bwd_kernel_against_float64(cuda_device, B, L, window,
                                              Dh):
    """Both passes of the fp32 backward on the card, and its first pass,
    no further from the float64 backward than TF32X3_TRUTH_FACTOR x the
    fp32 plain version."""
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh, B=B))
    args = (q, kpad, vpad, rel, _d_out(q, 8), window)
    args64 = (*(t.double() for t in args[:5]), window)
    got = bak.banded_attention_bwd(*args)
    parts = bak.banded_attention_bwd_partials(*args)
    torch.cuda.synchronize()
    _assert_nearer_float64(got, bak.banded_attention_bwd_plain(*args),
                           bak.banded_attention_bwd_plain(*args64),
                           ("dq", "dk", "dv", "drel"))
    _assert_nearer_float64(parts,
                           bak.banded_attention_bwd_partials_plain(*args),
                           bak.banded_attention_bwd_partials_plain(*args64),
                           BF16_PART_NAMES)


@pytest.mark.cuda
def test_attention_bwd_fp32_refuses_beyond_shared_memory(cuda_device):
    """At the kernels' limits (Dh = 256, W = 32) the fp32 first pass's
    fp32 tiles take more shared memory than a block may have on the H100:
    both fp32 wrappers raise ValueError before any launch (the bf16
    instances run there, `test_attention_bwd_bf16_kernel_matches_plain`)."""
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(64, 32, 256, B=1))
    args = (q, kpad, vpad, rel, _d_out(q, 9), 32)
    before = (bak.banded_attention_bwd.launches,
              bak.banded_attention_bwd_partials.launches)
    for wrapper in (bak.banded_attention_bwd,
                    bak.banded_attention_bwd_partials):
        with pytest.raises(ValueError, match="shared memory"):
            wrapper(*args)
    assert (bak.banded_attention_bwd.launches,
            bak.banded_attention_bwd_partials.launches) == before


@pytest.mark.cuda
def test_attention_kernels_at_cfp_heads_forward_only(cuda_device):
    """At CFP's Dh = 386 the forward kernels launch in both operand dtypes
    (two column chunks) and agree with the plain forward; the backward
    kernels take Dh <= 256 and raise ValueError, launching nothing: no
    path of the JAX package trains at CFP. Past the forward's widest head
    it raises too."""
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(70, 31, 386, B=2))
    for dtype, count in ((torch.float32, "launches"),
                         (torch.bfloat16, "launches_bf16")):
        args = (*(t.to(dtype) for t in (q, kpad, vpad)), rel, 31)
        before = getattr(bak.banded_attention_fwd, count)
        out, probs = bak.banded_attention_fwd(*args)
        torch.cuda.synchronize()
        assert getattr(bak.banded_attention_fwd, count) == before + 1
        ref_out, ref_probs = bak.banded_attention(*args)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref_out, **ATTN_TOL)
            torch.testing.assert_close(probs, ref_probs, **ATTN_TOL)
        else:
            torch.testing.assert_close(probs, ref_probs, rtol=0, atol=1e-5)
            _assert_bf16_out_close(out, ref_out)
        wrappers = (bak.banded_attention_bwd,
                    bak.banded_attention_bwd_partials)
        before = [(f.launches, f.launches_bf16) for f in wrappers]
        for wrapper in wrappers:
            with pytest.raises(ValueError, match="serves only"):
                wrapper(*args[:4], _d_out(args[0], 3), 31)
        assert [(f.launches, f.launches_bf16) for f in wrappers] == before
    wide = (t.to(cuda_device) for t in _attn_inputs(40, 31, 520, B=1))
    with pytest.raises(ValueError, match="Dh <= 512"):
        bak.banded_attention_fwd(*wide, 31)


def _d_out(q, seed):
    return torch.randn(q.shape, generator=torch.Generator().manual_seed(seed)
                       ).to(q.device, q.dtype)


def _float64_p_ds(q, kpad, vpad, rel, d_out, window):
    """q, kpad, vpad, rel and d_out in float64, the key window, and p and
    dS of the backward in float64 (unrounded)."""
    q, kpad, vpad, rel, d_out = (t.double() for t in
                                 (q, kpad, vpad, rel, d_out))
    kw, vw = kpad.unfold(1, window, 1), vpad.unfold(1, window, 1)
    s = (torch.einsum("blhd,blhdw->blhw", q, kw)
         + torch.einsum("blhd,hdw->blhw", q, rel))
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("blhd,blhdw->blhw", d_out, vw)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return q, kpad, vpad, rel, d_out, kw, p, ds


def _bwd_float64(q, kpad, vpad, rel, d_out, window, round_p, round_ds,
                 tile=bak.BWD_TILE):
    """The bf16 backward with p and dS in float64, each rounded to bf16 or
    not, and every sum in float64 (another order than the plain version's
    fp32 sums). Returns (dq, dk, dv, drel) and (dq, dk_part, dv_part,
    drel_part) in the bf16 backward's dtypes."""
    L = q.shape[1]
    q, kpad, vpad, rel, d_out, kw, p, ds = _float64_p_ds(
        q, kpad, vpad, rel, d_out, window)
    if round_p:
        p = p.to(torch.bfloat16).double()
    if round_ds:
        ds = ds.to(torch.bfloat16).double()
    dq = torch.einsum("blhw,blhdw->blhd", ds, kw + rel).to(torch.bfloat16)
    dk, dv = torch.zeros_like(kpad), torch.zeros_like(vpad)
    for j in range(window):
        dk[:, j:j + L] += ds[..., j, None] * q
        dv[:, j:j + L] += p[..., j, None] * d_out
    drel = torch.einsum("blhw,blhd->hdw", ds, q)
    qt, dot, pt, dst = (bak._tiles(x, tile) for x in (q, d_out, p, ds))
    dk_part = qt.new_zeros(qt.shape[:3] + (tile + window - 1, qt.shape[4]))
    dv_part = torch.zeros_like(dk_part)
    for j in range(window):
        dk_part[:, :, :, j:j + tile] += dst[..., j, None] * qt
        dv_part[:, :, :, j:j + tile] += pt[..., j, None] * dot
    drel_part = torch.einsum("bhnrw,bhnrd->bhndw", dst, qt)
    return ((dq, dk.to(torch.bfloat16), dv.to(torch.bfloat16), drel.float()),
            (dq, dk_part.float(), dv_part.float(), drel_part.float()))


def _one_flip(q, kpad, vpad, rel, d_out, window, tile=bak.BWD_TILE):
    """One bf16 flip of the largest term of each output element's sum:
    2**-7 x max |dS x| over the terms of dq, dk, drel and their partials,
    2**-7 x max |p dO| over those of dv (p and dS in float64). A p or dS
    whose fp32 value lies within fp32 rounding of a bf16 rounding boundary
    rounds one way in one correct backward and the other way in another,
    which moves its term by up to one bf16 ulp (2**-7 of it). Returns the
    bounds of (dq, dk, dv, drel) and of (dq, dk_part, dv_part, drel_part),
    fp32."""
    L = q.shape[1]
    q, kpad, vpad, rel, d_out, kw, p, ds = _float64_p_ds(
        q, kpad, vpad, rel, d_out, window)
    ds, aq, ado = ds.abs(), q.abs(), d_out.abs()
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(kpad), torch.zeros_like(vpad)
    drel = torch.zeros_like(rel)
    for j in range(window):
        dq = torch.maximum(dq, ds[..., j, None]
                           * (kw[..., j] + rel[:, :, j]).abs())
        dk[:, j:j + L] = torch.maximum(dk[:, j:j + L], ds[..., j, None] * aq)
        dv[:, j:j + L] = torch.maximum(dv[:, j:j + L], p[..., j, None] * ado)
        drel[:, :, j] = (ds[..., j, None] * aq).amax((0, 1))
    qt, dot, pt, dst = (bak._tiles(x, tile) for x in (aq, ado, p, ds))
    dk_part = qt.new_zeros(qt.shape[:3] + (tile + window - 1, qt.shape[4]))
    dv_part = torch.zeros_like(dk_part)
    drel_part = qt.new_zeros(qt.shape[:3] + (qt.shape[4], window))
    for j in range(window):
        dk_part[:, :, :, j:j + tile] = torch.maximum(
            dk_part[:, :, :, j:j + tile], dst[..., j, None] * qt)
        dv_part[:, :, :, j:j + tile] = torch.maximum(
            dv_part[:, :, :, j:j + tile], pt[..., j, None] * dot)
        drel_part[..., j] = (dst[..., j, None] * qt).amax(3)
    full, parts = (dq, dk, dv, drel), (dq, dk_part, dv_part, drel_part)
    return ([(2 ** -7 * x).float() for x in full],
            [(2 ** -7 * x).float() for x in parts])


def _bf16_rule_variants(q, kpad, vpad, rel, d_out, window, variant):
    """(missed outputs of the backward, of its first pass) for one variant
    held against the float64 sums with the Pallas kernel's rounding
    points under the repaired rule: "another_order" is the bf16 plain
    version (fp32 sums), "dS_unrounded" / "p_unrounded" the float64 sums
    that skip the rounding of dS / of p."""
    args = (q, kpad, vpad, rel, d_out, window)
    truth, truth_parts = _bwd_float64(*args, round_p=True, round_ds=True)
    flips, part_flips = _one_flip(*args)
    if variant == "another_order":
        full = bak.banded_attention_bwd_plain(*args)
        parts = bak.banded_attention_bwd_partials_plain(*args)
    else:
        full, parts = _bwd_float64(*args, round_p=variant != "p_unrounded",
                                   round_ds=variant != "dS_unrounded")
    return (_bf16_bwd_misses(full, truth, BF16_BWD_NAMES, flips),
            _bf16_bwd_misses(parts, truth_parts, BF16_PART_NAMES,
                             part_flips))


# the outputs the repaired rule misses for each variant (module docstring)
BF16_RULE_EXPECT = {
    "another_order": ([], []),
    "dS_unrounded": (["dq", "dk", "drel"], ["dq", "dk_part", "drel_part"]),
    "p_unrounded": (["dv"], ["dv_part"])}


@pytest.mark.parametrize("variant", ["another_order", "dS_unrounded",
                                     "p_unrounded"])
def test_bf16_bwd_rule_sees_unrounded_ds_and_p(variant):
    """The rule held on the bf16 backward kernel (module docstring) tells
    the forms apart, on both passes, at full width: against the float64
    sums with the Pallas kernel's rounding points, the bf16 plain version
    (fp32 sums, another order) passes it; skipping the rounding of dS
    breaks it on dq, dk and drel (and their partials), skipping that of p
    on dv."""
    q, kpad, vpad, rel = _attn_inputs(160, 31, 229, B=2, seed=1)
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    assert _bf16_rule_variants(q, kpad, vpad, rel, _d_out(q, 2), 31,
                               variant) == BF16_RULE_EXPECT[variant]


@pytest.mark.parametrize("variant", ["another_order", "dS_unrounded",
                                     "p_unrounded"])
def test_bf16_bwd_rule_sees_unrounded_ds_and_p_at_ragged_tile(variant):
    """The same at the card tests' ragged tile (B=2, L=33, W=7, Dh=57,
    their inputs). 2 x 33 rows give drel too few terms for a missing
    rounding of dS to stand out of one flip's bound: it is seen on dq, dk
    and the partials."""
    q, kpad, vpad, rel = _attn_inputs(33, 7, 57)
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    expect = BF16_RULE_EXPECT[variant]
    if variant == "dS_unrounded":
        expect = (["dq", "dk"], expect[1])
    assert _bf16_rule_variants(q, kpad, vpad, rel, _d_out(q, 5), 7,
                               variant) == expect


@pytest.mark.parametrize("values", ["normal", "port_init"])
def test_split_bf16x3_is_exact(values):
    """rel = r1 + r2 + r3 bit for bit, on N(0, 1) values and on `rel` as
    the port initialises it (`init_parameters`, N(0, 1) drawn per module)."""
    from reconvat_tpu_torch.models.reconvat import init_parameters
    from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D

    if values == "normal":
        rel = torch.from_numpy(np.random.RandomState(11).randn(
            4, 229, 31).astype(np.float32))
    else:
        mod = MultiHeadAttention1D(229, 916, 31, 4)
        init_parameters(mod, torch.Generator().manual_seed(12))
        rel = mod.rel.detach()[0].reshape(4, 229, 31)
    terms = bak.split_bf16x3(rel)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    assert torch.equal(total, rel.double())
    assert torch.equal(total.float().view(torch.int32), rel.view(torch.int32))
    assert (terms[1] != 0).float().mean().item() > 0.9   # rel is not bf16


@pytest.mark.parametrize("B,L,window,Dh", [(2, 100, 31, 229),
                                           (2, 33, 7, 57),      # ragged tile
                                           (2, 70, 31, 128),    # UNetOnset
                                           (2, 70, 31, 176)])   # CQT
def test_bf16_first_pass_mma_model_matches_plain(B, L, window, Dh):
    """The CPU model of the bf16 tensor-core first pass (dense 32 x 64
    tiles, zero padding to D16, the three rel terms) against the bf16
    plain first pass, by the rule held on the kernel."""
    q, kpad, vpad, rel = _attn_inputs(L, window, Dh, B=B)
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    args = (q, kpad, vpad, rel, _d_out(q, 5), window)
    got = bak.banded_attention_bwd_partials_mma_plain(*args)
    ref = bak.banded_attention_bwd_partials_plain(*args)
    assert [tuple(a.shape) for a in got] == [tuple(b.shape) for b in ref]
    assert _bf16_bwd_misses(got, ref, BF16_PART_NAMES) == []


def test_bf16_bwd_rule_fails_float64_sums_at_ragged_tile():
    """At the ragged tile of the card tests (B=2, L=33, W=7, Dh=57, their
    inputs) the fixed bounds alone break for a backward that is right: the
    float64 sums with the Pallas kernel's rounding points, and the
    tensor-core tiles' model, both round one fp32 dS of the plain version
    the other way, which moves dk beyond one bf16 ulp in 2 elements and
    drel by 1.2e-3 of its max (limit 5e-4, measured at B=2..8 x 640
    frames; at 2 x 33 rows one flip is most of drel's budget). With one
    flip of each element's largest term (`_one_flip`) the rule passes the
    plain version and the model against the float64 sums, and the float64
    sums against the plain version."""
    q, kpad, vpad, rel = _attn_inputs(33, 7, 57)
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    args = (q, kpad, vpad, rel, _d_out(q, 5), 7)
    plain = bak.banded_attention_bwd_plain(*args)
    truth, truth_parts = _bwd_float64(*args, round_p=True, round_ds=True)
    flips, part_flips = _one_flip(*args)
    dq, *parts = bak.banded_attention_bwd_partials_mma_plain(*args)
    dk, dv, drel = bak.banded_attention_bwd_reduce_plain(*parts, 33, 7)
    model = (dq, dk.to(torch.bfloat16), dv.to(torch.bfloat16), drel)
    for got, ref in ((truth, plain), (model, plain), (plain, truth)):
        assert _bf16_bwd_misses(got, ref, BF16_BWD_NAMES) == ["dk", "drel"]
    for got, ref in ((truth, plain), (plain, truth), (model, truth)):
        assert _bf16_bwd_misses(got, ref, BF16_BWD_NAMES, flips) == []
    assert _bf16_bwd_misses((dq, *parts), truth_parts, BF16_PART_NAMES,
                            part_flips) == []


def test_bf16_bwd_wrappers_are_plain_on_cpu():
    q, kpad, vpad, rel = _attn_inputs(40, 7, 57)
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    args = (q, kpad, vpad, rel, _d_out(q, 3), 7)
    wrappers = (bak.banded_attention_bwd, bak.banded_attention_bwd_partials)
    before = [(f.launches, f.launches_bf16) for f in wrappers]
    for wrapper, plain in ((bak.banded_attention_bwd,
                            bak.banded_attention_bwd_plain),
                           (bak.banded_attention_bwd_partials,
                            bak.banded_attention_bwd_partials_plain)):
        for a, b in zip(wrapper(*args), plain(*args)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert [(f.launches, f.launches_bf16) for f in wrappers] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh", [(8, 640, 31, 229),   # full width
                                           (2, 33, 7, 57),      # ragged tile
                                           (1, 64, 32, 256),    # limits
                                           (2, 70, 31, 176)])   # CQT
def test_attention_bwd_bf16_kernel_matches_plain(cuda_device, B, L, window,
                                                 Dh):
    """Both passes of the bf16 backward kernel, and the bf16 plain versions
    beside them, against the float64 sums with the Pallas kernel's
    rounding points, by the repaired rule (module docstring); only the
    bf16 instances launch."""
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh, B=B))
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    args = (q, kpad, vpad, rel, _d_out(q, 5), window)
    wrappers = (bak.banded_attention_bwd, bak.banded_attention_bwd_partials)
    before = [(f.launches, f.launches_bf16) for f in wrappers]
    got = bak.banded_attention_bwd(*args)
    parts = bak.banded_attention_bwd_partials(*args)
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in wrappers] == [
        (before[0][0], before[0][1] + 1), (before[1][0], before[1][1] + 2)]
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    truth, truth_parts = _bwd_float64(*args, round_p=True, round_ds=True)
    flips, part_flips = _one_flip(*args)
    for full, first in ((got, parts),
                        (bak.banded_attention_bwd_plain(*args),
                         bak.banded_attention_bwd_partials_plain(*args))):
        assert _bf16_bwd_misses(full, truth, BF16_BWD_NAMES, flips) == []
        assert _bf16_bwd_misses(first, truth_parts, BF16_PART_NAMES,
                                part_flips) == []


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,window,Dh", [(8, 640, 31, 229),   # full width
                                           (2, 33, 7, 57),      # ragged tile
                                           (1, 64, 32, 256),    # limits
                                           (2, 70, 31, 176)])   # CQT
def test_attention_bwd_bf16_first_pass_matches_mma_model(cuda_device, B, L,
                                                         window, Dh):
    """The bf16 first pass on the card against its tile-by-tile model
    (`banded_attention_bwd_partials_mma_plain`), by the same rule."""
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh, B=B))
    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    args = (q, kpad, vpad, rel, _d_out(q, 7), window)
    before = bak.banded_attention_bwd_partials.launches_bf16
    got = bak.banded_attention_bwd_partials(*args)
    torch.cuda.synchronize()
    assert bak.banded_attention_bwd_partials.launches_bf16 == before + 1
    assert _bf16_bwd_misses(
        got, bak.banded_attention_bwd_partials_mma_plain(*args),
        BF16_PART_NAMES, _one_flip(*args)[1]) == []


@pytest.mark.cuda
def test_attention_bwd_refuses_mixed_dtypes(cuda_device):
    q, kpad, vpad, rel = (t.to(cuda_device) for t in _attn_inputs(40, 31, 64))
    d_out = _d_out(q, 6)
    b16 = [t.to(torch.bfloat16) for t in (q, kpad, vpad, d_out)]
    for wrapper in (bak.banded_attention_bwd,
                    bak.banded_attention_bwd_partials):
        with pytest.raises(TypeError):     # bf16 q with fp32 kpad / vpad
            wrapper(b16[0], kpad, vpad, rel, b16[3], 31)
        with pytest.raises(TypeError):     # fp32 d_out with bf16 operands
            wrapper(*b16[:3], rel, d_out, 31)
        with pytest.raises(TypeError):     # rel must stay fp32
            wrapper(*b16[:3], rel.to(torch.bfloat16), b16[3], 31)


@pytest.mark.cuda
def test_attention_module_backward_launches_kernel(cuda_device):
    """A backward through MultiHeadAttention1D on the card reaches the
    projections and the input through the backward kernel, and agrees
    with the plain forward differentiated by autograd."""
    from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D

    torch.manual_seed(0)
    mod = MultiHeadAttention1D(229, 916, 31, 4).to(cuda_device)
    torch.nn.init.normal_(mod.rel, std=0.1)
    x = torch.randn((2, 80, 229), device=cuda_device, requires_grad=True)

    def grads(use_kernel):
        mod.use_kernel = use_kernel
        mod.zero_grad()
        out, _ = mod(x)
        (gx,) = torch.autograd.grad(out.square().sum(), x,
                                    retain_graph=True)
        out.square().sum().backward()
        return [gx] + [p.grad.clone() for p in mod.parameters()]

    before = bak.banded_attention_bwd.launches
    got = grads(True)
    assert bak.banded_attention_bwd.launches == before + 2
    for g in got:
        assert g.abs().max().item() > 0
    _assert_grads_close(got, grads(False),
                        ["x"] + [n for n, _ in mod.named_parameters()])


@pytest.mark.cuda
def test_mel_kernel_refuses_audio_that_needs_grad(cuda_device):
    fe, _ = make_frontend("Mel")
    fe = fe.to(cuda_device)
    x = torch.zeros((1, 4096), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fe(x)
    with torch.no_grad():
        fe(x)


# The attention models' heads (`models/attention_models.py`): 8 heads of
# Dh = 6 (model_complexity 48) and 8 of Dh = 96 (OnsetsAndFramesSelf-
# Attention's 768 features), W = 31, with `rel` and with the zero `rel`
# that `position=False` passes. At Dh = 6 a head fills less than one
# k-step of the tensor-core tiles (D8 = 8): the zero fill past Dh must
# hold. (H, Dh, with_rel)
ATTN_MODEL_HEADS = [(8, 6, True), (8, 6, False), (8, 96, True),
                    (8, 96, False)]


def _model_head_args(H, Dh, with_rel, B=2, L=70, device="cpu"):
    q, kpad, vpad, rel = (t.to(device) for t in
                          _attn_inputs(L, 31, Dh, B=B, H=H, seed=11))
    if not with_rel:
        rel = torch.zeros_like(rel)
    return q, kpad, vpad, rel, _d_out(q, 12), 31


@pytest.mark.parametrize("H,Dh,with_rel", ATTN_MODEL_HEADS)
def test_tile_models_at_attention_model_heads(H, Dh, with_rel):
    """The CPU models of the fp32 tensor-core forward and first pass at the
    attention models' heads against the plain versions (ATTN_TOL,
    GRAD_TOL) and no further from float64 than TF32X3_TRUTH_FACTOR x the
    plain versions."""
    args = _model_head_args(H, Dh, with_rel)
    args64 = (*(t.double() for t in args[:5]), 31)
    got = bak.banded_attention_fwd_tf32x3_plain(*args[:4], 31)
    ref = bak.banded_attention(*args[:4], 31)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **ATTN_TOL)
    _assert_nearer_float64(got, ref, bak.banded_attention(*args64[:4], 31),
                           ("out", "probs"))
    got = bak.banded_attention_bwd_partials_tf32x3_plain(*args)
    ref = bak.banded_attention_bwd_partials_plain(*args)
    _assert_grads_close(got, ref, BF16_PART_NAMES)
    _assert_nearer_float64(got, ref,
                           bak.banded_attention_bwd_partials_plain(*args64),
                           BF16_PART_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Dh,with_rel", ATTN_MODEL_HEADS)
def test_attention_kernels_at_attention_model_heads(cuda_device, H, Dh,
                                                    with_rel):
    """Kernels 2, 3 and 4 (fp32) at the attention models' heads on a
    ragged 2 x 70 clip: each launched once, against its plain version
    (ATTN_TOL, GRAD_TOL) and no further from float64 than
    TF32X3_TRUTH_FACTOR x the plain version."""
    args = _model_head_args(H, Dh, with_rel, device=cuda_device)
    args64 = (*(t.double() for t in args[:5]), 31)
    rows = ((bak.banded_attention_fwd, bak.banded_attention, 4,
             ("out", "probs")),
            (bak.banded_attention_bwd, bak.banded_attention_bwd_plain, 5,
             ("dq", "dk", "dv", "drel")),
            (bak.banded_attention_bwd_partials,
             bak.banded_attention_bwd_partials_plain, 5, BF16_PART_NAMES))
    for wrapper, plain, n_args, names in rows:
        call = (lambda f, a, n=n_args: f(*a[:n], 31))
        before = wrapper.launches
        got = call(wrapper, args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = call(plain, args)
        if wrapper is bak.banded_attention_fwd:
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, **ATTN_TOL)
        else:
            _assert_grads_close(got, ref, names)
        _assert_nearer_float64(got, ref, call(plain, args64), names)
