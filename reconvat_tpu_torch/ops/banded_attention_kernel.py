"""Banded local attention: CUDA kernel wrappers, plain versions and the
autograd Function that joins forward and backward.

`banded_attention_fwd` computes what the TPU kernel `_attention_kernel`
(`reconvat_tpu/ops/pallas_attention.py`) computes, and also returns the
attention probabilities, which the default reference path returns:

    s[b, t, h, j] = q[b, t, h] . (kpad[b, t + j, h] + rel[h, :, j])
    p = softmax_j(s)           (no 1/sqrt(d) scale)
    out[b, t, h] = sum_j p[b, t, h, j] * vpad[b, t + j, h]

with kpad/vpad zero-padded by (window - 1) // 2 rows per side. q, kpad,
vpad and out are fp32, or bf16 in the mixed-precision model; rel and probs
are fp32 in both (the bf16 arithmetic: `banded_attention`; the kernels'
tensor-core tiles: `banded_attention_fwd_tf32x3_plain` for fp32 operands,
`banded_attention_fwd_mma_plain` for bf16 ones).
`banded_attention_bwd` computes what the TPU kernel `_bwd_kernel`
(`reconvat_tpu/ops/pallas_attention_bwd.py`) computes: the gradients of
`out` with respect to q, kpad, vpad and rel, with d_out, dq, dk and dv in
the operand dtype and drel fp32 (the bf16 arithmetic:
`banded_attention_bwd_plain`; the first passes' tensor-core tiles:
`banded_attention_bwd_partials_tf32x3_plain` for fp32 operands,
`banded_attention_bwd_partials_mma_plain` for bf16 ones). On a CUDA
tensor each wrapper launches its kernel (`csrc/banded_attention.cu`,
`csrc/banded_attention_bwd.cu`); on a CPU tensor it runs its plain
PyTorch version. `BandedAttention` is the differentiable op built from both.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..kernels import _build

# query rows per tile of the backward's first pass; the CUDA source builds
# with the same value and refuses another
BWD_TILE = 32
# the widest head the forward kernels take (`MAX_FWD_D` of
# csrc/banded_attention.cu: two chunks of 256 columns), and the widest the
# backward's take (`32 * MAX_DCHUNK` of csrc/banded_attention_bwd.cu; the
# fp32 one also needs its tiles to fit the shared memory: Dh <= 232 on the
# H100). No path of the JAX package trains at a head wider than 256: CFP's
# Dh = 386 serves only.
FWD_MAX_DH, BWD_MAX_DH = 512, 256


def banded_attention(q, kpad, vpad, rel, window: int):
    """Plain PyTorch version.

    q (B, L, H, Dh); kpad/vpad (B, L + window - 1, H, Dh); rel (H, Dh,
    window) or None. Returns (out (B, L, H, Dh), probs (B, L, H, window)).
    The band is unfolded to (B, L, H, Dh, window) windows; q.k and q.rel are
    formed apart and added, as the reference adds its skewed bias.

    bf16 q, kpad and vpad (rel fp32) take the bf16 kernel's arithmetic: the
    operands widened to fp32 (exact), scores and softmax in fp32, p rounded
    to bf16 before the PV product (the JAX package casts probs to v's
    dtype), the PV sums in fp32 and out rounded to bf16; probs is p before
    its rounding, fp32.
    """
    dtype = q.dtype
    if dtype == torch.bfloat16:
        q, kpad, vpad = q.float(), kpad.float(), vpad.float()
    kw = kpad.unfold(1, window, 1)          # (B, L, H, Dh, W)
    vw = vpad.unfold(1, window, 1)
    scores = torch.einsum("blhd,blhdw->blhw", q, kw)
    if rel is not None:
        scores = scores + torch.einsum("blhd,hdw->blhw", q, rel)
    probs = torch.softmax(scores, dim=-1)
    p = probs.to(dtype).float() if dtype == torch.bfloat16 else probs
    out = torch.einsum("blhw,blhdw->blhd", p, vw)
    return out.to(dtype), probs


def banded_attention_fwd(q, kpad, vpad, rel, window: int):
    """Returns (out, probs) like `banded_attention`.

    CPU tensors take `banded_attention`; CUDA tensors launch the kernel of
    `csrc/banded_attention.cu` for their dtype or raise: fp32 q, kpad and
    vpad the 3xTF32 tensor-core kernel whose tile arithmetic
    `banded_attention_fwd_tf32x3_plain` repeats (counted in
    `banded_attention_fwd.launches`), bf16 ones the bf16 tensor-core kernel
    whose tile arithmetic `banded_attention_fwd_mma_plain` repeats (counted
    in `banded_attention_fwd.launches_bf16`); rel is fp32 for both. A
    missing rel is a zero rel. Both take window <= 32 and Dh <=
    `FWD_MAX_DH` (the kernels walk a head wider than 256 in two column
    chunks: CFP's Dh = 386) and raise ValueError beyond."""
    if q.device.type == "cpu":
        return banded_attention(q, kpad, vpad, rel, window)
    if q.device.type != "cuda" or q.dim() != 4:
        raise ValueError(f"banded_attention_fwd: expected (B, L, H, Dh) on "
                         f"CPU or CUDA, got {tuple(q.shape)} on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"banded_attention_fwd: the kernels take float32 or "
                        f"bfloat16 operands, got {q.dtype}")
    B, L, H, D = q.shape
    if not 1 <= window <= 32 or D > FWD_MAX_DH:
        raise ValueError(f"the attention forward kernels take window <= 32 "
                         f"and Dh <= {FWD_MAX_DH}, got window={window}, "
                         f"Dh={D}")
    if rel is None:
        rel = torch.zeros((H, D, window), device=q.device)
    _build.check_tensor("q", q, (B, L, H, D), q.device, q.dtype)
    _build.check_tensor("kpad", kpad, (B, L + window - 1, H, D), q.device,
                        q.dtype)
    _build.check_tensor("vpad", vpad, (B, L + window - 1, H, D), q.device,
                        q.dtype)
    _build.check_tensor("rel", rel, (H, D, window), q.device)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    probs = torch.empty((B, L, H, window), dtype=torch.float32,
                        device=q.device)
    lib = _build.load("banded_attention")
    bf16 = q.dtype == torch.bfloat16
    launch = (lib.banded_attention_fwd_bf16_launch if bf16
              else lib.banded_attention_fwd_launch)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = launch(q.data_ptr(), kpad.data_ptr(), vpad.data_ptr(),
                 rel.data_ptr(), out.data_ptr(), probs.data_ptr(), B, L, H,
                 D, window, ctypes.c_void_p(stream))
    _build.check(err, "banded_attention_fwd")
    if bf16:
        banded_attention_fwd.launches_bf16 += 1
    else:
        banded_attention_fwd.launches += 1
    return out, probs


banded_attention_fwd.launches = 0
banded_attention_fwd.launches_bf16 = 0


def _probs_and_ds(q, kpad, vpad, rel, d_out, window: int):
    """Recomputed probabilities p and softmax-backward dS, (B, L, H, W)
    each, as the products weigh them, with the operands widened to fp32
    and the (B, L, H, Dh, W) key window: p and dS are fp32 (dP unrounded),
    and for bf16 operands both are then rounded to bf16, as the Pallas
    kernel casts them before its products (`pallas_attention_bwd.py:114,
    126, 129`)."""
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, kpad, vpad, d_out = (t.float() for t in (q, kpad, vpad, d_out))
    kw = kpad.unfold(1, window, 1)
    vw = vpad.unfold(1, window, 1)
    scores = (torch.einsum("blhd,blhdw->blhw", q, kw)
              + torch.einsum("blhd,hdw->blhw", q, rel))
    p = torch.softmax(scores, dim=-1)
    dp = torch.einsum("blhd,blhdw->blhw", d_out, vw)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if bf16:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    return q, d_out, p, ds, kw


def banded_attention_bwd_plain(q, kpad, vpad, rel, d_out, window: int):
    """Plain PyTorch version of the backward. Returns (dq, dkpad, dvpad,
    drel) of `out = banded_attention(q, kpad, vpad, rel, window)[0]` for
    the output gradient d_out:

        dP = dO . V_window,  dS = p * (dP - sum_j p dP)
        dq = dS . (K_window + rel),  drel = sum_{b,t} dS q
        dkpad[t + j] += dS[j] q_t,   dvpad[t + j] += p[j] dO_t

    bf16 q, kpad, vpad and d_out (rel fp32) take the bf16 kernel's
    arithmetic: the operands widened to fp32, p and dS in fp32 and then
    rounded to bf16 before the products, the sums in fp32, dq, dk and dv
    rounded to bf16 once and drel fp32.
    """
    dtype, L = q.dtype, q.shape[1]
    q, d_out, p, ds, kw = _probs_and_ds(q, kpad, vpad, rel, d_out, window)
    dq = (torch.einsum("blhw,blhdw->blhd", ds, kw)
          + torch.einsum("blhw,hdw->blhd", ds, rel))
    drel = torch.einsum("blhw,blhd->hdw", ds, q)
    dk = kw.new_zeros(kpad.shape)
    dv = torch.zeros_like(dk)
    for j in range(window):
        dk[:, j:j + L] += ds[..., j, None] * q
        dv[:, j:j + L] += p[..., j, None] * d_out
    return dq.to(dtype), dk.to(dtype), dv.to(dtype), drel


def _tiles(x, tile: int):
    """(B, L, H, X) -> (B, H, n_tiles, tile, X), zero rows past L."""
    B, L, H, X = x.shape
    n = -(-L // tile)
    x = F.pad(x, (0, 0, 0, 0, 0, n * tile - L))
    return x.reshape(B, n, tile, H, X).permute(0, 3, 1, 2, 4)


def banded_attention_bwd_partials_plain(q, kpad, vpad, rel, d_out,
                                        window: int, tile: int = BWD_TILE):
    """Plain version of the backward's first pass. Returns (dq, dk_part,
    dv_part, drel_part): dk_part / dv_part (B, H, n_tiles, tile + window -
    1, Dh) hold each query tile's contribution to the key rows of its
    context [i * tile, i * tile + tile + window - 1), drel_part (B, H,
    n_tiles, Dh, window) its contribution to drel. dq is in the operand
    dtype, the partials fp32 (bf16 arithmetic: `banded_attention_bwd_plain`)."""
    dtype = q.dtype
    q, d_out, p, ds, kw = _probs_and_ds(q, kpad, vpad, rel, d_out, window)
    dq = (torch.einsum("blhw,blhdw->blhd", ds, kw)
          + torch.einsum("blhw,hdw->blhd", ds, rel))
    qt, dot, pt, dst = (_tiles(x, tile) for x in (q, d_out, p, ds))
    B, H, n, _, D = qt.shape
    dk_part = q.new_zeros((B, H, n, tile + window - 1, D))
    dv_part = torch.zeros_like(dk_part)
    for j in range(window):
        dk_part[:, :, :, j:j + tile] += dst[..., j, None] * qt
        dv_part[:, :, :, j:j + tile] += pt[..., j, None] * dot
    drel_part = torch.einsum("bhnrw,bhnrd->bhndw", dst, qt)
    return dq.to(dtype), dk_part, dv_part, drel_part


def split_bf16x3(rel):
    """fp32 `rel` as three bf16 terms whose sum is `rel` exactly:
    r1 = bf16(rel), r2 = bf16(rel - r1), r3 = bf16(rel - r1 - r2), each
    rounded to nearest even. Each residual is exact in fp32 and carries at
    most 16, then 8, significant bits, so r3 drops nothing (for values
    far from fp32's subnormal range). A bf16 tensor-core product of bf16
    q with the three terms, summed in fp32, thus weighs q by the fp32 rel."""
    r1 = rel.to(torch.bfloat16)
    e1 = rel - r1.float()
    r2 = e1.to(torch.bfloat16)
    r3 = (e1 - r2.float()).to(torch.bfloat16)
    return r1, r2, r3


# the tensor-core first passes' tiles: context rows padded to MMA_CTX, the
# window to MMA_W; the head width to a multiple of MMA_K (the bf16 pass's
# product depth) or TF32_K (the fp32 pass's)
MMA_CTX, MMA_W, MMA_K, TF32_K = 64, 32, 16, 8


def _block_tiles(q, kpad, vpad, d_out, tile: int, width: int):
    """The operand tiles of one block of the tensor-core kernels, for
    every (b, h) and query tile at once, widened to fp32 and zero-padded
    to `width` columns: Q and dO (B, H, n, tile, width; None for a d_out
    of None), the K and V context (B, H, n, MMA_CTX, width), zero at rows
    past the context or past kpad."""
    L, D = q.shape[1], q.shape[3]
    n = -(-L // tile)
    ctx = tile + (kpad.shape[1] - L)
    rows = torch.arange(MMA_CTX, device=q.device)

    def query_tiles(x):
        return _tiles(F.pad(x.float(), (0, width - D)), tile)

    def context_tiles(x):
        x = F.pad(x.float(), (0, width - D, 0, 0, 0,
                              (n - 1) * tile + MMA_CTX - x.shape[1]))
        x = x.unfold(1, MMA_CTX, tile).permute(0, 2, 1, 4, 3)
        return x.masked_fill((rows >= ctx)[:, None], 0.0)

    return (query_tiles(q), None if d_out is None else query_tiles(d_out),
            context_tiles(kpad), context_tiles(vpad))


def _rel_tile(rel, window: int, width: int):
    """rel (H, Dh, window) as the kernels' rel^T tile, (1, H, 1, MMA_W,
    width), fp32 and zero-padded."""
    D = rel.shape[1]
    return F.pad(rel.float(), (0, MMA_W - window, 0, width - D)).transpose(
        1, 2)[None, :, None]


def _band_probs(s_full, qrel, L: int, window: int, tile: int):
    """p of the block's rows from the dense S tile and Qrel (s = S[r, r +
    j] + Qrel[r, j], q.k and q.rel added as the plain version adds them),
    zero at rows past L, and the band's column index r + j of each p."""
    dev = s_full.device
    n = s_full.shape[2]
    band = (torch.arange(tile, device=dev)[:, None]
            + torch.arange(window, device=dev))           # r + j
    band = band.expand(*s_full.shape[:3], tile, window)
    p = torch.softmax(s_full.gather(-1, band) + qrel[..., :window], dim=-1)
    t = (torch.arange(n, device=dev)[:, None] * tile
         + torch.arange(tile, device=dev))
    return p.masked_fill(~(t < L)[..., None], 0.0), band


def _band_softmax(s_full, qrel, dp_full, L: int, window: int, tile: int,
                  round_bf16: bool):
    """p and dS of the block's rows from the dense S and dP tiles
    (`_band_probs`), zero at rows past L, each rounded to bf16 or not.
    Returns (p_dense, ds_dense, ds_band): p and dS at [r, r + j] of a
    (tile, MMA_CTX) tile, zero elsewhere, and dS at [r, j] of a (tile,
    MMA_W) one."""
    p, band = _band_probs(s_full, qrel, L, window, tile)
    dp = dp_full.gather(-1, band)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if round_bf16:
        p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    p_dense = s_full.new_zeros(s_full.shape).scatter(-1, band, p)
    ds_dense = s_full.new_zeros(s_full.shape).scatter(-1, band, ds)
    return p_dense, ds_dense, F.pad(ds, (0, MMA_W - window))


def _crop_rows(x, L: int, cols: int):
    """Query-row tiles (B, H, n, tile, X) back to (B, L, H, cols)."""
    B, H, n, tile, X = x.shape
    x = x.permute(0, 2, 3, 1, 4).reshape(B, n * tile, H, X)
    return x[:, :L, :, :cols].contiguous()


def _crop_partials(dq, dk, dv, drel, L: int, D: int, window: int,
                   tile: int):
    """The block tiles cut back to what banded_attention_bwd_partials_plain
    returns (dq fp32, (B, L, H, D))."""
    ctx = tile + window - 1
    return (_crop_rows(dq, L, D), dk[..., :ctx, :D].contiguous(),
            dv[..., :ctx, :D].contiguous(),
            drel[..., :D, :window].contiguous())


def banded_attention_bwd_partials_mma_plain(q, kpad, vpad, rel, d_out,
                                            window: int,
                                            tile: int = BWD_TILE):
    """The bf16 first pass as the tensor-core kernel of
    `csrc/banded_attention_bwd.cu` computes it, tile by tile; returns what
    `banded_attention_bwd_partials_plain` returns. bf16 q, kpad, vpad and
    d_out, fp32 rel. Per (b, h) and query tile of 32 rows, with its 64
    context rows (rows past the context or past kpad zero) and the head
    width zero-padded to D16, a multiple of 16:

        S = Q K^T (32 x 64),  Qrel = Q r1 + Q r2 + Q r3 (32 x 32),
        dP = dO V^T (32 x 64)                 (`split_bf16x3(rel)`)
        s = S[r, r + j] + Qrel[r, j],  p = softmax_j(s),
        dS = p (dP[r, r + j] - sum_j p dP[r, r + j]), both rounded to bf16
        P_dense, dS_dense (32 x 64): p, dS at [r, r + j], zero elsewhere
        dS_band (32 x 32): dS at [r, j]
        dq = dS_dense K + dS_band r1^T + dS_band r2^T + dS_band r3^T
        dk_part = dS_dense^T Q,  dv_part = P_dense^T dO,
        drel_part = Q^T dS_band

    Every product is of bf16 values (exact in fp32) summed in fp32; the
    tiles are cropped to the context rows, Dh and the window at the end,
    and dq rounded to bf16."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 first pass takes bfloat16 operands, got "
                        f"{q.dtype}")
    L, D = q.shape[1], q.shape[3]
    D16 = -(-D // MMA_K) * MMA_K
    qt, dot, kc, vc = _block_tiles(q, kpad, vpad, d_out, tile, D16)
    r = [_rel_tile(t, window, D16) for t in split_bf16x3(rel)]
    s_full = qt @ kc.transpose(-1, -2)
    qrel = qt @ r[0].transpose(-1, -2)
    for rt in r[1:]:
        qrel = qrel + qt @ rt.transpose(-1, -2)
    dp_full = dot @ vc.transpose(-1, -2)
    p_dense, ds_dense, ds_band = _band_softmax(s_full, qrel, dp_full, L,
                                               window, tile, True)
    dq = ds_dense @ kc
    for rt in r:
        dq = dq + ds_band @ rt
    dq, *parts = _crop_partials(dq, ds_dense.transpose(-1, -2) @ qt,
                                p_dense.transpose(-1, -2) @ dot,
                                qt.transpose(-1, -2) @ ds_band, L, D,
                                window, tile)
    return (dq.to(torch.bfloat16), *parts)


def split_tf32x2(x):
    """fp32 x as two TF32 values (10 stored mantissa bits, fp32's exponent)
    as `cvt.rna.tf32.f32` rounds them, to nearest with ties away from zero:
    big = tf32(x), small = tf32(x - big). x - big is exact in fp32, and
    big + small equals x to within 2**-22 |x|."""
    def rna(v):
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


def _mm_tf32x3(a, b):
    """a @ b as three TF32 tensor-core products with fp32 sums: big big +
    (big small + small big), each operand `split_tf32x2`; small small is
    dropped."""
    a1, a2 = split_tf32x2(a.contiguous())
    b1, b2 = split_tf32x2(b.contiguous())
    return a1 @ b1 + (a1 @ b2 + a2 @ b1)


def _fwd_args(q, rel, window: int, dtype):
    """(L, Dh, rel) of a forward model: the operands of `dtype`, a missing
    rel a zero rel, as the wrapper passes it to the kernel."""
    if q.dtype != dtype:
        raise TypeError(f"the model takes {dtype} operands, got {q.dtype}")
    B, L, H, D = q.shape
    if rel is None:
        rel = torch.zeros((H, D, window), device=q.device)
    return L, D, rel


def banded_attention_fwd_mma_plain(q, kpad, vpad, rel, window: int,
                                   tile: int = BWD_TILE):
    """The bf16 forward as the tensor-core kernel of
    `csrc/banded_attention.cu` computes it, tile by tile; returns what
    `banded_attention` returns. bf16 q, kpad and vpad, fp32 rel (or None).
    Per (b, h) and query tile of 32 rows, with its 64 context rows (rows
    past the context or past kpad zero) and the head width zero-padded to
    D16, a multiple of 16:

        S = Q K^T (32 x 64),  Qrel = Q r1 + Q r2 + Q r3 (32 x 32)
                                              (`split_bf16x3(rel)`)
        s = S[r, r + j] + Qrel[r, j],  p = softmax_j(s)  (probs)
        P_dense (32 x 64): p rounded to bf16 at [r, r + j], zero elsewhere
        out = P_dense V, rounded to bf16

    Every product is of bf16 values (exact in fp32) summed in fp32."""
    L, D, rel = _fwd_args(q, rel, window, torch.bfloat16)
    D16 = -(-D // MMA_K) * MMA_K
    qt, _, kc, vc = _block_tiles(q, kpad, vpad, None, tile, D16)
    r = [_rel_tile(t, window, D16) for t in split_bf16x3(rel)]
    qrel = qt @ r[0].transpose(-1, -2)
    for rt in r[1:]:
        qrel = qrel + qt @ rt.transpose(-1, -2)
    p, band = _band_probs(qt @ kc.transpose(-1, -2), qrel, L, window, tile)
    p_dense = kc.new_zeros(p.shape[:-1] + (MMA_CTX,)).scatter(
        -1, band, p.to(torch.bfloat16).float())
    return (_crop_rows(p_dense @ vc, L, D).to(torch.bfloat16),
            _crop_rows(p, L, window))


def banded_attention_fwd_tf32x3_plain(q, kpad, vpad, rel, window: int,
                                      tile: int = BWD_TILE):
    """The fp32 forward as the 3xTF32 tensor-core kernel of
    `csrc/banded_attention.cu` computes it, tile by tile; returns what
    `banded_attention` returns. fp32 operands, rel or None. Per (b, h) and
    query tile of 32 rows, with its 64 context rows (rows past the context
    or past kpad zero) and the head width zero-padded to D8, a multiple of
    8, every product A B taken as `_mm_tf32x3`:

        S = Q K^T (32 x 64),  Qrel = Q rel^T (32 x 32)
        s = S[r, r + j] + Qrel[r, j],  p = softmax_j(s)  (probs)
        P_dense (32 x 64): p (not rounded) at [r, r + j], zero elsewhere
        out = P_dense V"""
    L, D, rel = _fwd_args(q, rel, window, torch.float32)
    D8 = -(-D // TF32_K) * TF32_K
    qt, _, kc, vc = _block_tiles(q, kpad, vpad, None, tile, D8)
    qrel = _mm_tf32x3(qt, _rel_tile(rel, window, D8).transpose(-1, -2))
    p, band = _band_probs(_mm_tf32x3(qt, kc.transpose(-1, -2)), qrel, L,
                          window, tile)
    p_dense = kc.new_zeros(p.shape[:-1] + (MMA_CTX,)).scatter(-1, band, p)
    return _crop_rows(_mm_tf32x3(p_dense, vc), L, D), _crop_rows(p, L, window)


def banded_attention_bwd_partials_tf32x3_plain(q, kpad, vpad, rel, d_out,
                                               window: int,
                                               tile: int = BWD_TILE):
    """The fp32 first pass as the 3xTF32 tensor-core kernel of
    `csrc/banded_attention_bwd.cu` computes it, tile by tile; returns what
    `banded_attention_bwd_partials_plain` returns. fp32 operands. Per (b,
    h) and query tile of 32 rows, with its 64 context rows (rows past the
    context or past kpad zero) and the head width zero-padded to D8, a
    multiple of 8, every product A B taken as `_mm_tf32x3`:

        S = Q K^T, dP = dO V^T (32 x 64),  Qrel = Q rel^T (32 x 32)
        s = S[r, r + j] + Qrel[r, j],  p = softmax_j(s),
        dS = p (dP[r, r + j] - sum_j p dP[r, r + j])   (not rounded)
        P_dense, dS_dense (32 x 64): p, dS at [r, r + j], zero elsewhere
        dS_band (32 x 32): dS at [r, j], read from dS_dense
        dq = dS_dense K + dS_band rel^T (one sum),
        dk_part = dS_dense^T Q,  dv_part = P_dense^T dO,
        drel_part = Q^T dS_band

    The tiles are cropped to the context rows, Dh and the window at the
    end."""
    if q.dtype != torch.float32:
        raise TypeError(f"the fp32 first pass takes float32 operands, got "
                        f"{q.dtype}")
    L, D = q.shape[1], q.shape[3]
    D8 = -(-D // TF32_K) * TF32_K
    qt, dot, kc, vc = _block_tiles(q, kpad, vpad, d_out, tile, D8)
    rt = _rel_tile(rel, window, D8)
    s_full = _mm_tf32x3(qt, kc.transpose(-1, -2))
    qrel = _mm_tf32x3(qt, rt.transpose(-1, -2))
    dp_full = _mm_tf32x3(dot, vc.transpose(-1, -2))
    p_dense, ds_dense, ds_band = _band_softmax(s_full, qrel, dp_full, L,
                                               window, tile, False)
    dq = _mm_tf32x3(torch.cat([ds_dense, ds_band], -1),
                    torch.cat([kc, rt.expand(*kc.shape[:3], -1, -1)], -2))
    return _crop_partials(dq, _mm_tf32x3(ds_dense.transpose(-1, -2), qt),
                          _mm_tf32x3(p_dense.transpose(-1, -2), dot),
                          _mm_tf32x3(qt.transpose(-1, -2), ds_band), L, D,
                          window, tile)


def banded_attention_bwd_reduce_plain(dk_part, dv_part, drel_part, L: int,
                                      window: int, tile: int = BWD_TILE):
    """Plain version of the backward's second pass: overlap-add the tile
    partials into (dkpad, dvpad) of (B, L + window - 1, H, Dh) and sum the
    drel partials into (H, Dh, window), all in the partials' dtype (the
    bf16 kernel rounds dk and dv to bf16 once, after these sums)."""
    B, H, n, ctx, D = dk_part.shape
    Lk = L + window - 1

    def overlap_add(part):
        out = part.new_zeros((B, H, (n - 1) * tile + ctx, D))
        for i in range(n):
            out[:, :, i * tile:i * tile + ctx] += part[:, :, i]
        return out[:, :, :Lk].permute(0, 2, 1, 3).contiguous()

    return (overlap_add(dk_part), overlap_add(dv_part),
            drel_part.sum(dim=(0, 2)))


def _check_bwd_args(q, kpad, vpad, rel, d_out, window: int):
    if q.device.type != "cuda" or q.dim() != 4:
        raise ValueError(f"banded attention backward: expected (B, L, H, "
                         f"Dh) on CPU or CUDA, got {tuple(q.shape)} on "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"banded attention backward: the kernels take "
                        f"float32 or bfloat16 operands, got {q.dtype}")
    B, L, H, D = q.shape
    if not 1 <= window <= 32 or D > BWD_MAX_DH:
        raise ValueError(f"the attention backward kernels take window <= 32 "
                         f"and Dh <= {BWD_MAX_DH} (fp32: <= 232 on the "
                         f"H100), got window={window}, Dh={D}; no path of "
                         f"the JAX package trains at a wider head (CFP's "
                         f"Dh = 386 serves only)")
    _build.check_tensor("q", q, (B, L, H, D), q.device, q.dtype)
    _build.check_tensor("kpad", kpad, (B, L + window - 1, H, D), q.device,
                        q.dtype)
    _build.check_tensor("vpad", vpad, (B, L + window - 1, H, D), q.device,
                        q.dtype)
    _build.check_tensor("rel", rel, (H, D, window), q.device)
    _build.check_tensor("d_out", d_out, (B, L, H, D), q.device, q.dtype)


def banded_attention_bwd_partials(q, kpad, vpad, rel, d_out, window: int):
    """The backward's first pass, as `banded_attention_bwd_partials_plain`.

    CPU tensors take the plain version; CUDA tensors launch the first
    pass of `csrc/banded_attention_bwd.cu` for their dtype or raise: fp32
    q, kpad, vpad and d_out the 3xTF32 tensor-core kernel whose tile
    arithmetic `banded_attention_bwd_partials_tf32x3_plain` repeats
    (counted in `banded_attention_bwd_partials.launches`), bf16 ones the
    bf16 tensor-core kernel whose tile arithmetic
    `banded_attention_bwd_partials_mma_plain` repeats (counted in
    `banded_attention_bwd_partials.launches_bf16`); rel fp32 for both. The
    fp32 kernel keeps its operand tiles in fp32 and raises ValueError where
    they exceed the shared memory a block may take (Dh > 232 on the
    H100)."""
    if q.device.type == "cpu":
        return banded_attention_bwd_partials_plain(q, kpad, vpad, rel,
                                                   d_out, window)
    _check_bwd_args(q, kpad, vpad, rel, d_out, window)
    B, L, H, D = q.shape
    lib = _build.load("banded_attention_bwd")
    bf16 = q.dtype == torch.bfloat16
    if not bf16:
        with torch.cuda.device(q.device):
            need = lib.banded_attention_bwd_partials_smem_bytes(D)
            limit = lib.banded_attention_bwd_partials_smem_limit()
        if not 0 < need <= limit:
            raise ValueError(f"the fp32 attention backward takes {need} "
                             f"bytes of shared memory per block at Dh={D}; "
                             f"a block may opt in to {limit} on "
                             f"{torch.cuda.get_device_name(q.device)}")
    n = -(-L // BWD_TILE)
    dq = torch.empty_like(q)
    dk_part = torch.empty((B, H, n, BWD_TILE + window - 1, D),
                          dtype=torch.float32, device=q.device)
    dv_part = torch.empty_like(dk_part)
    drel_part = torch.empty((B, H, n, D, window), dtype=torch.float32,
                            device=q.device)
    launch = (lib.banded_attention_bwd_partials_bf16_launch if bf16
              else lib.banded_attention_bwd_partials_launch)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = launch(q.data_ptr(), kpad.data_ptr(), vpad.data_ptr(),
                 rel.data_ptr(), d_out.data_ptr(), dq.data_ptr(),
                 dk_part.data_ptr(), dv_part.data_ptr(),
                 drel_part.data_ptr(), B, L, H, D, window, BWD_TILE,
                 ctypes.c_void_p(stream))
    _build.check(err, "banded_attention_bwd_partials")
    if bf16:
        banded_attention_bwd_partials.launches_bf16 += 1
    else:
        banded_attention_bwd_partials.launches += 1
    return dq, dk_part, dv_part, drel_part


banded_attention_bwd_partials.launches = 0
banded_attention_bwd_partials.launches_bf16 = 0


def banded_attention_bwd(q, kpad, vpad, rel, d_out, window: int):
    """(dq, dkpad, dvpad, drel) like `banded_attention_bwd_plain`.

    CPU tensors take the plain version; CUDA tensors run both passes of
    `csrc/banded_attention_bwd.cu` for their dtype (and count one launch in
    `banded_attention_bwd.launches` for fp32 operands,
    `banded_attention_bwd.launches_bf16` for bf16 ones) or raise."""
    if q.device.type == "cpu":
        return banded_attention_bwd_plain(q, kpad, vpad, rel, d_out, window)
    B, L, H, D = q.shape
    dq, dk_part, dv_part, drel_part = banded_attention_bwd_partials(
        q, kpad, vpad, rel, d_out, window)
    dk = torch.empty_like(kpad)
    dv = torch.empty_like(vpad)
    drel = torch.empty_like(rel)
    lib = _build.load("banded_attention_bwd")
    bf16 = q.dtype == torch.bfloat16
    launch = (lib.banded_attention_bwd_reduce_bf16_launch if bf16
              else lib.banded_attention_bwd_reduce_launch)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = launch(dk_part.data_ptr(), dv_part.data_ptr(),
                 drel_part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 drel.data_ptr(), B, L, H, D, window, BWD_TILE,
                 ctypes.c_void_p(stream))
    _build.check(err, "banded_attention_bwd")
    if bf16:
        banded_attention_bwd.launches_bf16 += 1
    else:
        banded_attention_bwd.launches += 1
    return dq, dk, dv, drel


banded_attention_bwd.launches = 0
banded_attention_bwd.launches_bf16 = 0


class BandedAttention(torch.autograd.Function):
    """`BandedAttention.apply(q, kpad, vpad, rel, window)` -> (out, probs):
    forward `banded_attention_fwd`, backward `banded_attention_bwd`; rel
    (H, Dh, window) is required (counterpart of the JAX package's `custom_vjp`,
    `reconvat_tpu/nn/attention.py:banded_attention_pallas`). The
    probabilities are an output but not differentiable: no loss reads
    them. The backward is first order only: VAT detaches its direction, so
    nothing differentiates through a gradient of this op. With bf16 q, k
    and v it returns dq, dk and dv in bf16 and drel in fp32."""

    @staticmethod
    def forward(ctx, q, kpad, vpad, rel, window: int):
        out, probs = banded_attention_fwd(q, kpad, vpad, rel, window)
        ctx.save_for_backward(q, kpad, vpad, rel)
        ctx.window = window
        ctx.mark_non_differentiable(probs)
        return out, probs

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out, d_probs):
        del d_probs
        q, kpad, vpad, rel = ctx.saved_tensors
        return (*banded_attention_bwd(q, kpad, vpad, rel,
                                      d_out.contiguous(), ctx.window),
                None)
