#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `reconvat_tpu_torch/csrc/` with nvcc,
holds each kernel against its plain PyTorch version at the full-width
shapes of the serving and training paths and times it, then drives the
serving path (`serve.transcribe_batch` over `ReconVAT`, random weights from
a fixed seed) on 8 clips of 20.48 s, once through the kernels and once
through the plain versions, and checks that both agree and that the
kernels ran; then the same in bf16 mixed precision
(`ReconVAT(compute_dtype='bfloat16')`, the same weights), timed in turns
with fp32. Then it drives the training path (`train.state.
make_train_step`: semi-supervised VAT with reconstruction, B = 8 labeled +
8 unlabeled clips of 20.48 s), in fp32 and then in bf16 timed in turns
with fp32, counts each kernel's launches per step, profiles it, and holds
one step through the kernels against the same step through the plain
versions, and the card against the CPU. Between the two it runs the
transcription CLI (`reconvat_tpu_torch.transcribe_files`, phase 10) on
`Application/Input` from a saved `.pt`, through the kernels and through the
plain versions, bucketed and exact, with the native note decoder, and
streams a 5-minute song in haloed windows (phase 10b) against its bucketed
transcription; each kernel is first held against its plain version at the
CLI's and the streaming's shapes (phase 10a). Last, it runs the training CLI
(`reconvat_tpu_torch.train_UNet_VAT`) at its defaults on a synthetic MAPS
and MAESTRO corpus it writes (phase 11: 2 epochs of 10 bf16 VAT steps,
logging, a checkpoint, the full-song evaluation, then a resume from the
checkpoint), evaluates its final weights in fp32 through the kernels and
the plain versions (phase 11a), runs one epoch each with the batched VAT
chain and with the adversarial forward recomputed (phase 11b), and holds
the bf16 attention kernels against their plain versions at the other
shapes that run gives them (phase 11c).

Prints one line per phase, then a `{"kernels": [...]}` JSON line, the
card's name and power limit, and as its last line
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
there is no CUDA device, when the port's package is not beside this file,
or when any check fails. Imports nothing of JAX or of `reconvat_tpu`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12          # tensor cores
PEAK_BYTES = 3.35e12

B, SAMPLES = 8, 327680            # 8 clips of 20.48 s -> 640 frames
H, W = 4, 31                      # attention heads, window
MEL_TOL = dict(rtol=1e-4, atol=1e-6)
TRUTH_FACTOR = 1.5                # kernel vs fp32 plain, error against float64
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 attention kernel vs its bf16 plain version: probs are fp32 in both
# (atol 1e-5, rtol 0); out is rounded to bf16 once in both, from fp32 sums
# taken in another order, and a p on a rounding boundary may round the
# other way: one bf16 ulp of |out| (2**-7 relative) plus 1e-3 of max |out|;
# and at most 1 % of the out elements may differ at all: fp32 sums in
# another order round the other way for ~1e-4 of them, while a kernel that
# skips the rounding of p moves ~40 % (tests/test_torch_kernels.py,
# test_bf16_out_share_sees_unrounded_p)
ATTN_BF16_PROBS_ATOL = 1e-5
ATTN_BF16_OUT_RTOL, ATTN_BF16_OUT_FLOOR = 2.0 ** -7, 1e-3
ATTN_BF16_OUT_MOVED = 1e-2
# bf16 attention backward (both passes) vs its bf16 plain version: dq, dk
# and dv are bf16 and take the rule of bf16 out above. Both sides round dS
# and p to bf16 before their products; where the two sides' fp32 dS lies on
# either side of a bf16 rounding boundary, one term of a sum moves by a
# bf16 ulp of dS. The first pass's partials are fp32 sums over at most 32
# rows: each within 2**-7 of its max |ref| everywhere, and at most 1 % of
# its elements further than 1e-5 of max |ref| (the fp32 gradients' atol)
# from it; another order moves ~0.03 % of them that far, by up to ~8e-4 of
# max |ref|, while a backward that skips the rounding of dS (or of p) moves
# 80-93 %. drel sums over all B x L rows of a head, so such moves fall in
# most of its columns: it is held to 5e-4 of its max |ref|, where another
# order reads up to 2.3e-4 and a missing rounding of dS 1.6e-3 (measured
# on the CPU at B=2..8 x 640 frames; tests/test_torch_kernels.py,
# test_bf16_bwd_rule_sees_unrounded_ds_and_p)
ATTN_BF16_DREL_RTOL = 5e-4
ATTN_BF16_FP32_CAP, ATTN_BF16_FP32_ATOL = 2.0 ** -7, 1e-5
# attention gradients over their max |.|: fp32 both sides, dk/dv add up to
# 31 terms per row and drel 5120 rows per head in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the fp32 forward and backward (3xTF32 tensor cores) against their float64
# versions: the largest error, per output, at most this many times the fp32
# plain version's. The TF32 split keeps about 2**-22 of relative error per
# product where fp32 keeps 2**-24 (tests/test_torch_kernels.py,
# TF32X3_TRUTH_FACTOR)
TF32X3_TRUTH_FACTOR = 4.0
POST_ATOL = 1e-4                  # posteriogram, plain vs kernel path
# bf16 serving, on the posteriogram and on the transcriber's attention
# output h of one batch: the bf16 route under test (the kernels, or the
# card) against the bf16 reference route (the plain versions, or the CPU)
# may differ by BF16_FACTOR x the reference's own bf16-vs-fp32 gap plus
# the two routes' fp32 gap, all measured in the run on the same input and
# none of them on the route under test. bf16 rounding moves each route
# from its fp32 result by about that gap, in other places, so twice it
# covers two roundings that fall apart.
BF16_FACTOR = 2.0
# train step, kernels vs plain versions (fp32): losses rtol 1e-3, since
# the LDS terms go through the VAT direction, a finite difference of size
# ~xi that turns fp32 rounding into ~1e-4 relative loss differences
STEP_LOSS_RTOL = 1e-3
# bf16 train step (phases 8b, 9b), losses and gradient leaves: the rule of
# BF16_FACTOR, with the reference route's bf16-vs-fp32 gap read as the
# largest over the batch and BF16_DRAWS copies of it whose audio is
# perturbed by 1e-3 (relative). At random init in train mode the step
# amplifies a bf16 rounding by orders of magnitude (train-mode BatchNorm on
# near-constant signals, a nearly one-hot softmax), so a loss's bf16 error
# is a draw of a rounding noise, and one draw of a scalar says little about
# the noise's scale (tests/test_torch_bf16_train.py). Gradient leaves also
# take phase 8's floor, GRAD_FLOOR of the largest gradient magnitude: the
# bias of a convolution that feeds a train-mode BatchNorm has a true
# gradient of zero, and each route's is a sum of terms that cancel, taken
# in its own order.
BF16_DRAWS, BF16_DRAW_PROBE = 5, 1e-3
# bf16 train step, the card against the CPU (phase 9b), on phase 9's short
# clip (no VAT) at the fp32 model's weights and BF16_9B_DRAWS copies of
# them perturbed by BF16_DRAW_PROBE (relative), each through the card and
# the CPU in bf16 and in fp32. The rule reads the predictions the losses
# are made of (reconstruction, frame, frame2), the rms gap of each draw,
# and medians over the draws. Upper: median |card bf16 - CPU bf16| <=
# BF16_FACTOR x median |CPU bf16 - CPU fp32| + the largest |card fp32 -
# CPU fp32|. Lower: median |card bf16 - card fp32| >= median |CPU bf16 -
# CPU fp32| / BF16_MOVE_FLOOR: a route that leaves out a bf16 cast lands
# near its fp32 result, so it is no further from the CPU's bf16 than the
# CPU's own gap and only the lower bound sees it (with the convolutions
# left in fp32 the reconstruction and the frame posteriogram move 0.09 and
# 0.05 of the CPU's gap; tests/test_torch_smoke_rules.py). The draws
# perturb the weights, not the audio: medians over 10 audio copies failed
# in 2 of 6 runs at this phase's weights (the card's bf16 gap 2.65x, and
# 0.23x, the CPU's), while weight draws held in 7 runs (upper share at
# most 0.79) and in 8 weight states of `python -m
# reconvat_tpu_torch.train.bf16_card_rule` (at most 0.67; PERF.md §6).
# The losses, means of terms that cancel, are printed with the old rule's
# share of its limit, not held.
BF16_9B_DRAWS = 10
BF16_MOVE_FLOOR = 4.0
# VAT in the bf16 comparisons: at the default xi (1e-6) the perturbation is
# rounded away at the first convolution's cast and the bf16 direction is
# zero; at 0.1 the JAX package's bf16 direction carries its fp32 one
# (tests/test_torch_bf16_train.py)
BF16_VAT_XI = 0.1
# gradients: the step's gradient is ill-conditioned at random init (the
# reconstructor and the second transcriber pass normalize near-constant
# signals in train-mode BatchNorm), so each leaf is held to the plain
# route's own movement under a 1e-6 (relative) perturbation of the audio,
# x PROBE_FACTOR, plus 5e-4 of the largest gradient magnitude: a bias
# gradient sums up to 8 x 640 x 229 terms that cancel, and the routes sum
# them in other orders, an fp32 rounding that no relative bound and no
# input probe sees
PROBE, PROBE_FACTOR, GRAD_FLOOR = 1e-6, 3.0, 5e-4
# the transcription CLI (phase 10): its default bucket; streaming (phase
# 10b): the CLI's windows and halo, a synthetic song of SONG_SECONDS, held
# against the bucketed transcribe of the song by the bounds of the JAX
# package's test (tests/test_streaming_transcribe.py:41-42): the
# posteriogram tolerance inside, 1e-3 over the last STREAM_TAIL frames,
# where the last window pads past the song end otherwise than the bucket
CLI_BUCKET = 512
STREAM_W, STREAM_H, SONG_SECONDS = 640, 128, 300.0
STREAM_TAIL, STREAM_TAIL_ATOL = 64, 1e-3
# the training CLI (phases 11-11b): its defaults (flagship, bf16, VAT,
# batch_size 8 unlabeled, train_batch_size 1, 327,680-sample crops, 10
# iterations an epoch) on a synthetic corpus of CORPUS_SECONDS songs in the
# MAPS and MAESTRO layouts, with these overrides only
TRAIN_CLI = dict(train_on="MAPS", small=True, epoches=2, logging_freq=1,
                 saving_freq=2)
CORPUS_SECONDS = 24.0
# the keys of the JAX package's result_dict (`evaluate_wo_velocity`,
# reconstruction=False, on eval-mode `run_on_batch` losses)
RESULT_KEYS = [
    "loss/test_LDS_l", "loss/test_frame", "loss/test_r_norm_l",
    "metric/note/precision", "metric/note/recall", "metric/note/f1",
    "metric/note/overlap", "metric/note-with-offsets/precision",
    "metric/note-with-offsets/recall", "metric/note-with-offsets/f1",
    "metric/note-with-offsets/overlap", "metric/frame/f1",
    "metric/MusicNet/micro_avg_P", "metric/frame/precision",
    "metric/frame/recall", "metric/frame/accuracy",
    "metric/frame/substitution_error", "metric/frame/miss_error",
    "metric/frame/false_alarm_error", "metric/frame/total_error",
    "metric/frame/chroma_precision", "metric/frame/chroma_recall",
    "metric/frame/chroma_accuracy", "metric/frame/chroma_substitution_error",
    "metric/frame/chroma_miss_error", "metric/frame/chroma_false_alarm_error",
    "metric/frame/chroma_total_error"]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """Least time on the card (ms) and what sets it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, with the 50 MB L2
    flushed (64 MB writes) before each, timed by CUDA events. Several
    flushes are queued ahead of the start event, so the host has enqueued
    the launch before the card gets there: a wrapper's host time is not in
    the time of a kernel shorter than it."""
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


def host_us(fn, calls: int = 100) -> float:
    """Mean host time of one fn() call (microseconds): what the caller's
    thread spends enqueuing it, the card's work not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_close(name, got, ref, tol) -> float:
    err = (got - ref).abs().max().item()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got, ref, **tol):
        fail(f"{name}: max abs err {err} outside {tol}")
    return err


def tonal_clip():
    """A 440 Hz sine at 0.1 whose second half is silent: near-empty mel bins
    hold rounding leakage only, so no relative bound applies to them."""
    t = torch.arange(SAMPLES - 1, device="cuda", dtype=torch.float64) / 16000
    x = (0.1 * torch.sin(2 * np.pi * 440 * t)).float().repeat(B, 1)
    x[:, x.shape[1] // 2:] = 0
    return x


def phase_mel(fe):
    from reconvat_tpu_torch.ops.mel_kernel import (mel_power,
                                                   mel_power_fft_plain,
                                                   mel_power_plain)

    rng = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, SAMPLES - 1), generator=rng, device="cuda") * 0.1
    hop = fe.stft.hop_length
    args = (fe.stft.wcos, fe.stft.wsin, fe.mel_basis, hop)
    args64 = tuple(a.double() for a in args[:3]) + (hop,)

    def kernel(audio=x):
        return mel_power(audio, *args, fe.stft.window, fe.twiddle, fe.band)

    got = kernel()
    torch.cuda.synchronize()
    ref = mel_power_plain(x, *args)
    err = check_close("mel_power", got, ref, MEL_TOL)
    T, n_mels = got.shape[1:]
    n_fft, n_freq = fe.stft.wcos.shape
    if (T, n_mels) != (640, 229):
        fail(f"mel_power shape {tuple(got.shape)}")
    # the kernel against the step-by-step model of its own arithmetic
    model_err = check_close(
        "mel_power vs mel_power_fft_plain", got,
        mel_power_fft_plain(x, fe.stft.window, fe.mel_basis, hop), MEL_TOL)

    # second yardstick: float64 mel_power_plain is the truth, and the kernel
    # may be no further from it than fp32 mel_power_plain is (x TRUTH_FACTOR)
    truth_log = []
    for label, audio in (("noise", x), ("tonal", tonal_clip())):
        truth = mel_power_plain(audio.double(), *args64)
        k_err = (kernel(audio).double() - truth).abs().max().item()
        p_err = (mel_power_plain(audio, *args).double()
                 - truth).abs().max().item()
        if not k_err <= TRUTH_FACTOR * p_err:
            fail(f"mel_power on the {label} clip is {k_err} from float64, "
                 f"fp32 mel_power_plain {p_err}")
        truth_log.append(f"{label}: kernel {k_err}, fp32 plain {p_err} "
                         f"(largest value {truth.max().item()})")
        del truth
    window = torch.hann_window(n_fft, periodic=True, device="cuda")

    def library():
        spec = torch.stft(x, n_fft, hop, window=window, center=True,
                          pad_mode="reflect",
                          return_complex=True).abs().square()
        return spec.transpose(1, 2) @ fe.mel_basis

    lib_err = (library() - ref).abs().max().item()
    # the least work these inputs need: a real FFT per frame (about
    # 1.25 n log2 n operations) and a multiply-add per nonzero of the mel
    # basis that was passed in; audio, window, mel basis read once, the
    # output written once
    nnz = int((fe.mel_basis != 0).sum().item())
    flops = B * T * (1.25 * n_fft * np.log2(n_fft) + 2 * nnz)
    nbytes = 4 * (x.numel() + n_fft + n_freq * n_mels + got.numel())
    bound_ms, bound_by = bound(flops, nbytes)
    # history only, no bound of the function: the count with a complex FFT
    # per frame and a dense mel product, and that of the DFT-as-GEMM design
    # this kernel replaced
    dense_flops = B * T * (2.5 * n_fft * np.log2(n_fft)
                           + 2 * n_freq * n_mels)
    dense_ms, _ = bound(dense_flops, nbytes)
    gemm_flops = B * T * (2 * 2 * n_fft * n_freq + 2 * n_freq * n_mels)
    gemm_bytes = nbytes + 4 * (2 * n_fft * n_freq - n_fft)
    gemm_bound_ms, gemm_bound_by = bound(gemm_flops, gemm_bytes)
    row = dict(
        name="mel_power", route="cuda", source="reconvat_tpu_torch/csrc/mel.cu",
        cuda_kernels=["mel_fft_kernel"],
        replaces="reconvat_tpu/ops/pallas_mel.py:36",
        max_abs_err=err, ms=time_ms(kernel),
        plain_ms=time_ms(lambda: mel_power_plain(x, *args)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library))
    log(f"phase 2 mel_power (B={B}, N={SAMPLES - 1}) -> {tuple(got.shape)}: "
        f"max_abs_err {err} (tol {MEL_TOL}), vs its step-by-step model "
        f"{model_err}, library (torch.stft) err {lib_err}; error against "
        f"float64 mel_power_plain (kernel within {TRUTH_FACTOR}x of fp32 "
        f"plain): {'; '.join(truth_log)}; host us per call: wrapper "
        f"{host_us(kernel)}, plain "
        f"{host_us(lambda: mel_power_plain(x, *args))}; ms {row['ms']}, "
        f"plain_ms "
        f"{row['plain_ms']}, library_ms {row['library_ms']}, bound_ms "
        f"{bound_ms} ({bound_by}; {flops / 1e9} GFLOP with the basis's {nnz} "
        f"nonzeros, {nbytes / 1e6} MB; history, not bounds: with a complex "
        f"FFT per frame and a dense mel product {dense_flops / 1e9} GFLOP, "
        f"{dense_ms} ms; as a DFT GEMM {gemm_flops / 1e9} GFLOP, "
        f"{gemm_bytes / 1e6} MB, {gemm_bound_ms} ms, {gemm_bound_by})")
    return row


def attention_inputs():
    """q, kpad, vpad, rel and an output gradient at the full width of the
    model's attention (B=8, L=640, H=4, Dh=229, W=31), from a seed."""
    import torch.nn.functional as F

    L, D, hw = 640, 229, (W - 1) // 2
    rng = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=rng, device="cuda") * scale

    q = randn(B, L, H, D, scale=D ** -0.25)
    kpad = F.pad(randn(B, L, H, D, scale=D ** -0.25), (0, 0, 0, 0, hw, hw))
    vpad = F.pad(randn(B, L, H, D), (0, 0, 0, 0, hw, hw))
    rel = randn(H, D, W, scale=0.1 * D ** -0.25)
    d_out = randn(B, L, H, D)
    return q, kpad, vpad, rel, d_out


def sdpa_inputs(q, kpad, vpad, rel):
    """The library yardstick's operands: SDPA over the padded sequence
    with a dense additive mask carrying the band and the skewed q.rel
    bias (built untimed)."""
    L = q.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kpad, vpad))
    qrel = torch.einsum("blhd,hdw->bhlw", q, rel)
    mask = torch.full((B, H, L, L + W - 1), float("-inf"), device="cuda")
    cols = torch.arange(L, device="cuda")[:, None] + torch.arange(
        W, device="cuda")
    mask.scatter_(3, cols.expand(B, H, L, W), qrel)
    return qh, kh, vh, mask


def phase_attention(q, kpad, vpad, rel):
    import torch.nn.functional as F

    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention, banded_attention_fwd)

    L, D = q.shape[1], q.shape[3]
    out, probs = banded_attention_fwd(q, kpad, vpad, rel, W)
    torch.cuda.synchronize()
    ref_out, ref_probs = banded_attention(q, kpad, vpad, rel, W)
    err_out = check_close("attention out", out, ref_out, ATTN_TOL)
    err_p = check_close("attention probs", probs, ref_probs, ATTN_TOL)
    truth = nearer_float64(
        "banded_attention_fwd", (out, probs), (ref_out, ref_probs),
        banded_attention(*(t.double() for t in (q, kpad, vpad, rel)), W),
        ("out", "probs"))

    qh, kh, vh, mask = sdpa_inputs(q, kpad, vpad, rel)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              scale=1.0)

    lib_err = (library().transpose(1, 2) - ref_out).abs().max().item()
    flops = B * L * H * W * (3 * 2 * D + 5)
    nbytes = 4 * (q.numel() + kpad.numel() + vpad.numel() + rel.numel()
                  + out.numel() + probs.numel())
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(
        name="banded_attention_fwd", route="cuda",
        source="reconvat_tpu_torch/csrc/banded_attention.cu",
        cuda_kernels=["banded_attention_fwd_tf32x3_kernel"],
        replaces="reconvat_tpu/ops/pallas_attention.py:56",
        max_abs_err=max(err_out, err_p),
        ms=time_ms(lambda: banded_attention_fwd(q, kpad, vpad, rel, W)),
        plain_ms=time_ms(lambda: banded_attention(q, kpad, vpad, rel,
                                                         W)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library))
    log(f"phase 3 banded_attention_fwd (B={B}, L={L}, H={H}, Dh={D}, W={W}): "
        f"max_abs_err out {err_out} probs {err_p} (tol {ATTN_TOL}); against "
        f"float64, the kernel's and the fp32 plain version's largest error "
        f"over max|truth| (kernel / plain at most {TF32X3_TRUTH_FACTOR}) "
        f"{truth}; library "
        f"(SDPA, dense mask) err {lib_err}, ms {row['ms']}, plain_ms "
        f"{row['plain_ms']}, library_ms {row['library_ms']}, bound_ms "
        f"{bound_ms} ({bound_by}; {flops / 1e9} GFLOP, {nbytes / 1e6} MB)")
    return row


def check_bf16_fwd(name, got, ref) -> tuple:
    """The bf16 forward's (out, probs) against its bf16 plain version's:
    probs within ATTN_BF16_PROBS_ATOL, out by the rule of bf16 out;
    returns (out's max abs err, probs', the share of out elements not
    equal)."""
    (out, probs), (ref_out, ref_probs) = got, ref
    if out.dtype != torch.bfloat16 or probs.dtype != torch.float32:
        fail(f"{name} returned {out.dtype} out, {probs.dtype} probs")
    err_p = check_close(f"{name} probs", probs, ref_probs,
                        dict(rtol=0.0, atol=ATTN_BF16_PROBS_ATOL))
    out, ref_out = out.float(), ref_out.float()
    gap = (out - ref_out).abs()
    err_out = gap.max().item()
    allowed = (ATTN_BF16_OUT_RTOL * ref_out.abs()
               + ATTN_BF16_OUT_FLOOR * ref_out.abs().max())
    if not torch.isfinite(out).all() or bool((gap > allowed).any()):
        fail(f"{name} out: max abs err {err_out} outside "
             f"{ATTN_BF16_OUT_RTOL} |ref| + {ATTN_BF16_OUT_FLOOR} max|ref|")
    ulp_moves = (gap > 0).float().mean().item()
    if ulp_moves > ATTN_BF16_OUT_MOVED:
        fail(f"{name} out: {ulp_moves} of the elements differ from the "
             f"plain version (at most {ATTN_BF16_OUT_MOVED})")
    return err_out, err_p, ulp_moves


def phase_attention_bf16(q, kpad, vpad, rel):
    """Kernel 2's bf16-operand variant (q, kpad, vpad, out bf16; rel, probs
    fp32) against its bf16 plain version, on phase 3's inputs rounded to
    bf16."""
    import torch.nn.functional as F

    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention, banded_attention_fwd)

    q, kpad, vpad = (t.to(torch.bfloat16) for t in (q, kpad, vpad))
    L, D = q.shape[1], q.shape[3]
    out, probs = banded_attention_fwd(q, kpad, vpad, rel, W)
    torch.cuda.synchronize()
    ref = banded_attention(q, kpad, vpad, rel, W)
    err_out, err_p, ulp_moves = check_bf16_fwd("bf16 attention", (out, probs),
                                               ref)
    ref = ref[0].float()

    # library yardstick: SDPA on the bf16 operands, the dense band mask
    # (band and q.rel bias) made in fp32 and cast to bf16
    qh, kh, vh, mask = (t.to(torch.bfloat16) for t in sdpa_inputs(
        q.float(), kpad.float(), vpad.float(), rel))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              scale=1.0)

    lib_err = (library().transpose(1, 2).float() - ref).abs().max().item()
    flops = B * L * H * W * (3 * 2 * D + 5)
    nbytes = (2 * (q.numel() + kpad.numel() + vpad.numel() + out.numel())
              + 4 * (rel.numel() + probs.numel()))
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    row = dict(
        name="banded_attention_fwd_bf16", route="cuda",
        source="reconvat_tpu_torch/csrc/banded_attention.cu",
        cuda_kernels=["banded_attention_fwd_mma_kernel"],
        replaces="reconvat_tpu/ops/pallas_attention.py:56",
        max_abs_err=max(err_out, err_p),
        ms=time_ms(lambda: banded_attention_fwd(q, kpad, vpad, rel, W)),
        plain_ms=time_ms(lambda: banded_attention(q, kpad, vpad, rel, W)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library))
    log(f"phase 3d banded_attention_fwd in bf16 (B={B}, L={L}, H={H}, "
        f"Dh={D}, W={W}; q, kpad, vpad, out bf16, rel and probs fp32): "
        f"max_abs_err out {err_out} (within {ATTN_BF16_OUT_RTOL} |ref| + "
        f"{ATTN_BF16_OUT_FLOOR} max|ref|, max|ref| "
        f"{ref.abs().max().item()}; share of out elements not equal "
        f"{ulp_moves}, at most {ATTN_BF16_OUT_MOVED}) probs {err_p} (atol "
        f"{ATTN_BF16_PROBS_ATOL}), library (SDPA in bf16, dense bf16 mask) "
        f"err {lib_err}, ms {row['ms']}, "
        f"plain_ms {row['plain_ms']}, library_ms {row['library_ms']}, "
        f"bound_ms {bound_ms} ({bound_by}; {flops / 1e9} GFLOP at the bf16 "
        f"peak, {nbytes / 1e6} MB)")
    return row


def check_grads(name, got, ref, labels) -> float:
    """Each gradient against its plain version over its max |.|, at
    GRAD_TOL; returns the largest absolute error."""
    err = 0.0
    for label, a, b in zip(labels, got, ref):
        scale = max(b.abs().max().item(), 1e-30)
        check_close(f"{name} {label}", a / scale, b / scale, GRAD_TOL)
        err = max(err, (a - b).abs().max().item())
    return err


def nearer_float64(name, got, plain, truth, labels) -> dict:
    """Each output's largest error against the float64 `truth`, over
    max|truth|, for the kernel and the fp32 plain version; fails where
    the kernel's is above TF32X3_TRUTH_FACTOR x the plain version's."""
    read = {}
    for label, a, b, t in zip(labels, got, plain, truth):
        top = t.abs().max().item()
        err = (a.double() - t).abs().max().item()
        plain_err = (b.double() - t).abs().max().item()
        if not err <= TF32X3_TRUTH_FACTOR * plain_err:
            fail(f"{name} {label}: error against float64 {err}, "
                 f"{TF32X3_TRUTH_FACTOR} x the fp32 plain version's "
                 f"{plain_err} at most")
        read[label] = (err / top, plain_err / top)
    return read


def phase_attention_bwd(q, kpad, vpad, rel, d_out):
    """Kernel 3 (both passes) and kernel 4 (the first pass alone) against
    their plain versions at the model's full width."""
    import torch.nn.functional as F

    from reconvat_tpu_torch.ops import banded_attention_kernel as bak

    L, D = q.shape[1], q.shape[3]
    args = (q, kpad, vpad, rel, d_out, W)
    args64 = (*(t.double() for t in args[:5]), W)
    got = bak.banded_attention_bwd(*args)
    torch.cuda.synchronize()
    plain = bak.banded_attention_bwd_plain(*args)
    labels = ("dq", "dk", "dv", "drel")
    err = check_grads("banded_attention_bwd", got, plain, labels)
    truth = nearer_float64("banded_attention_bwd", got, plain,
                           bak.banded_attention_bwd_plain(*args64), labels)
    parts = bak.banded_attention_bwd_partials(*args)
    torch.cuda.synchronize()
    plain_p = bak.banded_attention_bwd_partials_plain(*args)
    labels_p = ("dq", "dk_part", "dv_part", "drel_part")
    err_p = check_grads("banded_attention_bwd_partials", parts, plain_p,
                        labels_p)
    truth_p = nearer_float64(
        "banded_attention_bwd_partials", parts, plain_p,
        bak.banded_attention_bwd_partials_plain(*args64), labels_p)
    del plain, plain_p

    # library yardstick: the gradient of SDPA with the dense band mask
    # (dq, dk, dv; the mask's q.rel bias is a constant there)
    qh, kh, vh, mask = (t.detach().requires_grad_(i < 3) for i, t in
                        enumerate(sdpa_inputs(q, kpad, vpad, rel)))
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                         scale=1.0)
    g = d_out.transpose(1, 2)

    def library():
        return torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)

    flops = B * L * H * W * (15 * D + 10)
    inputs = sum(t.numel() for t in args[:5])
    nbytes = 4 * (inputs + sum(t.numel() for t in got))
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(
        name="banded_attention_bwd", route="cuda",
        source="reconvat_tpu_torch/csrc/banded_attention_bwd.cu",
        cuda_kernels=["bwd_partials_tf32x3_kernel",
                      "bwd_overlap_add_kernel<float>", "bwd_drel_sum_kernel"],
        replaces="reconvat_tpu/ops/pallas_attention_bwd.py:37",
        max_abs_err=err, ms=time_ms(lambda: bak.banded_attention_bwd(*args)),
        plain_ms=time_ms(lambda: bak.banded_attention_bwd_plain(*args)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(library))
    p_flops = flops - B * L * H * W * 10
    p_bytes = 4 * (inputs + sum(t.numel() for t in parts))
    p_bound_ms, p_bound_by = bound(p_flops, p_bytes)
    row_p = dict(
        name="banded_attention_bwd_partials", route="cuda",
        source="reconvat_tpu_torch/csrc/banded_attention_bwd.cu",
        cuda_kernels=["bwd_partials_tf32x3_kernel"],
        replaces="tools/bench_attention_parts.py:73",
        max_abs_err=err_p,
        ms=time_ms(lambda: bak.banded_attention_bwd_partials(*args)),
        plain_ms=time_ms(
            lambda: bak.banded_attention_bwd_partials_plain(*args)),
        bound_ms=p_bound_ms, bound_by=p_bound_by, library_ms=None)
    log(f"phase 3b banded_attention_bwd (B={B}, L={L}, H={H}, Dh={D}, "
        f"W={W}): max_abs_err {err} (tol {GRAD_TOL} over each gradient's "
        f"max); against float64, the kernel's and the fp32 plain version's "
        f"largest error over max|truth| by output (kernel / plain at most "
        f"{TF32X3_TRUTH_FACTOR}) {truth}; ms {row['ms']}, plain_ms "
        f"{row['plain_ms']}, library_ms "
        f"(autograd.grad of SDPA, dense mask) {row['library_ms']}, bound_ms "
        f"{bound_ms} ({bound_by}; {flops / 1e9} GFLOP, {nbytes / 1e6} MB)")
    log(f"phase 3c banded_attention_bwd_partials (first pass alone): "
        f"max_abs_err {err_p}; against float64 {truth_p}; ms "
        f"{row_p['ms']}, plain_ms "
        f"{row_p['plain_ms']}, bound_ms {p_bound_ms} ({p_bound_by}; "
        f"{p_flops / 1e9} GFLOP, {p_bytes / 1e6} MB)")
    return row, row_p


def check_bf16_grads(name, got, ref, labels) -> tuple[float, dict]:
    """A bf16-operand backward's outputs against its bf16 plain version:
    bf16 outputs by the rule of bf16 out, drel by ATTN_BF16_DREL_RTOL, the
    partials by the rule of ATTN_BF16_FP32_CAP; returns (largest abs
    error, by label the error over max|ref| and the share of elements
    moved)."""
    err, moved = 0.0, {}
    for label, a, b in zip(labels, got, ref):
        if a.dtype != b.dtype:
            fail(f"{name} {label}: {a.dtype}, its plain version {b.dtype}")
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        gap, top = (a - b).abs(), b.abs().max()
        if bf16:
            within = gap <= ATTN_BF16_OUT_RTOL * b.abs() + \
                ATTN_BF16_OUT_FLOOR * top
            share = (gap > 0).float().mean().item()
        elif label == "drel":
            within = gap <= ATTN_BF16_DREL_RTOL * top
            share = 0.0
        else:
            within = gap <= ATTN_BF16_FP32_CAP * top
            share = (gap > ATTN_BF16_FP32_ATOL * top).float().mean().item()
        if not torch.isfinite(a).all() or not bool(within.all()):
            fail(f"{name} {label}: max abs err {gap.max().item()} outside "
                 f"its bf16 rule (max|ref| {top.item()})")
        if share > ATTN_BF16_OUT_MOVED:
            fail(f"{name} {label}: {share} of the elements moved (at most "
                 f"{ATTN_BF16_OUT_MOVED})")
        err = max(err, gap.max().item())
        moved[label] = ((gap.max() / top).item(), share)
    return err, moved


def phase_attention_bwd_bf16(q, kpad, vpad, rel, d_out):
    """Kernels 3 and 4 with bf16 operands (q, kpad, vpad, d_out, dq, dk,
    dv bf16; rel, drel and the partials fp32) against their bf16 plain
    versions, on phase 3's inputs rounded to bf16."""
    import torch.nn.functional as F

    from reconvat_tpu_torch.ops import banded_attention_kernel as bak

    q, kpad, vpad, d_out = (t.to(torch.bfloat16)
                            for t in (q, kpad, vpad, d_out))
    L, D = q.shape[1], q.shape[3]
    args = (q, kpad, vpad, rel, d_out, W)
    got = bak.banded_attention_bwd(*args)
    torch.cuda.synchronize()
    if [t.dtype for t in got] != [torch.bfloat16] * 3 + [torch.float32]:
        fail(f"bf16 backward returned {[t.dtype for t in got]}")
    err, moved = check_bf16_grads("bf16 banded_attention_bwd", got,
                                  bak.banded_attention_bwd_plain(*args),
                                  ("dq", "dk", "dv", "drel"))
    parts = bak.banded_attention_bwd_partials(*args)
    torch.cuda.synchronize()
    err_p, moved_p = check_bf16_grads(
        "bf16 banded_attention_bwd_partials", parts,
        bak.banded_attention_bwd_partials_plain(*args),
        ("dq", "dk_part", "dv_part", "drel_part"))

    # library yardstick: the gradient of SDPA on the bf16 operands with the
    # dense band mask made in fp32 and cast to bf16 (dq, dk, dv)
    qh, kh, vh, mask = (t.to(torch.bfloat16).requires_grad_(i < 3)
                        for i, t in enumerate(sdpa_inputs(
                            q.float(), kpad.float(), vpad.float(), rel)))
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                         scale=1.0)
    g = d_out.transpose(1, 2)

    def library():
        return torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)

    flops = B * L * H * W * (15 * D + 10)
    inputs = 2 * sum(t.numel() for t in (q, kpad, vpad, d_out)) \
        + 4 * rel.numel()
    nbytes = inputs + 2 * sum(t.numel() for t in got[:3]) \
        + 4 * got[3].numel()
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    row = dict(
        name="banded_attention_bwd_bf16", route="cuda",
        source="reconvat_tpu_torch/csrc/banded_attention_bwd.cu",
        cuda_kernels=["bwd_partials_mma_kernel",
                      "bwd_overlap_add_kernel<__nv_bfloat16>",
                      "bwd_drel_sum_kernel"],
        replaces="reconvat_tpu/ops/pallas_attention_bwd.py:37",
        max_abs_err=err, ms=time_ms(lambda: bak.banded_attention_bwd(*args)),
        plain_ms=time_ms(lambda: bak.banded_attention_bwd_plain(*args)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(library))
    p_flops = flops - B * L * H * W * 10
    p_bytes = inputs + 2 * parts[0].numel() \
        + 4 * sum(t.numel() for t in parts[1:])
    p_bound_ms, p_bound_by = bound(p_flops, p_bytes, PEAK_BF16_FLOPS)
    row_p = dict(
        name="banded_attention_bwd_partials_bf16", route="cuda",
        source="reconvat_tpu_torch/csrc/banded_attention_bwd.cu",
        cuda_kernels=["bwd_partials_mma_kernel"],
        replaces="tools/bench_attention_parts.py:73",
        max_abs_err=err_p,
        ms=time_ms(lambda: bak.banded_attention_bwd_partials(*args)),
        plain_ms=time_ms(
            lambda: bak.banded_attention_bwd_partials_plain(*args)),
        bound_ms=p_bound_ms, bound_by=p_bound_by, library_ms=None)
    log(f"phase 3e banded_attention_bwd in bf16 (B={B}, L={L}, H={H}, "
        f"Dh={D}, W={W}; q, kpad, vpad, d_out, dq, dk, dv bf16, rel and "
        f"drel fp32): max_abs_err {err}; by output (largest error over "
        f"max|ref|, share of elements moved: bf16 differing at all, fp32 "
        f"beyond {ATTN_BF16_FP32_ATOL} max|ref|) {moved}, share at most "
        f"{ATTN_BF16_OUT_MOVED}, drel within {ATTN_BF16_DREL_RTOL} max|ref|; "
        f"ms {row['ms']}, "
        f"plain_ms {row['plain_ms']}, library_ms (autograd.grad of SDPA in "
        f"bf16, dense bf16 mask) {row['library_ms']}, bound_ms {bound_ms} "
        f"({bound_by}; {flops / 1e9} GFLOP at the bf16 peak, "
        f"{nbytes / 1e6} MB)")
    log(f"phase 3f banded_attention_bwd_partials in bf16 (first pass "
        f"alone): max_abs_err {err_p}; by output {moved_p}; ms "
        f"{row_p['ms']}, plain_ms {row_p['plain_ms']}, bound_ms "
        f"{p_bound_ms} ({p_bound_by}; {p_flops / 1e9} GFLOP, "
        f"{p_bytes / 1e6} MB)")
    return row, row_p


def serve_loop(serve, model, batches, depth: int = 2) -> dict:
    """Run every batch through the serving path with up to `depth` batches
    in flight. Returns the notes of the first batch, the total note count,
    the wall seconds, and the host seconds spent enqueuing (`submit`),
    waiting for the packed rolls, and decoding."""
    copy_stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    r = dict(first=None, notes=0, seconds=0.0, submit=0.0, wait=0.0,
             decode=0.0, batches=len(batches))

    def finish(p):
        t = time.perf_counter()
        p.packed()
        r["wait"] += time.perf_counter() - t
        t = time.perf_counter()
        notes = p.notes()
        r["decode"] += time.perf_counter() - t
        r["first"] = notes if r["first"] is None else r["first"]
        r["notes"] += sum(len(pitches) for pitches, _ in notes)

    t0 = time.perf_counter()
    pending = []
    for audio in batches:
        t = time.perf_counter()
        pending.append(serve.submit(model, audio, copy_stream))
        r["submit"] += time.perf_counter() - t
        if len(pending) == depth:
            finish(pending.pop(0))
    for p in pending:
        finish(p)
    r["seconds"] = time.perf_counter() - t0
    return r


def decode_turns(serve, model, batches) -> str:
    """Host note decode of the same packed rolls by the native decoder and
    by its numpy plain version: equal notes, ms per batch of each, timed
    in turns (native, numpy, numpy, native)."""
    from reconvat_tpu_torch import decode

    packed = [serve.submit(model, a).packed().numpy() for a in batches]
    fns = {"native": decode.extract_notes_packed_batch,
           "numpy": decode.extract_notes_packed_batch_plain}
    for p in packed:
        got, ref = (fns[k](p, rule="rule2") for k in ("native", "numpy"))
        for (gp, gi), (rp, ri) in zip(got, ref):
            if not (np.array_equal(gp, rp) and np.array_equal(
                    np.reshape(gi, (-1, 2)), np.reshape(ri, (-1, 2)))):
                fail("native and numpy note decode disagree")
    ms = {k: [] for k in fns}
    for k in ("native", "numpy", "numpy", "native"):
        t0 = time.perf_counter()
        for p in packed:
            fns[k](p, rule="rule2")
        ms[k].append((time.perf_counter() - t0) / len(packed) * 1e3)
    return (f"host decode ms/batch of the same {len(packed)} packed rolls, "
            f"in turns: native {ms['native']}, numpy {ms['numpy']}")


def per_batch(r) -> str:
    """A `serve_loop` result per batch: wall ms, audio-s/s, host ms."""
    n = r["batches"]
    ms = r["seconds"] / n * 1e3
    host = ", ".join(f"{k} {r[k] / n * 1e3}"
                     for k in ("submit", "wait", "decode"))
    return (f"{ms} ms/batch {B * SAMPLES / 16000 / (ms / 1e3)} audio-s/s "
            f"(host ms/batch: {host})")


KERNEL_GROUPS = (("mel_power", ("mel_fft_kernel",)),
                 ("banded_attention_bwd", ("bwd_partials_tf32x3_kernel",
                                           "bwd_partials_mma_kernel",
                                           "bwd_overlap_add_kernel",
                                           "bwd_drel_sum_kernel")),
                 ("banded_attention_fwd", ("banded_attention",)),
                 ("convolutions_bn", ("conv", "cudnn", "implicit", "dgrad",
                                      "wgrad", "fprop", "fft", "gemm_cf32",
                                      "bn_fw", "bn_bw", "batch_norm")),
                 ("matmuls", ("gemm", "gemv")),
                 ("copy_kernels", ("copy_kernel",)),   # dtype casts among them
                 ("copies", ("memcpy", "memset")))


def profile_groups(fn):
    """Run fn() under torch.profiler. Returns (wall s, device busy ms,
    device ms by kernel group, top kernels, device operations run: kernels,
    copies and sets), or None when the profiler recorded no device
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    kernels, n_ops = {}, 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us
        n_ops += e.count
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms == 0:
        return None
    groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    for name, us in kernels.items():
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] += us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return sec, busy_ms, groups, top, n_ops


def log_profile(label: str, unit: str, n: int, prof) -> None:
    if prof is None:
        log(f"{label}: the profiler recorded no device kernels; device "
            f"time not measured")
        return
    sec, busy_ms, groups, top, n_ops = prof
    log(f"{label}: wall {sec * 1e3 / n} ms/{unit}, device busy "
        f"{busy_ms / n} ms/{unit}, busy share {busy_ms / (sec * 1e3)}, "
        f"device operations {n_ops / n} /{unit}; "
        f"device ms/{unit} by group "
        f"{ {g: v / n for g, v in groups.items()} }; top kernels "
        f"(ms/{unit}) {[(k[:60], v / 1e3 / n) for k, v in top]}")


def phase_profile(serve, model, batches) -> None:
    """Device time by kernel over a short steady window of the serving path
    (torch.profiler) and the device's busy share of the window's wall
    time."""
    log_profile(f"phase 5 profile ({len(batches)} batches, depth 2)",
                "batch", len(batches),
                profile_groups(lambda: serve_loop(serve, model, batches)))


def phase_serve(rows):
    from reconvat_tpu_torch import serve
    from reconvat_tpu_torch.models.common import pack_roll_device
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention_fwd)
    from reconvat_tpu_torch.ops.mel_kernel import mel_power

    model = ReconVAT(seed=0)              # full width, on CUDA
    # Random init puts every sigmoid near 0.5; shift the output bias so that
    # ~2% of bins clear the threshold (trained-model sparsity), calibrated
    # on a probe batch as bench.py does.
    probe = np.random.RandomState(1).randn(4, SAMPLES) * 0.1
    p = model.transcribe(torch.tensor(probe, dtype=torch.float32,
                                      device="cuda"))["frame"]
    q98 = float(np.clip(np.quantile(p.cpu().numpy(), 0.98), 1e-4, 1 - 1e-4))
    with torch.no_grad():
        model.transcriber.linear1.bias -= float(np.log(q98 / (1 - q98)))

    rng = np.random.RandomState(0)
    n_batches = 10
    batches = [(rng.randn(B, SAMPLES) * 3276.8).astype(np.int16)
               for _ in range(n_batches)]

    # the main path: counts reset just before, read just after
    serve_loop(serve, model, batches[:2])          # warm-up
    mel_power.launches = banded_attention_fwd.launches = 0
    run = serve_loop(serve, model, batches)
    launches = {"mel_power": mel_power.launches,
                "banded_attention_fwd": banded_attention_fwd.launches}
    for name, n in launches.items():
        if n == 0:
            fail(f"serving path never launched {name}")
    model.use_kernels(False)
    serve_loop(serve, model, batches[:2])
    run_plain = serve_loop(serve, model, batches)
    # both routes once more, in turns: the host-bound wall time's spread
    # within one process
    model.use_kernels(True)
    run2 = serve_loop(serve, model, batches)
    model.use_kernels(False)
    run_plain2 = serve_loop(serve, model, batches)

    # same batch through both routes: posteriogram and packed bits
    audio = torch.tensor(batches[0], device="cuda").float() / 32768.0
    roll_plain = model.transcribe(audio)["frame"]
    model.use_kernels(True)
    roll = model.transcribe(audio)["frame"]
    if tuple(roll.shape) != (B, 640, 88) or not torch.isfinite(roll).all():
        fail(f"posteriogram {tuple(roll.shape)} not finite of (8, 640, 88)")
    diff = (roll - roll_plain).abs().max().item()
    bits, bits_plain = pack_roll_device(roll), pack_roll_device(roll_plain)
    agree = (bits == bits_plain).float().mean().item()
    on, on_plain = roll > 0.5, roll_plain > 0.5
    sure = (roll_plain - 0.5).abs() >= POST_ATOL
    if diff > POST_ATOL or bool((on != on_plain)[sure].any()):
        fail(f"kernel and plain serving disagree: posteriogram diff {diff}")
    density = on.float().mean().item()
    if not 0.001 < density < 0.2:
        fail(f"roll density {density} is not a sparse transcription")

    # the card against the CPU on a short clip: the CPU path is the one the
    # tests hold against the JAX package
    cpu = ReconVAT(seed=0, device="cpu")
    cpu.load_state_dict(model.state_dict())
    short = audio[:1, :64 * 512]
    cpu_diff = (model.transcribe(short)["frame"].cpu()
                - cpu.transcribe(short.cpu())["frame"]).abs().max().item()
    if cpu_diff > POST_ATOL:
        fail(f"CUDA and CPU posteriograms differ by {cpu_diff}")

    log(f"phase 4 serving (B={B} x {SAMPLES} int16, {n_batches} batches, "
        f"depth 2): posteriogram max abs diff kernel vs plain {diff}, packed "
        f"bits agreeing {agree}, roll density {density}, CUDA vs CPU (1 x 64 "
        f"frames) {cpu_diff}, notes decoded {run['notes']} (first batch "
        f"{sum(len(p) for p, _ in run['first'])}; plain run "
        f"{run_plain['notes']}); kernels {per_batch(run)}; plain "
        f"{per_batch(run_plain)}; second round: kernels {per_batch(run2)}; "
        f"plain {per_batch(run_plain2)}; launches {launches} over "
        f"{n_batches} batches; {decode_turns(serve, model, batches)}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_profile(serve, model, batches[:4])
    return serve, model, batches


def bf16_held(what, test16, ref16, test32, ref32):
    """The bf16 route under test against the bf16 reference route, within
    the limit BF16_FACTOR describes; returns (max abs diff, limit)."""
    def gap(a, b):
        return (a.float() - b.float()).abs().max().item()

    diff = gap(test16, ref16)
    tol = BF16_FACTOR * gap(ref16, ref32) + gap(test32, ref32)
    if not diff <= tol:
        fail(f"bf16 {what} differ by {diff} (tol {tol}: {BF16_FACTOR} x the "
             f"reference's bf16-vs-fp32 gap + the fp32 routes' gap)")
    return diff, tol


def phase_serve_bf16(row, serve, model, batches) -> None:
    """Phase 4b: the serving path in bf16 mixed precision with phase 4's
    weights (the shifted output bias included), on the same batches: the
    main path's launches, kernels against plain versions, bf16 against
    fp32, the card against the CPU, wall time in turns with fp32, and a
    profile."""
    from reconvat_tpu_torch.models.common import pack_roll_device
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention_fwd)
    from reconvat_tpu_torch.ops.mel_kernel import mel_power

    model16 = ReconVAT(seed=0, compute_dtype="bfloat16")
    model16.load_state_dict(model.state_dict(), strict=True)
    model.use_kernels(True)
    n_batches = len(batches)

    # the main path: counts reset just before, read just after
    serve_loop(serve, model16, batches[:2])          # warm-up
    mel_power.launches = banded_attention_fwd.launches = 0
    banded_attention_fwd.launches_bf16 = 0
    run16 = serve_loop(serve, model16, batches)
    launches = {"mel_power": mel_power.launches,
                "banded_attention_fwd_bf16":
                    banded_attention_fwd.launches_bf16,
                "banded_attention_fwd": banded_attention_fwd.launches}
    if 0 in (launches["mel_power"], launches["banded_attention_fwd_bf16"]):
        fail(f"bf16 serving path missed a kernel: launches {launches}")
    if launches["banded_attention_fwd"] != 0:
        fail(f"bf16 serving path launched the fp32 attention kernel: "
             f"{launches}")
    row["launches"] = launches["banded_attention_fwd_bf16"]
    # fp32 and bf16 in turns: bf16 above, then fp32, fp32, bf16
    run32 = serve_loop(serve, model, batches)
    run32b = serve_loop(serve, model, batches)
    run16b = serve_loop(serve, model16, batches)

    # one batch through four routes: bf16 and fp32, kernels and plain; the
    # posteriogram and the transcriber's attention output h of each
    audio = torch.tensor(batches[0], device="cuda").float() / 32768.0
    rolls, hs = {}, {}
    for kernels in (True, False):
        for m, dt in ((model16, "bf16"), (model, "fp32")):
            m.use_kernels(kernels)
            hook = m.transcriber.lstm1.register_forward_hook(
                lambda mod, args, out, key=(dt, kernels):
                hs.__setitem__(key, out[0]))
            rolls[dt, kernels] = m.transcribe(audio)["frame"]
            hook.remove()
    model.use_kernels(True)
    model16.use_kernels(True)
    roll = rolls["bf16", True]
    if (roll.dtype != torch.float32 or tuple(roll.shape) != (B, 640, 88)
            or not torch.isfinite(roll).all()):
        fail(f"bf16 posteriogram {roll.dtype} {tuple(roll.shape)} is not "
             f"finite fp32 of (8, 640, 88)")
    if hs["bf16", True].dtype != torch.bfloat16:
        fail(f"bf16 attention output is {hs['bf16', True].dtype}")
    gap = (roll - rolls["fp32", True]).abs().max().item()
    gap_plain = (rolls["bf16", False]
                 - rolls["fp32", False]).abs().max().item()
    if gap <= 1e-7:
        fail(f"bf16 and fp32 posteriograms are equal ({gap}): bf16 did not "
             f"run")
    diff, tol = bf16_held("kernels vs plain posteriograms", roll,
                          rolls["bf16", False], rolls["fp32", True],
                          rolls["fp32", False])
    h_diff, h_tol = bf16_held("kernels vs plain attention outputs h",
                              hs["bf16", True], hs["bf16", False],
                              hs["fp32", True], hs["fp32", False])
    h_gap = (hs["bf16", False].float() - hs["fp32", False]).abs().max().item()
    on, on_plain = roll > 0.5, rolls["bf16", False] > 0.5
    sure = (rolls["bf16", False] - 0.5).abs() >= tol
    if bool((on != on_plain)[sure].any()):
        fail(f"bf16 kernel and plain serving disagree on a packed bit "
             f"outside |p - 0.5| < {tol}")
    agree = (pack_roll_device(roll)
             == pack_roll_device(rolls["bf16", False])).float().mean().item()
    flips32 = (on != (rolls["fp32", True] > 0.5)).float().mean().item()
    density = on.float().mean().item()
    if not 0.001 < density < 0.2:
        fail(f"bf16 roll density {density} is not a sparse transcription")

    # the card against the CPU in bf16 on phase 4's short clip
    cpu16 = ReconVAT(seed=0, device="cpu", compute_dtype="bfloat16")
    cpu16.load_state_dict(model.state_dict(), strict=True)
    cpu32 = ReconVAT(seed=0, device="cpu")
    cpu32.load_state_dict(model.state_dict(), strict=True)
    short = audio[:1, :64 * 512]
    card16 = model16.transcribe(short)["frame"].cpu()
    card32 = model.transcribe(short)["frame"].cpu()
    c16 = cpu16.transcribe(short.cpu())["frame"]
    c32 = cpu32.transcribe(short.cpu())["frame"]
    cpu_diff, cpu_tol = bf16_held("card vs CPU posteriograms", card16, c16,
                                  card32, c32)

    log(f"phase 4b serving in bf16 (B={B} x {SAMPLES} int16, {n_batches} "
        f"batches, depth 2, phase 4's weights): posteriogram max abs diff "
        f"kernels vs plain {diff} (tol {tol}: {BF16_FACTOR} x the plain "
        f"route's bf16-vs-fp32 gap + the fp32 routes' gap), attention output "
        f"h kernels vs plain {h_diff} (tol {h_tol}; plain route's "
        f"bf16-vs-fp32 gap {h_gap}, max|h| "
        f"{hs['bf16', False].abs().max().item()}), packed bits agreeing "
        f"{agree}; bf16 vs fp32 max abs gap {gap} (plain routes "
        f"{gap_plain}), share of bins "
        f"on the other side of 0.5 {flips32}; roll density {density}; CUDA "
        f"vs CPU in bf16 (1 x 64 frames) {cpu_diff} (tol {cpu_tol}); notes "
        f"decoded {run16['notes']} (fp32 {run32['notes']}); launches "
        f"{launches} over {n_batches} batches; in turns: bf16 "
        f"{per_batch(run16)}; fp32 {per_batch(run32)}; fp32 "
        f"{per_batch(run32b)}; bf16 {per_batch(run16b)}; "
        f"{decode_turns(serve, model16, batches)}")
    log_profile(f"phase 5b bf16 serving profile ({len(batches[:4])} batches, "
                f"depth 2)", "batch", 4,
                profile_groups(lambda: serve_loop(serve, model16,
                                                  batches[:4])))


def train_batches(seed: int):
    """One labeled and one unlabeled batch of B clips of 20.48 s on the
    card: audio from seeded numpy, ~3 % of the frame labels active."""
    rng = np.random.RandomState(seed)
    frames = (SAMPLES - 1) // 512 + 1

    def audio():
        return torch.tensor(rng.randn(B, SAMPLES) * 0.1,
                            dtype=torch.float32, device="cuda")

    label = torch.tensor(rng.rand(B, frames, 88) < 0.03,
                         dtype=torch.float32, device="cuda")
    return {"audio": audio(), "frame": label}, {"audio": audio()}


def step_grads(model, batch_l, batch_ul, seed: int, vat: bool):
    """Losses and per-parameter gradients of one training forward and
    backward (no update), VAT directions from `seed`."""
    from reconvat_tpu_torch.models.reconvat import fp32_math
    from reconvat_tpu_torch.train.state import total_loss_from_dict

    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with fp32_math():
        _, losses, _ = model.run_on_batch(batch_l, batch_ul, gen, vat=vat,
                                          train=True)
        total_loss_from_dict(losses, 1.0).backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def compare_routes(model, batch_l, batch_ul) -> str:
    """One step's losses and gradients through the kernels against the
    same step through the plain versions, from the same state: without
    VAT (losses and every gradient), and with VAT at xi = 1e-2 from the
    same directions (losses)."""
    import copy
    import dataclasses

    plain = copy.deepcopy(model)
    plain.use_kernels(False)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def run(m, bl, bul, vat):
        m.load_state_dict(start)
        return step_grads(m, bl, bul, seed=5, vat=vat)

    lk, gk = run(model, batch_l, None, False)
    lp, gp = run(plain, batch_l, None, False)
    audio = batch_l["audio"]
    noise = torch.randn(audio.shape, device=audio.device, generator=(
        torch.Generator(device=audio.device).manual_seed(9)))
    probe = {**batch_l, "audio": audio * (1 + PROBE * noise)}
    _, gq = run(plain, probe, None, False)
    for k in lp:
        if not np.isclose(lk[k], lp[k], rtol=STEP_LOSS_RTOL, atol=1e-6):
            fail(f"train step without VAT: {k} {lk[k]} (kernels) vs "
                 f"{lp[k]} (plain)")
    top = max(g.abs().max().item() for g in gp.values())
    worst = 0.0
    for name, g in gp.items():
        diff = (gk[name] - g).abs().max().item()
        moved = (gq[name] - g).abs().max().item()
        if not torch.isfinite(gk[name]).all() or (
                diff > PROBE_FACTOR * moved + GRAD_FLOOR * top):
            fail(f"train step without VAT: gradient of {name} differs by "
                 f"{diff} (plain route moves {moved} under the probe)")
        if g.abs().max().item() > GRAD_FLOOR * top and \
                gk[name].abs().max().item() == 0:
            fail(f"kernel route lost the gradient of {name}")
        worst = max(worst, diff / top)
    cfg = model.vat_cfg
    model.vat_cfg = plain.vat_cfg = dataclasses.replace(cfg, xi=1e-2)
    lvk, _ = run(model, batch_l, batch_ul, True)
    lvp, _ = run(plain, batch_l, batch_ul, True)
    model.vat_cfg = cfg
    for k in lvp:
        if not np.isclose(lvk[k], lvp[k], rtol=STEP_LOSS_RTOL, atol=1e-6):
            fail(f"train step with VAT (xi 1e-2): {k} {lvk[k]} (kernels) "
                 f"vs {lvp[k]} (plain)")
    model.load_state_dict(start)
    unet_grad = gk["transcriber.Unet1_encoder.block1.conv1.weight"]
    return (f"without VAT: losses agree (rtol {STEP_LOSS_RTOL}), every "
            f"gradient within {PROBE_FACTOR}x the plain route's movement "
            f"under a {PROBE} audio probe + {GRAD_FLOOR} of the largest "
            f"({top}; largest gap {worst} of it), U-Net input "
            f"layer gradient max {unet_grad.abs().max().item()}; with VAT "
            f"at xi 1e-2: losses kernels {lvk} plain {lvp}")


def kernel_counters() -> dict:
    """(wrapper, counter attribute) of every row of the kernels line."""
    from reconvat_tpu_torch.ops import banded_attention_kernel as bak
    from reconvat_tpu_torch.ops.mel_kernel import mel_power

    return {"mel_power": (mel_power, "launches"),
            "banded_attention_fwd": (bak.banded_attention_fwd, "launches"),
            "banded_attention_fwd_bf16": (bak.banded_attention_fwd,
                                          "launches_bf16"),
            "banded_attention_bwd": (bak.banded_attention_bwd, "launches"),
            "banded_attention_bwd_bf16": (bak.banded_attention_bwd,
                                          "launches_bf16"),
            "banded_attention_bwd_partials":
                (bak.banded_attention_bwd_partials, "launches"),
            "banded_attention_bwd_partials_bf16":
                (bak.banded_attention_bwd_partials, "launches_bf16")}


def counted_steps(step, state, batches, gen, n_steps: int, dtype: str):
    """Run n_steps train steps with every launch count set to 0 just
    before and read just after, and peak memory reset before. Fails
    unless the step launched `mel_power` and each attention kernel of its
    dtype, and no attention kernel of the other dtype. Returns (ms/step,
    peak GB, launches, losses of the steps)."""
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f, counter in counters.values():
        setattr(f, counter, 0)
    t0 = time.perf_counter()
    losses = [step(state, *batches[i % len(batches)], gen)
              for i in range(n_steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    launches = {k: getattr(f, c) for k, (f, c) in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, n in launches.items():
        expected = name == "mel_power" or name.endswith("_bf16") == (
            dtype == "bf16")
        if (n > 0) != expected:
            fail(f"{dtype} training path launched {name} {n} times")
    if not all(np.isfinite(v.item()) for ls in losses for v in ls.values()):
        fail(f"non-finite {dtype} training loss: {losses[-1]}")
    return ms, peak_gb, launches, losses


def phase_train(rows):
    """The training path at full width: timed steps, launches per step,
    peak memory, a profile, kernels against plain versions, and the card
    against the CPU on a short clip."""
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    model = ReconVAT(seed=0)
    state = create_train_state(model)
    step = make_train_step(model, alpha=1.0, vat=True, use_unlabeled=True)
    batches = [train_batches(seed) for seed in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i in range(2):                                   # warm-up
        step(state, *batches[i % 2], gen)

    # the main path: counts reset just before, read just after
    n_steps = 6
    ms, peak_gb, launches, losses = counted_steps(step, state, batches, gen,
                                                  n_steps, "fp32")
    last = {k: v.item() for k, v in losses[-1].items()}
    per_step = {k: n / n_steps for k, n in launches.items()}
    audio_s = 2 * B * SAMPLES / 16000
    log(f"phase 6 training (B={B} labeled + {B} unlabeled x {SAMPLES} "
        f"samples, VAT + reconstruction, fp32, {n_steps} steps after 2 "
        f"warm-up): {ms} ms/step, {audio_s / (ms / 1e3)} audio-s/s "
        f"trained, peak memory {peak_gb} GB, launches per step "
        f"{per_step}, step {state.step}, last losses {last}")
    for row in rows:
        row["launches_train"] = launches[row["name"]]
        if row["name"] in ("banded_attention_bwd",
                           "banded_attention_bwd_partials"):
            row["launches"] = launches[row["name"]]

    log_profile("phase 7 training profile (2 steps)", "step", 2,
                profile_groups(lambda: [step(state, *batches[i], gen)
                                        for i in range(2)]))
    log(f"phase 8 train step, kernels vs plain versions: "
        f"{compare_routes(model, *batches[0])}")

    # the card against the CPU on a short clip, without VAT (the CPU path
    # is the one the tests hold against the JAX package)
    cpu = ReconVAT(seed=0, device="cpu")
    cpu.load_state_dict(model.state_dict())
    short_l = {k: v[:2, :32 * 512] if k == "audio" else v[:2, :32]
               for k, v in batches[0][0].items()}
    card_l, _ = step_grads(model, short_l, None, 0, vat=False)
    cpu_l, _ = step_grads(cpu, {k: v.cpu() for k, v in short_l.items()},
                          None, 0, vat=False)
    for k in cpu_l:
        if not np.isclose(card_l[k], cpu_l[k], rtol=1e-4, atol=1e-5):
            fail(f"train losses on the card and the CPU differ: {k} "
                 f"{card_l[k]} vs {cpu_l[k]}")
    log(f"phase 9 train losses, card vs CPU (2 x 32 frames, no VAT): "
        f"{card_l} vs {cpu_l}")
    return model, state, step, batches, gen, short_l


def vat_shares(model, batch_l, batch_ul, seed: int) -> str:
    """The shares of (b, t) vectors whose VAT perturbation has norm eps
    and norm 0, in the labeled and the unlabeled chain of one
    `run_on_batch` at the model's xi (the unlabeled chain rebuilt from the
    same first draw)."""
    from reconvat_tpu_torch.models.reconvat import fp32_math
    from reconvat_tpu_torch.nn.unet import frozen_batch_stats
    from reconvat_tpu_torch.vat import l2_normalize, vat_loss

    def shares(r_adv):
        norms = torch.linalg.vector_norm(r_adv.double(), dim=2)
        eps = ((norms - model.vat_cfg.eps).abs()
               <= 1e-3 * model.vat_cfg.eps).double().mean().item()
        return eps, (norms == 0).double().mean().item()

    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    with fp32_math():
        preds, _, _ = model.run_on_batch(batch_l, batch_ul, gen(), vat=True)
        spec_ul = model.make_spec(batch_ul["audio"])
        with frozen_batch_stats(model):
            _, r_ul, _ = vat_loss(model.transcribe_frames, spec_ul, gen(),
                                  model.vat_cfg)
        # where the direction comes from: two clean transcriber passes,
        # and a clean against a pass perturbed by xi (the first draw)
        with torch.no_grad(), frozen_batch_stats(model):
            y1 = model.transcribe_frames(spec_ul)
            y2 = model.transcribe_frames(spec_ul)
            d = torch.randn(spec_ul.shape, generator=gen(), device="cuda")
            r = model.vat_cfg.xi * l2_normalize(d, model.vat_cfg.norm_axis)
            y3 = model.transcribe_frames((spec_ul + r).clamp(0.0, 1.0))
    (le, lz), (ue, uz) = shares(preds["r_adv"].detach()), shares(
        r_ul[..., 0].detach())
    return (f"labeled chain {le} eps / {lz} zero, unlabeled chain {ue} eps "
            f"/ {uz} zero (unlabeled: two clean passes differ by "
            f"{(y1 - y2).abs().max().item()} in "
            f"{(y1 != y2).float().mean().item()} of the outputs, clean and "
            f"perturbed by {(y3 - y1).abs().max().item()} in "
            f"{(y3 != y1).float().mean().item()})")


def probe_batches(batch_l, batch_ul, n: int, seed: int):
    """n copies of (batch_l, batch_ul) whose audio is perturbed by
    BF16_DRAW_PROBE (relative), drawn on the audio's device."""
    g = torch.Generator(device=batch_l["audio"].device).manual_seed(seed)

    def probe(b):
        if b is None:
            return None
        a = b["audio"]
        noise = torch.randn(a.shape, generator=g, device=a.device)
        return {**b, "audio": a * (1 + BF16_DRAW_PROBE * noise)}

    return [(probe(batch_l), probe(batch_ul)) for _ in range(n)]


def held_draws(what, test16, ref16, test32, ref32, draws,
               floor: float = 0.0, gate: bool = True):
    """bf16_held for each key of the dicts (losses, or gradients by
    leaf), with the reference route's bf16-vs-fp32 gap the largest over
    (ref16, ref32) and the (bf16, fp32) pairs of `draws` (BF16_DRAWS),
    and `floor` added to each limit; returns the largest share of its
    limit that a key used, and the key. With gate False it only reads."""
    def gap(a, b):
        if isinstance(a, torch.Tensor):
            return (a.float() - b.float()).abs().max().item()
        return abs(a - b)

    worst = (0.0, "")
    for k in ref16:
        diff = gap(test16[k], ref16[k])
        ref_gap = max(gap(a[k], b[k]) for a, b in [(ref16, ref32), *draws])
        tol = BF16_FACTOR * ref_gap + gap(test32[k], ref32[k]) + floor
        if gate and not diff <= tol:
            fail(f"bf16 {what}, {k}: differ by {diff} (tol {tol}: "
                 f"{BF16_FACTOR} x the reference's bf16-vs-fp32 gap "
                 f"{ref_gap}, largest of {len(draws) + 1} draws, + the fp32 "
                 f"routes' gap + {floor})")
        worst = max(worst, (diff / tol if tol > 0 else 0.0, k))
    return worst


def median_rule(card16, cpu16, card32, cpu32):
    """Phase 9b's rule (BF16_MOVE_FLOOR) over lists of dicts, one dict per
    input, the same inputs on all four routes, each value a tensor (its
    largest elementwise gap is read) or a float. Returns (misses, by key
    the upper bound's share of its limit and the ratio of the card's
    median move to the CPU's): misses names each key that breaks either
    bound."""
    def med(a, b, k):
        return float(np.median([gap(x[k], y[k]) for x, y in zip(a, b)]))

    def gap(x, y):
        if isinstance(x, torch.Tensor):
            return (x.double() - y.double()).pow(2).mean().sqrt().item()
        return abs(x - y)

    misses, read = [], {}
    for k in cpu16[0]:
        ref_gap = med(cpu16, cpu32, k)
        fp32 = max(gap(x[k], y[k]) for x, y in zip(card32, cpu32))
        diff, move = med(card16, cpu16, k), med(card16, card32, k)
        tol = BF16_FACTOR * ref_gap + fp32
        read[k] = (diff / tol if tol > 0 else 0.0,
                   move / ref_gap if ref_gap > 0 else 1.0)
        if not (diff <= tol and move >= ref_gap / BF16_MOVE_FLOOR):
            misses.append(k)
    return misses, read


def weight_draws(state, n: int, seed: int):
    """`state` (a state_dict) and n copies of it whose parameters are
    perturbed by BF16_DRAW_PROBE (relative); buffers stay as they are."""
    g = torch.Generator().manual_seed(seed)

    def draw(name, v):
        if name.endswith(("running_mean", "running_var")) or \
                not v.is_floating_point():
            return v
        noise = torch.randn(v.shape, generator=g).to(v.device)
        return v * (1 + BF16_DRAW_PROBE * noise)

    return [state] + [{k: draw(k, v) for k, v in state.items()}
                      for _ in range(n)]


def short_step(model, batch):
    """The predictions the losses are made of (reconstruction, frame,
    frame2; fp32 copies on the CPU) and the losses of one train-mode
    forward without VAT on `batch` (moved to the model's device)."""
    from reconvat_tpu_torch.models.reconvat import fp32_math

    batch = {k: v.to(model.device) for k, v in batch.items()}
    gen = torch.Generator(device=model.device).manual_seed(0)
    with torch.no_grad(), fp32_math():
        preds, losses, _ = model.run_on_batch(batch, None, gen, vat=False,
                                              train=True)
    return ({k: preds[k].float().cpu()
             for k in ("reconstruction", "frame", "frame2")},
            {k: v.item() for k, v in losses.items()})


def compare_routes_bf16(model16, model, batch_l, batch_ul) -> str:
    """Phase 8b: one bf16 step through the kernels against the same step
    through the plain versions, from the fp32 model's state, within the
    limit of `held_draws`: without VAT losses and every gradient, with VAT
    (xi BF16_VAT_XI) losses."""
    import copy
    import dataclasses

    start = {k: v.clone() for k, v in model.state_dict().items()}
    routes = {"kernels16": model16, "kernels32": model}
    routes["plain16"] = copy.deepcopy(model16)
    routes["plain32"] = copy.deepcopy(model)
    for name, m in routes.items():
        m.use_kernels(name.startswith("kernels"))
    draws = probe_batches(batch_l, batch_ul, BF16_DRAWS, seed=13)

    def run(name, bl, bul, vat):
        m = routes[name]
        m.load_state_dict(start)
        return step_grads(m, bl, bul, seed=5, vat=vat)

    notes = []
    for vat in (False, True):
        cfgs = {n: m.vat_cfg for n, m in routes.items()}
        for m in routes.values():
            m.vat_cfg = dataclasses.replace(m.vat_cfg, xi=BF16_VAT_XI)
        bul = batch_ul if vat else None
        out = {n: run(n, batch_l, bul, vat) for n in routes}
        drawn = [tuple(run(n, dl, dul if vat else None, vat)
                       for n in ("plain16", "plain32")) for dl, dul in draws]
        for n, m in routes.items():
            m.vat_cfg = cfgs[n]
        (l16, g16), (lp16, gp16) = out["kernels16"], out["plain16"]
        (l32, g32), (lp32, gp32) = out["kernels32"], out["plain32"]
        if l16 == l32:
            fail(f"bf16 and fp32 train losses are equal ({l16}): bf16 did "
                 f"not run")
        worst = held_draws(f"train losses, kernels vs plain (VAT {vat})",
                           l16, lp16, l32, lp32,
                           [(a[0], b[0]) for a, b in drawn])
        label = f"with VAT at xi {BF16_VAT_XI}" if vat else "without VAT"
        notes.append(f"{label}: losses kernels {l16} plain {lp16} (fp32 "
                     f"kernels {l32}), largest share of a limit {worst}")
        if vat:
            continue
        for name, g in g16.items():
            if not torch.isfinite(g).all():
                fail(f"bf16 kernel route: non-finite gradient of {name}")
            if g.abs().max().item() == 0 and gp16[name].abs().max().item() > 0:
                fail(f"bf16 kernel route lost the gradient of {name}")
        top = max(g.abs().max().item() for g in gp16.values())
        worst_g = held_draws("gradients, kernels vs plain", g16, gp16, g32,
                             gp32, [(a[1], b[1]) for a, b in drawn],
                             floor=GRAD_FLOOR * top)
        notes.append(f"every gradient leaf held (floor {GRAD_FLOOR} x "
                     f"{top}), largest share of a limit {worst_g}")
    model.load_state_dict(start)
    model16.load_state_dict(start)
    return "; ".join(notes)


def phase_train_bf16(rows, model, state, step, batches, gen,
                     short_l) -> None:
    """Phases 6b-9b: the train step in bf16 mixed precision at phase 6's
    shape and settings, timed in turns with fp32 (fp32, bf16, bf16,
    fp32), its launches, peak memory and VAT direction shares, a profile,
    kernels against plain versions, and the card against the CPU."""
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    model16 = ReconVAT(seed=0, compute_dtype="bfloat16")
    state16 = create_train_state(model16)
    step16 = make_train_step(model16, alpha=1.0, vat=True,
                             use_unlabeled=True)
    for i in range(2):                                   # warm-up
        step16(state16, *batches[i % 2], gen)

    n_steps = 4
    runs = []
    for dtype in ("fp32", "bf16", "bf16", "fp32"):
        # each run is a main path: counts reset just before, read after
        if dtype == "bf16":
            runs.append(counted_steps(step16, state16, batches, gen, n_steps,
                                      dtype))
        else:
            runs.append(counted_steps(step, state, batches, gen, n_steps,
                                      dtype))
    launches = runs[1][2]
    for row in rows:
        if row["name"] in ("banded_attention_bwd_bf16",
                           "banded_attention_bwd_partials_bf16"):
            row["launches"] = launches[row["name"]]
        row["launches_train_bf16"] = launches[row["name"]]
    audio_s = 2 * B * SAMPLES / 16000
    turns = "; ".join(
        f"{dt} {ms} ms/step {audio_s / (ms / 1e3)} audio-s/s peak {gb} GB"
        for dt, (ms, gb, _, _) in zip(("fp32", "bf16", "bf16", "fp32"),
                                      runs))
    last16 = {k: v.item() for k, v in runs[2][3][-1].items()}
    shares = "; ".join(
        f"{dt}: {vat_shares(m, *batches[0], seed=3)}"
        for dt, m in (("bf16", model16), ("fp32", model)))
    log(f"phase 6b training in bf16 (B={B} labeled + {B} unlabeled x "
        f"{SAMPLES} samples, VAT + reconstruction, "
        f"compute_dtype='bfloat16', {n_steps} steps per run after 2 "
        f"warm-up), in turns: {turns}; launches per bf16 step "
        f"{ {k: n / n_steps for k, n in launches.items()} }, per fp32 step "
        f"{ {k: n / n_steps for k, n in runs[0][2].items()} }; last bf16 "
        f"losses {last16}; VAT perturbation vectors at xi "
        f"{model16.vat_cfg.xi}: {shares}")

    log_profile("phase 7b bf16 training profile (2 steps)", "step", 2,
                profile_groups(lambda: [step16(state16, *batches[i], gen)
                                        for i in range(2)]))
    log(f"phase 8b bf16 train step, kernels vs plain versions (fp32 "
        f"weights of phase 8): "
        f"{compare_routes_bf16(model16, model, *batches[0])}")

    # the card against the CPU in bf16 on phase 9's short clip at the fp32
    # model's present weights and BF16_9B_DRAWS perturbed copies of them
    cpu16 = ReconVAT(seed=0, device="cpu", compute_dtype="bfloat16")
    cpu = ReconVAT(seed=0, device="cpu")
    routes = {"card16": model16, "card32": model, "cpu16": cpu16,
              "cpu32": cpu}
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {name: [] for name in routes}
    for weights in weight_draws(start, BF16_9B_DRAWS, seed=19):
        for name, m in routes.items():
            m.load_state_dict(weights)
            runs[name].append(short_step(m, short_l))
    for m in routes.values():
        m.load_state_dict(start)
    preds = [[p for p, _ in runs[n]] for n in routes]
    card16, card32, c16, c32 = ([l for _, l in runs[n]] for n in routes)
    # the old rule: the batch at the present weights against the CPU's
    # bf16-vs-fp32 gap on it and on BF16_DRAWS audio copies
    old_draws = [tuple(short_step(m, dl)[1] for m in (cpu16, cpu))
                 for dl, _ in probe_batches(short_l, None, BF16_DRAWS,
                                            seed=17)]
    log(f"phase 9b bf16 train step, card vs CPU (2 x 32 frames, no VAT; "
        f"the present weights, then {BF16_9B_DRAWS} copies perturbed by "
        f"{BF16_DRAW_PROBE}): losses card bf16 {card16}; CPU bf16 {c16}; "
        f"card fp32 {card32}; CPU fp32 {c32}")
    old_share = held_draws("train losses, card vs CPU", card16[0], c16[0],
                           card32[0], c32[0], old_draws, gate=False)
    _, loss_read = median_rule(card16, c16, card32, c32)
    misses, read = median_rule(preds[0], preds[2], preds[1], preds[3])
    log(f"phase 9b: predictions by the median rule (median over weight "
        f"draws of the rms |card bf16 - CPU bf16| as a share of "
        f"{BF16_FACTOR} x the CPU's median bf16-vs-fp32 gap + the largest "
        f"fp32 gap; the card's median bf16-vs-fp32 gap over the CPU's, at "
        f"least 1/{BF16_MOVE_FLOOR}) {read}; not held: the losses by the "
        f"same rule {loss_read}, and by the old rule (the batch alone "
        f"against {BF16_FACTOR} x the largest of the CPU's "
        f"{BF16_DRAWS + 1} gaps over audio copies) {old_share}")
    if misses:
        fail(f"bf16 train step, card vs CPU: {misses} break the median "
             f"rule: {read}")
    log(f"phase 9b: held, largest upper share "
        f"{max(u for u, _ in read.values())}, smallest move ratio "
        f"{min(m for _, m in read.values())}")


def phase_kernels_at_cli_shapes(fe) -> None:
    """Both kernels of the CLI's path against their plain versions at the
    shapes it gives them (B x T frames): a clip exact (250, a ragged last
    tile) and bucketed (512), a streaming pass-1 chunk (W + 8), a window
    (W + 2H) alone and four stacked, and the bucketed 5-minute song."""
    import torch.nn.functional as F

    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention, banded_attention_fwd)
    from reconvat_tpu_torch.ops.mel_kernel import mel_power, mel_power_plain

    span = STREAM_W + 2 * STREAM_H
    song = -(-int(SONG_SECONDS * 16000 // 512 + 1) // CLI_BUCKET) * CLI_BUCKET
    shapes = [(1, 250), (1, CLI_BUCKET), (1, STREAM_W + 8), (1, span),
              (4, span), (1, song)]
    rng = torch.Generator(device="cuda").manual_seed(5)
    hop, hw = fe.stft.hop_length, (W - 1) // 2
    args = (fe.stft.wcos, fe.stft.wsin, fe.mel_basis, hop)
    errs = []
    for b, t in shapes:
        x = torch.randn((b, t * hop - 1), generator=rng, device="cuda") * 0.1
        got = mel_power(x, *args, fe.stft.window, fe.twiddle, fe.band)
        if tuple(got.shape) != (b, t, fe.n_mels):
            fail(f"mel_power at {b} x {t} frames gave {tuple(got.shape)}")
        mel_err = check_close(f"mel_power at {b} x {t} frames", got,
                              mel_power_plain(x, *args), MEL_TOL)
        D = fe.n_mels

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=rng, device="cuda") * scale

        q = randn(b, t, H, D, scale=D ** -0.25)
        kpad = F.pad(randn(b, t, H, D, scale=D ** -0.25),
                     (0, 0, 0, 0, hw, hw))
        vpad = F.pad(randn(b, t, H, D), (0, 0, 0, 0, hw, hw))
        rel = randn(H, D, W, scale=0.1 * D ** -0.25)
        out, probs = banded_attention_fwd(q, kpad, vpad, rel, W)
        ref_out, ref_probs = banded_attention(q, kpad, vpad, rel, W)
        attn_err = max(
            check_close(f"attention out at {b} x {t}", out, ref_out,
                        ATTN_TOL),
            check_close(f"attention probs at {b} x {t}", probs, ref_probs,
                        ATTN_TOL))
        errs.append(f"{b} x {t}: mel {mel_err}, attention {attn_err}")
    log(f"phase 10a kernels at the CLI's and streaming's shapes (B x T "
        f"frames), max abs err against the plain versions (tol "
        f"{MEL_TOL}, {ATTN_TOL}): {'; '.join(errs)}")


def same_notes(what, got, ref) -> tuple:
    """Two (T, 88) posteriograms within POST_ATOL, and equal notes on every
    pitch with no element of `ref` within POST_ATOL of 0.5. Returns (max
    abs diff, pitches set aside, notes)."""
    from reconvat_tpu_torch import decode

    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"{what}: posteriogram {got.shape} against {ref.shape}")
    diff = float(np.abs(got - ref).max())
    if diff > POST_ATOL:
        fail(f"{what}: posteriograms differ by {diff}")
    near = (np.abs(ref - 0.5) < POST_ATOL).any(axis=0)
    notes = []
    for roll in (got, ref):
        p, i = decode.extract_notes_wo_velocity(roll, roll, rule="rule2")
        p = np.asarray(p, np.int64)
        keep = ~near[p]
        notes.append((p[keep], np.reshape(i, (-1, 2))[keep]))
    if not all(np.array_equal(a, b) for a, b in zip(*notes)):
        fail(f"{what}: notes differ outside the pitches near 0.5")
    return diff, int(near.sum()), len(notes[1][0])


def perturb_stats(model, seed: int) -> None:
    """Random BatchNorm statistics and affines, and biases moved off zero,
    from `seed` (the CPU tests' `_perturb`): at the init's identity
    BatchNorm and zero biases the posteriogram hardly moves in time."""
    from torch import nn

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(t):
        return torch.randn(t.shape, generator=g, device="cuda")

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.add_(0.05 * randn(m.running_mean))
                m.weight.uniform_(0.8, 1.2, generator=g)
            if isinstance(getattr(m, "bias", None), torch.Tensor):
                m.bias.add_(0.05 * randn(m.bias))


def sharpen_output(model, clips, scale: float = 16.0) -> None:
    """Scale the output layer by `scale`, then shift each pitch's bias to
    the middle of the widest gap between consecutive logits of the clips
    (bucketed and exact, true frames) in its top 1.5-2.5 %: ~2 % active
    bins per pitch and no logit at the threshold. At random init a few
    pitches carry all the activity and sit on the threshold, where the
    notes comparison has to set them aside."""
    lin = model.transcriber.linear1
    logits = []
    with torch.no_grad():
        lin.weight *= scale
        lin.bias *= scale
        for clip in clips:
            for bucket in (CLI_BUCKET, 0):
                t_true = (clip.shape[1] - 1) // 512 + 1
                hook = lin.register_forward_hook(
                    lambda m, a, out: logits.append(out[0, :t_true]))
                model.transcribe(clip, bucket)
                hook.remove()
        z = torch.cat(logits).double().sort(dim=0).values     # (N, 88)
        lo, hi = int(0.975 * len(z)), int(0.985 * len(z))
        i = lo + (z[lo + 1:hi + 1] - z[lo:hi]).argmax(dim=0)
        pitch = torch.arange(z.shape[1], device=z.device)
        lin.bias -= ((z[i, pitch] + z[i + 1, pitch]) / 2).float()


def phase_cli(model) -> None:
    """Phase 10: the transcription CLI through its `Experiment` on
    `Application/Input`, bucketed and exact, from a `.pt` of phase 4's
    weights (statistics and biases perturbed, `perturb_stats`, and the
    output layer sharpened and shifted so that ~2 % of the clips' bins are
    active, `sharpen_output`), against `transcribe2midi` through the plain
    versions; launches per clip, ms per clip, native against numpy
    decode."""
    import filecmp
    import shutil
    import tempfile

    from reconvat_tpu_torch import decode
    from reconvat_tpu_torch import transcribe_files as cli
    from reconvat_tpu_torch.data.datasets import ApplicationDataset
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention_fwd)
    from reconvat_tpu_torch.ops.mel_kernel import mel_power

    input_path = os.path.join(HERE, "Application", "Input")
    data = ApplicationDataset(input_path)
    n_clips = len(data)
    audio_s = sum(len(d["audio"]) for d in data.data) / 16000
    kernels = ReconVAT(seed=0)
    kernels.load_state_dict(model.state_dict(), strict=True)
    perturb_stats(kernels, seed=3)
    sharpen_output(kernels, [torch.from_numpy(d["audio"])[None].cuda()
                             for d in data])
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    try:
        pt = os.path.join(tmp, "weight.pt")
        torch.save(kernels.state_dict(), pt)
        plain = ReconVAT(seed=1)
        plain.load_reference_weights(pt)
        plain.use_kernels(False)
        for bucket in (CLI_BUCKET, 0):
            out = os.path.join(tmp, f"cli_{bucket}")
            torch.cuda.synchronize()
            mel_power.launches = banded_attention_fwd.launches = 0
            decode.extract_notes_wo_velocity.calls = 0
            t0 = time.perf_counter()
            written = cli.ex.run(cli.main, dict(
                device="cuda", weight_path=pt, input_path=input_path,
                output_path=out, bucket_frames=bucket))
            cli_s = time.perf_counter() - t0
            launches = {"mel_power": mel_power.launches,
                        "banded_attention_fwd": banded_attention_fwd.launches,
                        "native decode": decode.extract_notes_wo_velocity
                        .calls}
            if set(launches.values()) != {n_clips}:
                fail(f"the CLI at bucket {bucket} made {launches} for "
                     f"{n_clips} clips (one each per clip)")
            names = [os.path.basename(w) for w, _ in written]
            if names != ["ReconVAT-clip_amid", "ReconVAT-clip_bmid"]:
                fail(f"the CLI wrote {names}")
            ref = cli.transcribe2midi(data, plain, "ReconVAT",
                                      save_path=os.path.join(tmp, "plain"),
                                      bucket_frames=bucket)
            diffs, set_aside, notes, same_bytes = [], 0, 0, 0
            for (path, roll), (ref_path, ref_roll) in zip(written, ref):
                d, s, n = same_notes(f"CLI at bucket {bucket}, {path}",
                                     roll, ref_roll)
                diffs.append(d)
                set_aside += s
                notes += n
                same_bytes += filecmp.cmp(path, ref_path, shallow=False)
            # the per-clip path warm, through the kernels: transcribe,
            # decode, MIDI
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                rolls = cli.transcribe2midi(
                    data, kernels, "ReconVAT",
                    save_path=os.path.join(tmp, "warm"),
                    bucket_frames=bucket)
            warm_s = (time.perf_counter() - t0) / reps
            dec = {"native": decode.extract_notes_wo_velocity,
                   "numpy": decode.extract_notes_wo_velocity_plain}
            dec_ms = {k: [] for k in dec}
            for k in ("native", "numpy", "numpy", "native"):
                t0 = time.perf_counter()
                for _ in range(10):
                    for _, roll in rolls:
                        dec[k](roll, roll, rule="rule2")
                dec_ms[k].append((time.perf_counter() - t0)
                                 / (10 * n_clips) * 1e3)
            density = float(np.mean([(r > 0.5).mean() for _, r in rolls]))
            log(f"phase 10 transcription CLI (bucket_frames={bucket}, "
                f"{n_clips} clips of {audio_s / n_clips} s, fp32): "
                f"posteriogram max abs diff kernels vs plain {max(diffs)} "
                f"(tol {POST_ATOL}), {notes} notes, {set_aside} pitches set "
                f"aside (an element within {POST_ATOL} of 0.5), "
                f"{same_bytes} of {n_clips} MIDI files byte-equal; density "
                f"{density}; launches {launches}; Experiment run "
                f"{cli_s * 1e3 / n_clips} ms/clip (model, weights, audio "
                f"included); warm transcribe2midi {warm_s * 1e3 / n_clips} "
                f"ms/clip, {audio_s / warm_s} audio-s/s; host decode "
                f"ms/clip in turns: native {dec_ms['native']}, numpy "
                f"{dec_ms['numpy']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_streaming(model) -> None:
    """Phase 10b: a synthetic SONG_SECONDS song (B = 1) streamed in
    STREAM_W + 2 STREAM_H windows: depth 1 and 3 identical (deterministic
    cuDNN), one and four
    windows per forward within the posteriogram tolerance, all against
    the bucketed transcribe of the song; launches per window group, peak
    device memory and audio-s/s of each."""
    from reconvat_tpu_torch.models.common import frames_in
    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention_fwd)
    from reconvat_tpu_torch.ops.mel_kernel import mel_power

    n = int(SONG_SECONDS * 16000)
    g = torch.Generator(device="cuda").manual_seed(2)
    t = torch.arange(n, device="cuda", dtype=torch.float64) / 16000
    phases = torch.rand(4, generator=g, device="cuda", dtype=torch.float64)
    sig = sum(0.2 * torch.sin(2 * np.pi * f * t + ph)
              for f, ph in zip((220.0, 440.0, 523.25, 660.0), phases))
    sig = sig * (0.5 + 0.5 * torch.sin(2 * np.pi * 0.3 * t))
    song = (sig + 0.01 * torch.randn(n, generator=g, device="cuda",
                                     dtype=torch.float64)).float()[None]
    del t, sig
    t_true = frames_in(n)
    n_windows = -(-t_true // STREAM_W)

    def run(fn):
        """(roll on the host, seconds, peak GB) of fn(), counts reset."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mel_power.launches = banded_attention_fwd.launches = 0
        t0 = time.perf_counter()
        roll = fn()["frame"].cpu()
        torch.cuda.synchronize()
        return (roll, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 1e9)

    def stream(**kw):
        return run(lambda: model.transcribe_streaming(
            song, STREAM_W, STREAM_H, **kw))

    base_gb = torch.cuda.memory_allocated() / 1e9
    stream()                                          # warm-up
    s3, sec3, gb3 = stream(pipeline_depth=3)          # the main path
    launches = {"mel_power": mel_power.launches,
                "banded_attention_fwd": banded_attention_fwd.launches}
    if launches != {"mel_power": 2 * n_windows,
                    "banded_attention_fwd": n_windows}:
        fail(f"streaming {n_windows} windows made {launches} (one mel per "
             f"pass-1 chunk and per window group, one attention per group)")
    if tuple(s3.shape) != (1, t_true, 88) or not torch.isfinite(s3).all():
        fail(f"streamed posteriogram {tuple(s3.shape)} is not finite of "
             f"(1, {t_true}, 88)")
    s1, sec1, gb1 = stream(pipeline_depth=1)
    # cuDNN's transposed convolutions (the U-Net decoder) sum in a
    # different order from run to run; with deterministic algorithms the
    # pipeline depth may change nothing
    cudnn = torch.backends.cudnn
    cudnn.deterministic = True
    try:
        det3, det1 = (stream(pipeline_depth=d)[0] for d in (3, 1))
    finally:
        cudnn.deterministic = False
    if not torch.equal(det1, det3):
        fail(f"streaming at pipeline_depth 1 and 3 differ by "
             f"{(det1 - det3).abs().max().item()} with deterministic cuDNN")
    runs_diff = (s1 - s3).abs().max().item()
    stream(windows_per_batch=4)                       # warm-up
    s4, sec4, gb4 = stream(windows_per_batch=4)
    groups4 = -(-n_windows // 4)
    if (mel_power.launches, banded_attention_fwd.launches) != (
            n_windows + groups4, groups4):
        fail(f"streaming 4 windows per forward made {mel_power.launches} "
             f"mel and {banded_attention_fwd.launches} attention launches")
    g_diff = (s4 - s1).abs().max().item()
    if g_diff > POST_ATOL:
        fail(f"streaming with 1 and 4 windows per forward differ by "
             f"{g_diff}")
    run(lambda: model.transcribe(song, CLI_BUCKET))  # warm-up
    full, sec_b, gb_b = run(lambda: model.transcribe(song, CLI_BUCKET))
    inner = (s3 - full)[:, :-STREAM_TAIL].abs().max().item()
    tail = (s3 - full)[:, -STREAM_TAIL:].abs().max().item()
    if inner > POST_ATOL or tail > STREAM_TAIL_ATOL:
        fail(f"streamed and bucketed posteriograms differ by {inner} inside "
             f"and {tail} over the last {STREAM_TAIL} frames")
    log(f"phase 10b streaming (1 x {SONG_SECONDS} s, {t_true} frames, "
        f"W={STREAM_W} H={STREAM_H}, {n_windows} windows, fp32): depth 1 "
        f"and 3 identical with deterministic cuDNN (without it the two "
        f"runs differ by {runs_diff}); 1 vs 4 windows per forward max abs diff "
        f"{g_diff} (tol {POST_ATOL}); against bucketed transcribe "
        f"(bucket {CLI_BUCKET}) {inner} inside (tol {POST_ATOL}), {tail} "
        f"over the last {STREAM_TAIL} frames (tol {STREAM_TAIL_ATOL}); "
        f"density {(s3 > 0.5).float().mean().item()}; launches depth 3 "
        f"{launches}; peak device GB (weights and song "
        f"{base_gb}): streamed depth 3 {gb3}, depth 1 {gb1}, 4 windows per "
        f"forward {gb4}, bucketed {gb_b}; audio-s/s: depth 3 "
        f"{SONG_SECONDS / sec3}, depth 1 {SONG_SECONDS / sec1}, 4 windows "
        f"{SONG_SECONDS / sec4}, bucketed {SONG_SECONDS / sec_b}")


def synth_song(rng, seconds: float):
    """(note rows (onset s, offset s, MIDI note, velocity), int16 audio):
    ~2 notes a second of three decaying harmonics, and a noise floor."""
    n = int(seconds * 16000)
    n_notes = int(seconds * 2)
    onsets = np.sort(rng.rand(n_notes) * (seconds - 1.5))
    rows = np.stack([onsets, onsets + 0.3 + rng.rand(n_notes) * 0.8,
                     rng.randint(40, 90, n_notes),
                     rng.randint(40, 120, n_notes)], axis=1)
    x = rng.randn(n) * 1e-3
    for onset, offset, note, vel in rows:
        i0, i1 = int(onset * 16000), int(offset * 16000)
        tt = np.arange(i1 - i0) / 16000
        f0 = 440.0 * 2 ** ((note - 69) / 12.0)
        env = np.exp(-tt * 3.0) * vel / 127.0
        x[i0:i1] += env * sum(a * np.sin(2 * np.pi * f0 * h * tt)
                              for h, a in ((1, 1.0), (2, 0.5), (3, 0.25)))
    return rows, (x / np.abs(x).max() * 0.7 * 32767).astype(np.int16)


def write_corpus(root: str, seed: int = 0) -> dict:
    """Synthetic MAPS and MAESTRO corpora under root, 16 kHz WAV: MAPS 4
    labeled songs in AkPnBcht (TSV), one each in ENSTDkAm and ENSTDkCl,
    `overlapping.pkl`; MAESTRO 8 unlabeled songs (MIDI, the metadata
    JSON). Returns the RECONVAT_*_ROOT variables that name them."""
    import pickle

    from scipy.io import wavfile

    from reconvat_tpu_torch.data.labels import save_tsv
    from reconvat_tpu_torch.data.midi_io import midi_to_hz, save_midi

    rng = np.random.RandomState(seed)
    maps, maestro = os.path.join(root, "MAPS"), os.path.join(root, "MAESTRO")
    for d in ("flac", "tsvs"):
        os.makedirs(os.path.join(maps, d))
    os.makedirs(os.path.join(maestro, "2004"))
    for group, count in (("AkPnBcht", 4), ("ENSTDkAm", 1), ("ENSTDkCl", 1)):
        for i in range(count):
            rows, audio = synth_song(rng, CORPUS_SECONDS)
            name = f"synth{i:02d}_{group}"
            wavfile.write(os.path.join(maps, "flac", name + ".wav"), 16000,
                          audio)
            save_tsv(os.path.join(maps, "tsvs", name + ".tsv"), rows)
    with open(os.path.join(maps, "overlapping.pkl"), "wb") as f:
        pickle.dump(["__none__"], f)
    meta = []
    for i in range(8):
        rows, audio = synth_song(rng, CORPUS_SECONDS)
        wav, midi = f"2004/m{i:02d}.wav", f"2004/m{i:02d}.midi"
        wavfile.write(os.path.join(maestro, wav), 16000, audio)
        save_midi(os.path.join(maestro, midi), midi_to_hz(rows[:, 2]),
                  rows[:, :2], rows[:, 3] / 127.0)
        meta.append({"split": "train", "audio_filename": wav,
                     "midi_filename": midi})
    with open(os.path.join(maestro, "maestro-v2.0.0.json"), "w") as f:
        json.dump(meta, f)
    return {"RECONVAT_MAPS_ROOT": maps, "RECONVAT_MAESTRO_ROOT": maestro}


def train_cli(overrides: dict, env: dict) -> dict:
    """One run of the training CLI through its `Experiment` with the
    phase's corpus and overrides, instrumented: each train step's kernel
    launches and each step interval of the loop's StepTimer, the
    host-blocking time of each `save_checkpoint`, the final evaluation's
    time. Every kernel count is set to 0 just before the run and read
    just after; the losses are checked finite (`RECONVAT_NAN_CHECKS`)."""
    from reconvat_tpu_torch import train_UNet_VAT as cli
    from reconvat_tpu_torch.train import driver, profiler

    counters = kernel_counters()
    rec = {"step_launches": {k: 0 for k in counters}, "steps": 0,
           "intervals": [], "ckpt_ms": [], "eval_ms": []}

    def counts():
        return {k: getattr(f, c) for k, (f, c) in counters.items()}

    def counted(make):
        def make_step(*args, **kw):
            step = make(*args, **kw)

            def run(*a):
                before = counts()
                out = step(*a)
                for k, n in counts().items():
                    rec["step_launches"][k] += n - before[k]
                rec["steps"] += 1
                return out
            return run
        return make_step

    class Timer(profiler.StepTimer):
        def tick(self):
            if self._last is not None:
                rec["intervals"].append(time.perf_counter() - self._last)
            super().tick()

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            rec[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    saved = {k: os.environ.get(k) for k in [*env, "RECONVAT_NAN_CHECKS"]}
    patched = {"make_train_step": counted(driver.make_train_step),
               "evaluate_wo_velocity": timed(driver.evaluate_wo_velocity,
                                             "eval_ms")}
    orig = {k: getattr(driver, k) for k in patched}
    orig_save, orig_timer = driver.ckpt.save_checkpoint, profiler.StepTimer
    os.environ.update(env, RECONVAT_NAN_CHECKS="1")
    for k, v in patched.items():
        setattr(driver, k, v)
    driver.ckpt.save_checkpoint = timed(orig_save, "ckpt_ms")
    profiler.StepTimer = Timer
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f, c in counters.values():
            setattr(f, c, 0)
        t0 = time.perf_counter()
        model, state, metrics = cli.ex.run(cli.train, overrides)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = counts()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for k, v in orig.items():
            setattr(driver, k, v)
        driver.ckpt.save_checkpoint = orig_save
        profiler.StepTimer = orig_timer
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rec.update(model=model, state=state, metrics=metrics,
               logdir=cli.ex.current_run.config["logdir"])
    return rec


def step_ms(rec, iteration: int = 10) -> list:
    """The loop's step intervals (ms) inside its epochs: the interval that
    spans an epoch's logging and checkpoint (every iteration-th tick) is
    left out."""
    return [dt * 1e3 for i, dt in enumerate(rec["intervals"], start=1)
            if i % iteration]


def bare_step_ms(trained) -> list:
    """ms/step of the CLI's train step without its loader: a copy of the
    CLI's model (bf16, reconstruction=False) and a fresh train state, one
    labeled and eight unlabeled clips already on the card, two rounds of
    10 steps after 2 warm-up; then a profile of 2 steps (device busy)."""
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    model = ReconVAT(seed=42, reconstruction=False,
                     compute_dtype="bfloat16")
    model.load_state_dict(trained.state_dict(), strict=True)
    state = create_train_state(model)
    step = make_train_step(model, 1.0, vat=True, use_unlabeled=True)
    batch_l, batch_ul = train_batches(5)
    batch_l = {k: v[:1] for k, v in batch_l.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        step(state, batch_l, batch_ul, gen)
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step(state, batch_l, batch_ul, gen)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / 10 * 1e3)
    log_profile("phase 11 bare CLI step profile (2 steps, B = 1 + 8, bf16, "
                "reconstruction=False)", "step", 2, profile_groups(
                    lambda: [step(state, batch_l, batch_ul, gen)
                             for _ in range(2)]))
    return out


def phase_train_cli(rows, tmp: str) -> dict:
    """Phase 11: `python -m reconvat_tpu_torch.train_UNet_VAT` at its
    defaults on the card (bf16, VAT, B = 1 labeled + 8 unlabeled x 640
    frames, 2 epochs of 10 steps), then a second run that resumes from
    the first's latest checkpoint."""
    from reconvat_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    env = write_corpus(os.path.join(tmp, "corpus"))
    corpus_s = time.perf_counter() - t0
    rec = train_cli(dict(TRAIN_CLI, root=os.path.join(tmp, "runs")), env)
    launches = rec["launches"]
    for name, n in launches.items():
        expected = name == "mel_power" or name.endswith("_bf16")
        if (n > 0) != expected:
            fail(f"the training CLI (bf16) launched {name} {n} times")
    for row in rows:
        row["launches_train_cli"] = launches[row["name"]]
    logdir, steps = rec["logdir"], rec["steps"]
    if steps != 20 or rec["state"].step != 20:
        fail(f"the CLI ran {steps} steps, state at {rec['state'].step}")
    path = ckpt.latest_checkpoint(logdir)
    if path is None or os.path.basename(path) != "model-2":
        fail(f"the CLI's latest checkpoint is {path}")
    import pickle

    with open(os.path.join(logdir, "result_dict"), "rb") as f:
        result = pickle.load(f)
    if sorted(result) != sorted(RESULT_KEYS):
        fail(f"result_dict keys {sorted(result)}")
    if not all(np.isfinite(v).all() for v in result.values()):
        fail("result_dict holds a non-finite value")
    artifacts = sorted(os.listdir(logdir)) + [
        f"MIDI_results/{n}" for n in sorted(os.listdir(
            os.path.join(logdir, "MIDI_results")))]

    resumed = train_cli(dict(TRAIN_CLI, root=os.path.join(tmp, "resumed"),
                             epoches=0, resume_iteration="latest",
                             trained_dir=logdir), env)
    saved = ckpt.load_state(path)
    if saved["step"] != 20 or resumed["state"].step != 20:
        fail(f"resumed at step {resumed['state'].step}, saved "
             f"{saved['step']}")
    n_tensors = 0
    for k, v in resumed["model"].state_dict().items():
        if not torch.equal(v.cpu(), saved["model"][k]):
            fail(f"resumed tensor {k} differs from the saved one")
        n_tensors += 1
    opt = resumed["state"].optimizer.state_dict()["state"]
    for i, slots in saved["optimizer"]["state"].items():
        for name, v in slots.items():
            if not torch.equal(opt[i][name].cpu(), v):
                fail(f"resumed optimizer state {i}.{name} differs")
            n_tensors += 1
    bare = bare_step_ms(rec["model"])
    ms = step_ms(rec)
    per_step = {k: n / steps for k, n in rec["step_launches"].items()}
    audio_s = 327680 / 16000                       # labeled audio per step
    n_songs = 2
    log(f"phase 11 training CLI (flagship, reconstruction=False, bf16, VAT, "
        f"batch_size 8 unlabeled + train_batch_size 1 labeled x 327680 "
        f"samples, {TRAIN_CLI}; corpus of 14 x {CORPUS_SECONDS} s written "
        f"in {corpus_s} s): {steps} steps; ms/step (loop StepTimer, within "
        f"epochs) median {np.median(ms)} mean {np.mean(ms)} min {min(ms)} "
        f"max {max(ms)}; audio-s/s trained (labeled) "
        f"{audio_s / (np.median(ms) / 1e3)}; kernel launches per train step "
        f"{per_step}; launches in the whole run {launches}; final "
        f"evaluation {rec['eval_ms'][0] / n_songs} ms/song ({n_songs} "
        f"songs of {CORPUS_SECONDS} s); save_checkpoint host-blocking ms "
        f"{rec['ckpt_ms']}; peak device GB {rec['peak_gb']}; run wall "
        f"{rec['wall_s']} s; the bare step (make_train_step on batches "
        f"already on the card, no loader), two rounds of 10: {bare} "
        f"ms/step; artifacts {artifacts}; resumed from "
        f"{os.path.basename(path)} at step {resumed['state'].step}, "
        f"{n_tensors} tensors bit-equal to the saved ones; note f1 "
        f"{np.mean(result['metric/note/f1'])}, frame f1 "
        f"{np.mean(result['metric/frame/f1'])}")
    return rec


def phase_train_cli_eval(rec) -> None:
    """Phase 11a: the CLI's final weights in an fp32 model; the bucketed
    full-song evaluation through the kernels against the plain versions
    (posteriograms within POST_ATOL, notes equal outside the pitches near
    0.5), and eval_batch_songs=2 against one song at a time."""
    from reconvat_tpu_torch import evaluate
    from reconvat_tpu_torch.data.datasets import MAPS
    from reconvat_tpu_torch.models.reconvat import ReconVAT

    songs = MAPS(os.path.join(os.path.dirname(os.path.dirname(
        rec["logdir"])), "corpus", "MAPS"), groups=["ENSTDkAm", "ENSTDkCl"],
        sequence_length=None, verbose=False)
    models = {}
    for route in ("kernels", "plain"):
        models[route] = ReconVAT(seed=0, reconstruction=False)
        models[route].load_state_dict(rec["model"].state_dict(), strict=True)
        models[route].use_kernels(route == "kernels")
        if route == "kernels":
            # after 20 steps every bin of these songs lies below 0.5, so
            # there is no note to compare: the output layer is scaled and
            # shifted as for the transcription CLI (phase 10)
            sharpen_output(models[route], [
                torch.from_numpy(s["audio"])[None].cuda() for s in songs])
            sharpened = models[route].state_dict()
        else:
            models[route].load_state_dict(sharpened, strict=True)
    runners = {k: evaluate.make_bucketed_runner(m) for k, m in models.items()}

    def rolls(outs):
        return [(p["frame"][0].float().cpu().numpy(),
                 {k: float(v) for k, v in losses.items()})
                for p, losses, _ in outs]

    per_song = {k: rolls([r(s) for s in songs]) for k, r in runners.items()}
    grouped = rolls(runners["kernels"].run_group(list(songs), 2))
    diffs, set_aside, notes = [], 0, 0
    for (a, la), (b, lb), (g, lg) in zip(per_song["kernels"],
                                         per_song["plain"], grouped):
        d, s, n = same_notes("phase 11a kernels vs plain", a, b)
        dg, _, _ = same_notes("phase 11a eval_batch_songs 2 vs 1", g, a)
        for k in lb:
            if not np.isclose(la[k], lb[k], rtol=1e-4, atol=1e-6) or \
                    not np.isclose(lg[k], la[k], rtol=1e-4, atol=1e-6):
                fail(f"phase 11a loss {k}: kernels {la[k]}, plain {lb[k]}, "
                     f"grouped {lg[k]}")
        diffs.append((d, dg))
        set_aside += s
        notes += n
    t0 = time.perf_counter()
    one = evaluate.evaluate_wo_velocity(songs, runners["kernels"],
                                        reconstruction=False)
    t1 = time.perf_counter()
    two = evaluate.evaluate_wo_velocity(songs, runners["kernels"],
                                        reconstruction=False, batch_songs=2)
    t2 = time.perf_counter()
    if list(one) != list(two):
        fail("eval_batch_songs=2 gives other keys")
    log(f"phase 11a the CLI's final weights in fp32, the output layer "
        f"sharpened as in phase 10, bucketed full-song "
        f"evaluation (2 songs of {CORPUS_SECONDS} s): posteriogram max abs "
        f"diff (kernels vs plain, batch_songs 2 vs 1) {diffs} (tol "
        f"{POST_ATOL}); {notes} notes, {set_aside} pitches set aside "
        f"(an element within {POST_ATOL} of 0.5); evaluate_wo_velocity "
        f"{(t1 - t0) * 1e3 / 2} ms/song one at a time, "
        f"{(t2 - t1) * 1e3 / 2} with batch_songs 2; frame f1 "
        f"{np.mean(one['metric/frame/f1'])} and "
        f"{np.mean(two['metric/frame/f1'])}")


def phase_train_cli_variants(rec, tmp: str) -> None:
    """Phase 11b: one epoch each with vat_chain='batched' and with
    RECONVAT_VAT_REMAT=1; ms/step and peak GB beside phase 11's (no
    gate on speed)."""
    env = {"RECONVAT_MAPS_ROOT": os.path.join(tmp, "corpus", "MAPS"),
           "RECONVAT_MAESTRO_ROOT": os.path.join(tmp, "corpus", "MAESTRO")}
    out = [f"phase 11 (separate chains): ms/step median "
           f"{np.median(step_ms(rec))}, peak GB {rec['peak_gb']}"]
    for name, over, extra in (("vat_chain=batched",
                               {"vat_chain": "batched"}, {}),
                              ("RECONVAT_VAT_REMAT=1", {},
                               {"RECONVAT_VAT_REMAT": "1"})):
        r = train_cli(dict(TRAIN_CLI, root=os.path.join(tmp, name),
                           epoches=1, saving_freq=100, **over),
                      {**env, **extra})
        ms = step_ms(r)
        per_step = {k: n / r["steps"] for k, n in r["step_launches"].items()
                    if n}
        out.append(f"{name}: ms/step median {np.median(ms)} mean "
                   f"{np.mean(ms)}, peak GB {r['peak_gb']}, launches per "
                   f"step {per_step}")
    log(f"phase 11b training CLI variants, one epoch each: {'; '.join(out)}")


def phase_bf16_kernels_at_train_cli_shapes() -> None:
    """Phase 11c: the bf16 attention kernels at the shapes the training
    CLI (bf16 by default) gives them beyond phases 3d-3f's B x 640: the
    labeled chain (train_batch_size 1 x 640 frames: forward, backward and
    its first pass), the batched VAT chain (1 + B rows), and the final
    evaluation's bucket (1 x the bucket of a CORPUS_SECONDS song, forward
    only), on inputs drawn as phase 3's. Each bf16 output is held against
    its bf16 plain version by `bf16_held`, the fp32 routes on the same
    inputs unrounded; the fp32 kernels, which set the rule's second term,
    are held against their plain versions by phases 3-3c's tolerances.
    Also read: the elements outside phases 3d-3f's per-element bound (one
    bf16 flip of a large dS term can cross it; PERF.md §6, PR 12)."""
    import torch.nn.functional as F

    from reconvat_tpu_torch.models.common import frames_in, next_bucket
    from reconvat_tpu_torch.ops import banded_attention_kernel as bak

    frames = frames_in(SAMPLES)
    bucket = next_bucket(frames_in(int(CORPUS_SECONDS * 16000)) + 2)
    shapes = [(1, frames, True), (1 + B, frames, True), (1, bucket, False)]
    rng = torch.Generator(device="cuda").manual_seed(7)
    D, hw = 229, (W - 1) // 2

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=rng, device="cuda") * scale

    def held(what, labels, k16, p16, k32, p32):
        """bf16_held of each output; (largest diff over its limit, the
        elements outside phases 3d-3f's bound)."""
        share, outside = 0.0, 0
        for label, a, b, c, d in zip(labels, k16, p16, k32, p32):
            diff, tol = bf16_held(f"{what} {label}", a, b, c, d)
            share = max(share, diff / tol if tol else 0.0)
            if a.dtype == torch.bfloat16:
                a, b = a.float(), b.float()
                outside += int(((a - b).abs() > ATTN_BF16_OUT_RTOL * b.abs()
                                + ATTN_BF16_OUT_FLOOR * b.abs().max()).sum())
        return share, outside

    read = []
    for b, t, backward in shapes:
        x32 = (randn(b, t, H, D, scale=D ** -0.25),
               F.pad(randn(b, t, H, D, scale=D ** -0.25),
                     (0, 0, 0, 0, hw, hw)),
               F.pad(randn(b, t, H, D), (0, 0, 0, 0, hw, hw)),
               randn(b, t, H, D))
        x16 = tuple(x.to(torch.bfloat16) for x in x32)
        rel = randn(H, D, W, scale=0.1 * D ** -0.25)
        what = f"attention at {b} x {t}"
        routes = {}
        for name, x in (("16", x16), ("32", x32)):
            routes[name] = (bak.banded_attention_fwd(*x[:3], rel, W),
                            bak.banded_attention(*x[:3], rel, W))
        torch.cuda.synchronize()
        (k16, p16), (k32, p32) = routes["16"], routes["32"]
        if k16[0].dtype != torch.bfloat16:
            fail(f"bf16 {what} returned {k16[0].dtype} out")
        for label, a, r in zip(("out", "probs"), k32, p32):
            check_close(f"fp32 {what} {label}", a, r, ATTN_TOL)
        line = (f"{b} x {t}: forward "
                f"{held(what, ('out', 'probs'), k16, p16, k32, p32)}")
        if backward:
            for fn, plain, labels, part in (
                    (bak.banded_attention_bwd, bak.banded_attention_bwd_plain,
                     ("dq", "dk", "dv", "drel"), "backward"),
                    (bak.banded_attention_bwd_partials,
                     bak.banded_attention_bwd_partials_plain,
                     ("dq", "dk_part", "dv_part", "drel_part"),
                     "first pass")):
                grads = {name: (fn(*x[:3], rel, x[3], W),
                                plain(*x[:3], rel, x[3], W))
                         for name, x in (("16", x16), ("32", x32))}
                torch.cuda.synchronize()
                check_grads(f"fp32 {what} {part}", *grads["32"], labels)
                reading = held(f"{what} {part}", labels, *grads["16"],
                               *grads["32"])
                line += f"; {part} {reading}"
        read.append(line)
    log(f"phase 11c bf16 attention kernels at the training CLI's shapes "
        f"(B x T frames: the labeled chain, the batched VAT chain, the "
        f"evaluation bucket) against their bf16 plain versions by "
        f"bf16_held (limit {BF16_FACTOR} x the plain versions' "
        f"bf16-vs-fp32 gap + the fp32 kernel's gap; fp32 kernels within "
        f"{ATTN_TOL} and {GRAD_TOL} over max|ref| of their plain "
        f"versions); by part (largest diff over its limit, elements "
        f"outside phases 3d-3f's per-element bound): {'; '.join(read)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "reconvat_tpu_torch")):
        print("chip_smoke: reconvat_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from reconvat_tpu_torch.kernels import _build
    from reconvat_tpu_torch.ops.spectrogram import make_frontend

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    card = nvidia_smi()
    t0 = t_start = time.perf_counter()
    _build.build_all(verbose=True)
    log(f"phase 1 {card}; kernels built in {time.perf_counter() - t0} s")

    fe = make_frontend("Mel")[0].cuda()
    attn = attention_inputs()
    rows = [phase_mel(fe), phase_attention(*attn[:4]),
            *phase_attention_bwd(*attn), phase_attention_bf16(*attn[:4]),
            *phase_attention_bwd_bf16(*attn)]
    del attn
    served = phase_serve(rows[:2])
    phase_serve_bf16(rows[4], *served)
    phase_kernels_at_cli_shapes(fe)
    phase_cli(served[1])
    phase_streaming(served[1])
    del served
    phase_train_bf16(rows, *phase_train(rows))
    import shutil
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    try:
        rec = phase_train_cli(rows, tmp)
        phase_train_cli_eval(rec)
        phase_train_cli_variants(rec, tmp)
        phase_bf16_kernels_at_train_cli_shapes()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        row["max_err"] = row["max_abs_err"]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(f"chip_smoke: {time.perf_counter() - t_start} s in all")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
