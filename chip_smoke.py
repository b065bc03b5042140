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
shapes that run gives them (phase 11c). Then UNetOnset: the six attention
rows at its Stack's shapes (6 heads of 128; B x 640 and the evaluation
bucket), held and timed (phase 12); one fp32 train step with
reconstruction and VAT through the kernels against the plain versions
(phase 12a); its training CLI (`reconvat_tpu_torch.train_UNet_Onset_VAT`)
at its defaults (bf16, 8 labeled + 8 unlabeled clips; phase 12b); and the
evaluation CLI (`reconvat_tpu_torch.evaluate_cli`) on that run's and phase
11's checkpoints, kernels against plain versions, with UNetOnset streaming
one song (phase 12c). Then the Onsets-and-Frames family, Thickstun and
Prestack, whose only kernel is the mel kernel: the fp32 train steps of
`OnsetsAndFrames` (no VAT; profiled) and `FrameStackVAT` (VAT) at 8 x 640
frames, held through the kernel against the plain mel route (phase 13); the O&F training CLI at its defaults and with `model_name=frame
VAT=True` (13a); the Thickstun and Prestack training CLIs for one epoch and
the evaluation CLI on their checkpoints, kernel against plain (13b); and a
bf16 eval forward of each of the five models, kernel against plain (13c).
Then Segmentation ("baseline_Multi_Inst"): an fp32 VAT train step at 8 + 8
x 640 frames, profiled, the mel kernel against the plain route (phase 14);
its training CLI for one epoch, the transcription CLI with
`model_type=baseline_Multi_Inst` and the evaluation CLI with
`model_type=Segmentation` on its weights, and a 60-s song streamed against
its bucketed transcription (14a-14b); a bf16 forward (14c). Last, the
attention models: the fp32 attention kernels at their heads (8 of Dh = 6
and 8 of Dh = 96, with drawn and zero `rel`) against their plain versions
and float64, timed (phase 15), and a train step of each of the nine
models through the kernels against the plain versions (15a). Last, the
CQT and CFP frontends (phase 16): both at 8 x 20.48 s against float64 on
the CPU and a second PyTorch route, timed (16a); the attention rows at
their heads, Dh 176 (all six) and 386 (the forward's two), against their
plain versions and float64, timed (16b); a CQT VAT train step of the
flagship, kernels against plain versions (16c); the flagship serving on
CFP in fp32 and bf16 through `serve.submit`, kernels against plain
versions, notes equal away from 0.5 (16d); and the transcription CLI with
each frontend (16e). Last, phase 17: the flagship on CQT and on CFP
streams a 60-s song against its bucketed transcription, kernels against
plain versions (17a); the flagship's and Segmentation's fp32 VAT steps on
two ranks (`--dp-rank` processes of this script sharing the card over
gloo, and over NCCL a card each where the machine has two) against one
process (17b); and the training CLI at `mesh_dp=2` with a resume (17c).
Last, phase 18, sequence parallelism (`mesh_sp=2`: each rank holds 320 of
a crop's 640 frames, the U-Net's convolutions and the attention take
their halos from the other rank): the flagship's eval-mode forward and
fp32 VAT step (18a) and UNetOnset's VAT step (18b) on two ranks against
one process, and a 60-s song
streamed over the two ranks against one device's stream (18c), the ranks
sharing the card over gloo (over NCCL a card each where the machine has
two; on four cards 18a also at mesh_dp=2 x mesh_sp=2); and the training
CLI at `mesh_sp=2` with a resume (18d). Last, phase 19, sequence
parallelism in Segmentation and Thickstun (their TF-SAME pads, transposed
convolutions, 17 x 17 windows and 25-frame kernel take the other rank's
frames): Segmentation's fp32 VAT step (19a) and Thickstun's step (19b) on
two ranks against one process, Segmentation streaming a 60-s song over
the ranks (19c), and the Multi_Inst and Thickstun training CLIs at
`mesh_sp=2` with a resume (19d). Last, phase 20: the library frontends
(`ops/extra_frontends.py`: MFCC, Gammatonegram, DFT, ISTFT, GriffinLim,
CQT1992, CQT2010, CQT2010v2) at their defaults on 4 clips of 3 s against
float64 on the CPU, with MFCC's launch of the mel kernel counted and held
against its plain route.

Prints one line per phase, then a `{"kernels": [...]}` JSON line, the
card's name and power limit, and as its last line
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
there is no CUDA device, when the port's package is not beside this file,
or when any check fails. Imports nothing of JAX or of `reconvat_tpu`.

`python3 chip_smoke.py --bf16-step-rule [n_states]` runs no phase: it reads
phase 8b's gradient rule over n_states weight states (8 by default) beside
the plain bf16 route's own spread (`bf16_step_rule`);
`python3 chip_smoke.py --NAME-step-rule [n_states]` reads the same way the
rule of the phases that hold an fp32 train step through the kernels
against the plain versions (10 states by default, `step_rule`): NAME
`flagship` (phase 8), `onset` (12a), `onsets-frames` (13),
`segmentation` (14), `attention` (15a) or `cqt` (16c).
`python3 chip_smoke.py --dp-rank rank world port out [sp [what]]` is one
rank of phase 17b, 18 or 19, started by that phase; `--data-parallel
[17] [18] [19]` runs phases 17b-19d alone, or the groups named.
"""
from __future__ import annotations

import contextlib
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
# the Reconstructor's loss, the BCE of its clamped reconstruction, weighs
# each element by 1 / (p (1 - p)): at random init its gradient is set by
# the few elements next to the clamp, which a change at the size of the
# routes' rounding moves by as much as the gradient itself, so its
# gradients are held on the elements CLAMP_MARGIN or more inside [0, 1]
CLAMP_MARGIN = 1e-2
# Segmentation's VAT `r_norm` entries (the mean |normalized direction|)
# move by up to 0.4 % between the routes; they are held within
# STEP_LOSS_RTOL + PROBE_FACTOR x the plain route's own spread under
# R_NORM_PROBES audio probes and its mel computed in float64
R_NORM_PROBES = 2
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


# UNetOnset (phases 12-12c): its Stack attention's heads and width (6 x
# 128 over the 176 onset and feature columns, `models/unet_onset.py`); the
# keys of the JAX package's result_dict of UNet_Onset (reconstruction=False);
# the length of the song it streams
UO_H, UO_D = 6, 128
ONSET_RESULT_KEYS = [
    "loss/test_frame", "loss/test_onset", "loss/test_LDS_l_frame",
    "loss/test_LDS_l_onset", "loss/test_r_norm_l",
    *(k for k in RESULT_KEYS if k.startswith("metric/"))]
ONSET_SONG_SECONDS = 60.0

# The Onsets-and-Frames family, Thickstun and Prestack (phases 13-13c): the
# keys of the JAX package's result_dict of each (eval-mode `run_on_batch`
# losses, then the metrics); Prestack's crop in phase 13b: at the CLI's
# 640 frames its bare fp32 step peaks near the card's 80 GB (phase 13b
# prints the peak; cuDNN's FFT convolutions take large workspaces), at
# 320 frames near 47 GB (PERF.md §4), so the phase trains on 320-frame
# crops
METRIC_KEYS = [k for k in RESULT_KEYS if k.startswith("metric/")]
OF_RESULT_KEYS = {
    "onset_frame": ["loss/test_frame", "loss/test_onset", "loss/test_LDS_l",
                    "loss/test_r_norm_l", *METRIC_KEYS],
    "frame": ["loss/test_frame", "loss/test_LDS", *METRIC_KEYS]}
BASELINE_RESULT_KEYS = ["loss/train_frame", *METRIC_KEYS]
PRESTACK_FRAMES = 320


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
    b, L, h = q.shape[:3]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kpad, vpad))
    qrel = torch.einsum("blhd,hdw->bhlw", q, rel)
    mask = torch.full((b, h, L, L + W - 1), float("-inf"), device="cuda")
    cols = torch.arange(L, device="cuda")[:, None] + torch.arange(
        W, device="cuda")
    mask.scatter_(3, cols.expand(b, h, L, W), qrel)
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
                 ("cudnn_rnn", ("rnn", "lstm")),    # the recurrences
                 ("banded_attention_bwd", ("bwd_partials_tf32x3_kernel",
                                           "bwd_partials_mma_kernel",
                                           "bwd_overlap_add_kernel",
                                           "bwd_drel_sum_kernel")),
                 ("banded_attention_fwd", ("banded_attention",)),
                 ("convolutions_bn", ("conv", "cudnn", "implicit", "dgrad",
                                      "wgrad", "fprop", "fft", "gemm_cf32",
                                      "pointwise_mult_and_sum_complex",
                                      "bn_fw", "bn_bw", "batch_norm")),
                 ("matmuls", ("gemm", "gemv")),
                 ("copy_kernels", ("copy_kernel",)),   # dtype casts among them
                 ("copies", ("memcpy", "memset")))


# operators whose device time (every kernel they launch) the profiles
# report beside the kernel groups: cuDNN's RNN runs its recurrent GEMMs
# and cell kernels under `_cudnn_rnn`, named as no group above names them
PROFILE_OPS = ("aten::_cudnn_rnn", "aten::_cudnn_rnn_backward",
               "aten::cudnn_convolution", "aten::convolution_backward",
               "aten::mm", "aten::addmm")


def profile_groups(fn):
    """Run fn() under torch.profiler. Returns (wall s, device busy ms,
    device ms by kernel group, top kernels, device operations run: kernels,
    copies and sets, device ms of each of PROFILE_OPS), or None when the
    profiler recorded no device kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    kernels, n_ops, ops = {}, 0, {}
    for e in prof.key_averages():
        if e.key in PROFILE_OPS:
            ops[e.key] = getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0)) / 1e3
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
    return sec, busy_ms, groups, top, n_ops, ops


def log_profile(label: str, unit: str, n: int, prof) -> None:
    if prof is None:
        log(f"{label}: the profiler recorded no device kernels; device "
            f"time not measured")
        return
    sec, busy_ms, groups, top, n_ops, ops = prof
    log(f"{label}: wall {sec * 1e3 / n} ms/{unit}, device busy "
        f"{busy_ms / n} ms/{unit}, busy share {busy_ms / (sec * 1e3)}, "
        f"device operations {n_ops / n} /{unit}; "
        f"device ms/{unit} by group "
        f"{ {g: v / n for g, v in groups.items()} }; by operator "
        f"{ {k: v / n for k, v in ops.items()} }; top kernels "
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


def step_grads(model, batch_l, batch_ul, seed: int, vat: bool,
               objective=None):
    """Losses and per-parameter gradients of one training forward and
    backward (no update), VAT directions from `seed`; with `objective`
    (predictions, losses, spec) -> scalar, the gradients of that scalar in
    place of the total loss's."""
    from reconvat_tpu_torch.models.reconvat import fp32_math
    from reconvat_tpu_torch.train.state import total_loss_from_dict

    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with fp32_math():
        preds, losses, spec = model.run_on_batch(batch_l, batch_ul, gen,
                                                 vat=vat, train=True)
        (total_loss_from_dict(losses, 1.0) if objective is None else
         objective(preds, losses, spec)).backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def probed(batch, seed: int, keys=("audio",)):
    """`batch` with each of `keys` moved by PROBE: the audio relatively,
    the 0/1 frame roll absolutely, by seeded normal noise."""
    out = dict(batch)
    for i, key in enumerate(keys):
        x = batch[key]
        noise = PROBE * torch.randn(x.shape, device=x.device, generator=(
            torch.Generator(device=x.device).manual_seed(seed + i)))
        out[key] = x * (1 + noise) if key == "audio" else x + noise
    return out


@contextlib.contextmanager
def float64_mel(model):
    """Inside, `model`'s mel frontend computes in float64 (the plain
    version on float64 copies of its bases), its output cast to fp32."""
    from reconvat_tpu_torch.ops.mel_kernel import mel_power_plain

    fe = model.frontend

    def hook(_, inputs, out):
        return mel_power_plain(
            inputs[0].double(), fe.stft.wcos.double(), fe.stft.wsin.double(),
            fe.mel_basis.double(), fe.stft.hop_length).to(out.dtype)

    handle = fe.register_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def grad_rule(gk: dict, gp: dict, moved: dict, spread: dict):
    """`compare_routes`'s gradient rule, leaf by leaf: the kernel route's
    gradient `gk` against the plain route's `gp` within the first limit,
    PROBE_FACTOR x the plain route's move under one PROBE (`moved`: its
    gradients on the probed batch) + GRAD_FLOOR x the largest gradient
    magnitude; a leaf above the first limit is held by the second reading,
    the first limit + PROBE_FACTOR x its `spread` ({leaf: the plain
    route's largest move under R_NORM_PROBES further probes}). Returns
    (the largest magnitude, {leaf: (gap, first limit, second limit, the
    limit that holds it)})."""
    top = max(g.abs().max().item() for g in gp.values())
    out = {}
    for name, g in gp.items():
        diff = (gk[name] - g).abs().max().item()
        first = (PROBE_FACTOR * (moved[name] - g).abs().max().item()
                 + GRAD_FLOOR * top)
        second = first + PROBE_FACTOR * spread[name]
        limit = first if diff <= first else second
        if not torch.isfinite(gk[name]).all():
            diff = float("inf")
        out[name] = (diff, first, second, limit)
    return top, out


def plain_spread(run, plain, batch_l, gp: dict, keys=("audio",)) -> dict:
    """{leaf: the plain route's largest gradient move without VAT under
    R_NORM_PROBES probes of PROBE on `keys`}, `run(model, batch_l,
    batch_ul, vat)` giving (losses, gradients)."""
    readings = [run(plain, probed(batch_l, 20 + 2 * j, keys), None,
                    False)[1] for j in range(R_NORM_PROBES)]
    return {k: max((r[k] - g).abs().max().item() for r in readings)
            for k, g in gp.items()}


def route_objective(model, plain, start: dict, batch_l):
    """(objective, keep share, probed keys) of `compare_routes`'s step
    without VAT: for the Reconstructor its BCE on the elements that the
    plain route (`plain` at `start`) puts CLAMP_MARGIN or more inside
    [0, 1], probed on audio and frame roll; for every other model the
    total loss (None, None), probed on the audio."""
    from reconvat_tpu_torch.models.reconvat import fp32_math

    if type(model).__name__ != "Reconstructor":
        return None, None, ("audio",)
    plain.load_state_dict(start)
    gen = torch.Generator(device=plain.device).manual_seed(5)
    with torch.no_grad(), fp32_math():
        preds, _, _ = plain.run_on_batch(batch_l, None, gen, train=True)
    rec = preds["reconstruction"][..., 0]
    keep = ((rec >= CLAMP_MARGIN) & (rec <= 1 - CLAMP_MARGIN)).float()

    def objective(preds, _, spec):
        bce = torch.nn.functional.binary_cross_entropy(
            preds["reconstruction"][..., 0].clamp(0.0, 1.0),
            spec.detach(), reduction="none")
        return (bce * keep).sum() / keep.sum()

    return objective, keep.mean().item(), ("audio", "frame")


def compare_routes(model, batch_l, batch_ul, r_norm_spread=False) -> str:
    """One step's losses and gradients through the kernels against the
    same step through the plain versions, from the same state (and the
    same dropout masks, drawn from the same seed): without VAT (losses and
    every gradient), and with VAT at xi = 1e-2 from the same directions
    (losses, at STEP_LOSS_RTOL).

    The Reconstructor's gradients are those of its BCE on the elements
    the plain route puts CLAMP_MARGIN or more inside [0, 1], and its probe
    moves both inputs (audio and frame roll). With `r_norm_spread` the VAT
    step's `r_norm` entries are held within STEP_LOSS_RTOL + PROBE_FACTOR x
    the plain route's own spread (R_NORM_PROBES audio probes of both
    batches, and its mel in float64). A gradient leaf above its first
    limit is held by the second reading of `grad_rule`, the plain route's
    own spread under R_NORM_PROBES further probes: the train-mode step at
    random init is ill-conditioned (max-pools and ReLUs switch a
    gradient's route on a rounding), and one probe's move can be smaller
    than the mel kernel's rounding; `python3 chip_smoke.py
    --NAME-step-rule` reads the rule over weight states for each phase
    that calls this (`rule_models`; PERF.md §6)."""
    import copy
    import dataclasses

    from reconvat_tpu_torch.nn.layers import new_dropout_masks

    new_dropout_masks(model, None)    # each run draws its own from `seed`
    plain = copy.deepcopy(model)
    plain.use_kernels(False)
    for m in plain.modules():
        if isinstance(m, torch.nn.LSTM):
            m.flatten_parameters()        # the copy holds its weights apart
    start = {k: v.clone() for k, v in model.state_dict().items()}
    objective, keep_share, keys = route_objective(model, plain, start,
                                                  batch_l)

    def run(m, bl, bul, vat):
        m.load_state_dict(start)
        return step_grads(m, bl, bul, seed=5, vat=vat, objective=objective)

    lk, gk = run(model, batch_l, None, False)
    lp, gp = run(plain, batch_l, None, False)
    _, gq = run(plain, probed(batch_l, 9, keys), None, False)
    for k in lp:
        if not np.isclose(lk[k], lp[k], rtol=STEP_LOSS_RTOL, atol=1e-6):
            fail(f"train step without VAT: {k} {lk[k]} (kernels) vs "
                 f"{lp[k]} (plain)")
    top, read = grad_rule(gk, gp, gq, plain_spread(run, plain, batch_l, gp,
                                                   keys))
    worst, second = 0.0, []
    for name, (diff, first, limit2, limit) in read.items():
        if not diff <= limit:
            fail(f"train step without VAT: gradient of {name} differs by "
                 f"{diff} (first limit {first}, second {limit2})")
        if limit != first:
            second.append((name, diff, first, limit2))
        if gp[name].abs().max().item() > GRAD_FLOOR * top and \
                gk[name].abs().max().item() == 0:
            fail(f"kernel route lost the gradient of {name}")
        worst = max(worst, diff / top)
    cfg = model.vat_cfg
    lvk = lvp = None
    r_spread = {}
    if cfg is not None:             # the supervised models have no VAT
        model.vat_cfg = plain.vat_cfg = dataclasses.replace(cfg, xi=1e-2)
        lvk, _ = run(model, batch_l, batch_ul, True)
        lvp, _ = run(plain, batch_l, batch_ul, True)
        if r_norm_spread:
            readings = [run(plain, probed(batch_l, 20 + 2 * j),
                            probed(batch_ul, 40 + 2 * j), True)[0]
                        for j in range(R_NORM_PROBES)]
            with float64_mel(plain):
                readings.append(run(plain, batch_l, batch_ul, True)[0])
            r_spread = {k: max(abs(r[k] - lvp[k]) for r in readings)
                        for k in lvp if "_r_norm_" in k}
        model.vat_cfg = cfg
        for k in lvp:
            tol = (1e-6 + STEP_LOSS_RTOL * abs(lvp[k])
                   + PROBE_FACTOR * r_spread.get(k, 0.0))
            if not abs(lvk[k] - lvp[k]) <= tol:
                fail(f"train step with VAT (xi 1e-2): {k} {lvk[k]} "
                     f"(kernels) vs {lvp[k]} (plain; tolerance {tol}, the "
                     f"plain route's r_norm spread {r_spread})")
    model.load_state_dict(start)
    first, grad = next(iter(gk.items()))            # the input layer's
    return (f"without VAT: losses agree (rtol {STEP_LOSS_RTOL}), every "
            f"gradient within {PROBE_FACTOR}x the plain route's movement "
            f"under a {PROBE} input probe + {GRAD_FLOOR} of the largest "
            f"({top}; largest gap {worst} of it), {first} gradient max "
            f"{grad.abs().max().item()}"
            + f"; held by the second reading (leaf, gap, first limit, "
              f"second limit): {second}"
            + ("" if keep_share is None else
               f" (the BCE on the {keep_share} share of elements at least "
               f"{CLAMP_MARGIN} inside [0, 1]; probe on audio and frame)")
            + f"; with VAT at xi 1e-2: losses kernels {lvk} plain {lvp}"
            + (f" (r_norm within rtol + {PROBE_FACTOR} x the plain route's "
               f"spread {r_spread})" if r_spread else ""))


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


def counted_steps(step, state, batches, gen, n_steps: int, dtype: str,
                  path_kernels=None):
    """Run n_steps train steps with every launch count set to 0 just
    before and read just after, and peak memory reset before. Fails
    unless the step launched `mel_power` and each attention kernel of its
    dtype, and no attention kernel of the other dtype; or, where
    `path_kernels` names the kernels of the path, unless it launched each
    of them and no other. Returns (ms/step, peak GB, launches, losses of
    the steps)."""
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
        expected = (name in path_kernels if path_kernels is not None
                    else name == "mel_power" or name.endswith("_bf16") == (
                        dtype == "bf16"))
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
               floor: float = 0.0, gate: bool = True, spread=None):
    """bf16_held for each key of the dicts (losses, or gradients by
    leaf), with the reference route's bf16-vs-fp32 gap the largest over
    (ref16, ref32) and the (bf16, fp32) pairs of `draws` (BF16_DRAWS),
    and `floor` added to each limit; returns the largest share of its
    limit that a key used, and the key. With `spread` (by key) a key
    above that limit is held by a second reading, the limit + PROBE_FACTOR
    x the reference route's own spread; the return then also names the
    keys the second reading held. With gate False it only reads."""
    def gap(a, b):
        if isinstance(a, torch.Tensor):
            return (a.float() - b.float()).abs().max().item()
        return abs(a - b)

    worst, second = (0.0, ""), []
    for k in ref16:
        diff = gap(test16[k], ref16[k])
        ref_gap = max(gap(a[k], b[k]) for a, b in [(ref16, ref32), *draws])
        tol = BF16_FACTOR * ref_gap + gap(test32[k], ref32[k]) + floor
        if spread is not None and diff > tol:
            second.append((k, diff, tol, spread[k]))
            tol += PROBE_FACTOR * spread[k]
        if gate and not diff <= tol:
            fail(f"bf16 {what}, {k}: differ by {diff} (tol {tol}: "
                 f"{BF16_FACTOR} x the reference's bf16-vs-fp32 gap "
                 f"{ref_gap}, largest of {len(draws) + 1} draws, + the fp32 "
                 f"routes' gap + {floor}"
                 + ("" if spread is None else
                    f" + {PROBE_FACTOR} x the reference's spread "
                    f"{spread[k]}") + ")")
        worst = max(worst, (diff / tol if tol > 0 else 0.0, k))
    return worst if spread is None else (worst, second)


def rms_gap(x, y) -> float:
    """The rms gap of two tensors, or the gap of two floats."""
    if isinstance(x, torch.Tensor):
        return (x.double() - y.double()).pow(2).mean().sqrt().item()
    return abs(x - y)


def median_rule(card16, cpu16, card32, cpu32, spread=None):
    """Phase 9b's rule (BF16_MOVE_FLOOR) over lists of dicts, one dict per
    input, the same inputs on all four routes, each value a tensor (its
    rms gap is read) or a float. Returns (misses, by key the upper bound's
    share of its limit and the ratio of the card's median move to the
    CPU's): misses names each key that breaks either bound. With `spread`
    (by key, `bf16_spread`) a key above the upper limit is held by a
    second reading, the limit + PROBE_FACTOR x the CPU bf16 route's own
    spread; each key's reading then also gives its share of that."""
    def med(a, b, k):
        return float(np.median([rms_gap(x[k], y[k]) for x, y in zip(a, b)]))

    misses, read = [], {}
    for k in cpu16[0]:
        ref_gap = med(cpu16, cpu32, k)
        fp32 = max(rms_gap(x[k], y[k]) for x, y in zip(card32, cpu32))
        diff, move = med(card16, cpu16, k), med(card16, card32, k)
        tol = BF16_FACTOR * ref_gap + fp32
        read[k] = (diff / tol if tol > 0 else 0.0,
                   move / ref_gap if ref_gap > 0 else 1.0)
        if spread is not None:
            tol += PROBE_FACTOR * spread[k]
            read[k] += (diff / tol if tol > 0 else 0.0,)
        if not (diff <= tol and move >= ref_gap / BF16_MOVE_FLOOR):
            misses.append(k)
    return misses, read


def bf16_spread(cpu16, states, batch) -> dict:
    """Phase 9b's second reading's spread, by prediction: for each weight
    state of `states` the largest rms move of the CPU bf16 route's
    predictions (`short_step`) under R_NORM_PROBES audio probes of PROBE
    (`probed`), which flip bf16 roundings as another summation order
    does; the median over the states. Leaves `cpu16` at the first
    state."""
    moves = []
    for weights in states:
        cpu16.load_state_dict(weights)
        base = short_step(cpu16, batch)[0]
        probes = [short_step(cpu16, probed(batch, 20 + 2 * j))[0]
                  for j in range(R_NORM_PROBES)]
        moves.append({k: max(rms_gap(p[k], v) for p in probes)
                      for k, v in base.items()})
    cpu16.load_state_dict(states[0])
    return {k: float(np.median([m[k] for m in moves])) for k in moves[0]}


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
    (xi BF16_VAT_XI) losses. A gradient leaf above its limit is held by
    the second reading, its limit + PROBE_FACTOR x the plain bf16 route's
    own spread under R_NORM_PROBES audio probes of PROBE: in 12 weight
    states each of two readings by `python3 chip_smoke.py --bf16-step-rule
    12` one leaf went to 1.22 of the first limit, and none past 0.71 of
    the second (PERF.md §6)."""
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
        probes = [run("plain16", probed(batch_l, 20 + 2 * j), None, False)[1]
                  for j in range(R_NORM_PROBES)]
        spread = {k: max((p[k] - g).abs().max().item() for p in probes)
                  for k, g in gp16.items()}
        worst_g, second = held_draws(
            "gradients, kernels vs plain", g16, gp16, g32, gp32,
            [(a[1], b[1]) for a, b in drawn], floor=GRAD_FLOOR * top,
            spread=spread)
        notes.append(f"every gradient leaf held (floor {GRAD_FLOOR} x "
                     f"{top}), largest share of a limit {worst_g}; held by "
                     f"the second reading (leaf, gap, first limit, the "
                     f"plain route's spread): {second}")
    model.load_state_dict(start)
    model16.load_state_dict(start)
    return "; ".join(notes)


def bf16_step_rule(n_states: int) -> None:
    """Phase 8b's gradient rule over several weight states, beside the
    plain bf16 route's own spread. Trains the fp32 ReconVAT at phase 6's
    shape (`train_batches`, VAT) for 4 steps at a time. After each 4 it
    takes phase 8b's bf16 step without VAT from the fp32 state, through
    the kernels and through the plain versions, and reads for every
    gradient leaf: the gap between the two routes; phase 8b's first limit
    (`held_draws`: BF16_FACTOR x the plain route's bf16-vs-fp32 gap, the
    largest over the batch and BF16_DRAWS audio copies, + the fp32 routes'
    gap + GRAD_FLOOR of the largest gradient); and the plain bf16 route's
    own spread, its largest move under R_NORM_PROBES audio probes of PROBE
    (`probed`), which flip bf16 roundings as another summation order
    does. Prints, per state, the largest share of the first limit, each
    leaf above it with its gap and spread, and the largest share of the
    first limit + PROBE_FACTOR x spread (the second reading)."""
    from reconvat_tpu_torch.kernels import _build
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    _build.build_all()
    model = ReconVAT(seed=0)
    state = create_train_state(model)
    step = make_train_step(model, alpha=1.0, vat=True, use_unlabeled=True)
    batches = [train_batches(seed) for seed in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch_l = batches[0][0]
    routes = {"kernels16": ReconVAT(seed=0, compute_dtype="bfloat16"),
              "plain16": ReconVAT(seed=0, compute_dtype="bfloat16"),
              "kernels32": ReconVAT(seed=0), "plain32": ReconVAT(seed=0)}
    for name, m in routes.items():
        m.use_kernels(name.startswith("kernels"))
    draws = probe_batches(batch_l, None, BF16_DRAWS, seed=13)
    probes = [probed(batch_l, 20 + 2 * j) for j in range(R_NORM_PROBES)]
    log(nvidia_smi())

    def gap(a, b):
        return (a.float() - b.float()).abs().max().item()

    for k in range(n_states):
        for i in range(4):
            step(state, *batches[i % 2], gen)
        start = {n: v.clone() for n, v in model.state_dict().items()}

        def grads(name, batch):
            m = routes[name]
            m.load_state_dict(start)
            return step_grads(m, batch, None, seed=5, vat=False)[1]

        g = {name: grads(name, batch_l) for name in routes}
        drawn = [(grads("plain16", d), grads("plain32", d)) for d, _ in draws]
        moved = [grads("plain16", p) for p in probes]
        top = max(v.abs().max().item() for v in g["plain16"].values())
        worst, worst2, above = (0.0, ""), (0.0, ""), []
        for leaf, ref in g["plain16"].items():
            diff = gap(g["kernels16"][leaf], ref)
            ref_gap = max(gap(a[leaf], b[leaf]) for a, b in
                          [(g["plain16"], g["plain32"]), *drawn])
            tol = (BF16_FACTOR * ref_gap
                   + gap(g["kernels32"][leaf], g["plain32"][leaf])
                   + GRAD_FLOOR * top)
            spread = max(gap(p[leaf], ref) for p in moved)
            worst = max(worst, (diff / tol, leaf))
            worst2 = max(worst2, (diff / (tol + PROBE_FACTOR * spread),
                                  leaf))
            if diff > tol:
                above.append((leaf, diff, tol, spread))
        log(f"after {4 * (k + 1)} steps: largest share of the limit "
            f"{worst}; with {PROBE_FACTOR} x the plain bf16 route's spread "
            f"added {worst2}; leaves above the limit (gap, limit, spread) "
            f"{above}")


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
    states = weight_draws(start, BF16_9B_DRAWS, seed=19)
    for weights in states:
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
    second = ""
    if misses:
        spread = bf16_spread(cpu16, states, short_l)
        misses, read = median_rule(preds[0], preds[2], preds[1], preds[3],
                                   spread)
        second = (f"; a prediction above the first limit, read again with "
                  f"{PROBE_FACTOR} x the CPU bf16 route's spread {spread} "
                  f"added (the third number)")
    log(f"phase 9b: predictions by the median rule (median over weight "
        f"draws of the rms |card bf16 - CPU bf16| as a share of "
        f"{BF16_FACTOR} x the CPU's median bf16-vs-fp32 gap + the largest "
        f"fp32 gap; the card's median bf16-vs-fp32 gap over the CPU's, at "
        f"least 1/{BF16_MOVE_FLOOR}) {read}; not held: the losses by the "
        f"same rule {loss_read}, and by the old rule (the batch alone "
        f"against {BF16_FACTOR} x the largest of the CPU's "
        f"{BF16_DRAWS + 1} gaps over audio copies) {old_share}{second}")
    if misses:
        fail(f"bf16 train step, card vs CPU: {misses} break the median "
             f"rule: {read}")
    log(f"phase 9b: held, largest upper share "
        f"{max(r[-1] if second else r[0] for r in read.values())}, "
        f"smallest move ratio {min(r[1] for r in read.values())}")


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


def same_notes(what, got, ref, tol: float = POST_ATOL,
               near_tol: float | None = None) -> tuple:
    """Two (T, 88) posteriograms within `tol`, and equal notes on every
    pitch with no element of `ref` within `near_tol` (`tol` if None) of
    0.5. Returns (max abs diff, pitches set aside, notes)."""
    from reconvat_tpu_torch import decode

    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"{what}: posteriogram {got.shape} against {ref.shape}")
    diff = float(np.abs(got - ref).max())
    if diff > tol:
        fail(f"{what}: posteriograms differ by {diff}")
    near = (np.abs(ref - 0.5) < (tol if near_tol is None else near_tol)
            ).any(axis=0)
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


def sharpen_output(model, clips, scale: float = 16.0, lin=None) -> None:
    """Scale the output layer by `scale`, then shift each pitch's bias to
    the middle of the widest gap between consecutive logits of the clips
    (bucketed and exact, true frames) in its top 1.5-2.5 %: ~2 % active
    bins per pitch and no logit at the threshold. At random init a few
    pitches carry all the activity and sit on the threshold, where the
    notes comparison has to set them aside. `lin`: the output layer,
    ReconVAT's `transcriber.linear1` by default."""
    lin = model.transcriber.linear1 if lin is None else lin
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


def write_corpus(root: str, seed: int = 0, labeled: int = 4) -> dict:
    """Synthetic MAPS and MAESTRO corpora under root, 16 kHz WAV: MAPS
    `labeled` songs in AkPnBcht (TSV), one each in ENSTDkAm and ENSTDkCl,
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
    for group, count in (("AkPnBcht", labeled), ("ENSTDkAm", 1),
                         ("ENSTDkCl", 1)):
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


def train_cli(overrides: dict, env: dict, cli=None) -> dict:
    """One run of the training CLI through its `Experiment` with the
    phase's corpus and overrides, instrumented: each train step's kernel
    launches and each step interval of the loop's StepTimer, the
    host-blocking time of each `save_checkpoint`, the final evaluation's
    time. Every kernel count is set to 0 just before the run and read
    just after; the losses are checked finite (`RECONVAT_NAN_CHECKS`).
    `cli`: the CLI's module, `train_UNet_VAT` by default."""
    from reconvat_tpu_torch.train import driver, profiler

    if cli is None:
        from reconvat_tpu_torch import train_UNet_VAT as cli

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


def bare_step_ms(model, batch_l, batch_ul, label: str, vat: bool = True,
                 steps: int = 10, profile_steps: int = 2,
                 warmup: int = 2) -> list:
    """ms/step of a training CLI's step without its loader: `model` (a copy
    of the CLI's) with a fresh train state, batches already on the card,
    two rounds of `steps` steps after `warmup`; then a profile of
    `profile_steps` steps (device busy; none at 0), logged under `label`.
    `vat`: the VAT step on batch_l and batch_ul, else the supervised step
    on batch_l."""
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    state = create_train_state(model)
    step = make_train_step(model, 1.0, vat=vat, use_unlabeled=vat)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(warmup):
        step(state, batch_l, batch_ul, gen)
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch_l, batch_ul, gen)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    if profile_steps:
        log_profile(label, "step", profile_steps, profile_groups(
            lambda: [step(state, batch_l, batch_ul, gen)
                     for _ in range(profile_steps)]))
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
    from reconvat_tpu_torch.models.reconvat import ReconVAT

    # the CLI's model (bf16, reconstruction=False) on one labeled and
    # eight unlabeled clips
    copy = ReconVAT(seed=42, reconstruction=False, compute_dtype="bfloat16")
    copy.load_state_dict(rec["model"].state_dict(), strict=True)
    batch_l, batch_ul = train_batches(5)
    bare = bare_step_ms(
        copy, {k: v[:1] for k, v in batch_l.items()}, batch_ul,
        "phase 11 bare CLI step profile (2 steps, B = 1 + 8, bf16, "
        "reconstruction=False)")
    ms = step_ms(rec)
    RESULTS["phase11_ms"] = float(np.median(ms))
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


def held_outputs(what, labels, k16, p16, k32, p32) -> tuple:
    """bf16_held of each output of a bf16 kernel (k16) against its bf16
    plain version (p16), the fp32 routes (k32, p32) on the same inputs
    unrounded; (largest diff over its limit, largest diff, the elements
    outside phases 3d-3f's per-element bound)."""
    share, worst, outside = 0.0, 0.0, 0
    for label, a, b, c, d in zip(labels, k16, p16, k32, p32):
        diff, tol = bf16_held(f"{what} {label}", a, b, c, d)
        share = max(share, diff / tol if tol else 0.0)
        worst = max(worst, diff)
        if a.dtype == torch.bfloat16:
            a, b = a.float(), b.float()
            outside += int(((a - b).abs() > ATTN_BF16_OUT_RTOL * b.abs()
                            + ATTN_BF16_OUT_FLOOR * b.abs().max()).sum())
    return share, worst, outside


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
        share, _, outside = held_outputs(what, ("out", "probs"), k16, p16,
                                         k32, p32)
        line = f"{b} x {t}: forward {(share, outside)}"
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
                share, _, outside = held_outputs(f"{what} {part}", labels,
                                                 *grads["16"], *grads["32"])
                line += f"; {part} {(share, outside)}"
        read.append(line)
    log(f"phase 11c bf16 attention kernels at the training CLI's shapes "
        f"(B x T frames: the labeled chain, the batched VAT chain, the "
        f"evaluation bucket) against their bf16 plain versions by "
        f"bf16_held (limit {BF16_FACTOR} x the plain versions' "
        f"bf16-vs-fp32 gap + the fp32 kernel's gap; fp32 kernels within "
        f"{ATTN_TOL} and {GRAD_TOL} over max|ref| of their plain "
        f"versions); by part (largest diff over its limit, elements "
        f"outside phases 3d-3f's per-element bound): {'; '.join(read)}")


# the attention wrappers, each a row of the kernels line in each operand
# dtype
ATTENTION_ROWS = ("banded_attention_fwd", "banded_attention_bwd",
                  "banded_attention_bwd_partials")


def attention_draw(rng, b: int, t: int, h: int, d: int):
    """(q, kpad, vpad, d_out) fp32 and rel at B x T frames, H heads of Dh,
    drawn as phase 3's."""
    import torch.nn.functional as F

    hw = (W - 1) // 2

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=rng, device="cuda") * scale

    q = randn(b, t, h, d, scale=d ** -0.25)
    kpad = F.pad(randn(b, t, h, d, scale=d ** -0.25), (0, 0, 0, 0, hw, hw))
    vpad = F.pad(randn(b, t, h, d), (0, 0, 0, 0, hw, hw))
    d_out = randn(b, t, h, d)
    return (q, kpad, vpad, d_out), randn(h, d, W, scale=0.1 * d ** -0.25)


def time_rows_at(rows, x32, rel, errs, suffix: str = "_h6",
                 dtypes=(torch.float32, torch.bfloat16),
                 names=ATTENTION_ROWS) -> None:
    """Each attention row's ms, plain_ms, library_ms and bound at the
    shape of x32 (q, kpad, vpad, d_out; bf16 rows on them rounded), for
    the operand `dtypes` and the wrappers `names`, into the row under
    `<key><suffix>`, with its max abs err from `errs`."""
    import torch.nn.functional as F

    from reconvat_tpu_torch.ops import banded_attention_kernel as bak

    by_name = {row["name"]: row for row in rows}
    b, L, h, d = x32[0].shape
    fwd_flops = b * L * h * W * (3 * 2 * d + 5)
    bwd_flops = b * L * h * W * (15 * d + 10)
    part_flops = bwd_flops - b * L * h * W * 10
    for dtype in dtypes:
        q, kpad, vpad, d_out = (t.to(dtype) for t in x32)
        size = q.element_size()
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
        tag = "_bf16" if dtype == torch.bfloat16 else ""
        out, probs = bak.banded_attention_fwd(q, kpad, vpad, rel, W)
        backward = "banded_attention_bwd" in names
        if backward:
            grads = bak.banded_attention_bwd(q, kpad, vpad, rel, d_out, W)
            parts = bak.banded_attention_bwd_partials(q, kpad, vpad, rel,
                                                      d_out, W)
        qh, kh, vh, mask = (t.to(dtype).detach().requires_grad_(i < 3)
                            for i, t in enumerate(sdpa_inputs(
                                *(x.float() for x in (q, kpad, vpad)), rel)))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  scale=1.0)

        def sdpa_fwd():
            with torch.no_grad():
                return sdpa()

        sdpa_out = sdpa()
        g = d_out.transpose(1, 2)
        fwd_in = size * (q.numel() + kpad.numel() + vpad.numel()) \
            + 4 * rel.numel()
        bwd_in = fwd_in + size * d_out.numel()
        args = (q, kpad, vpad, rel, d_out, W)
        spec = (
            ("banded_attention_fwd", fwd_flops,
             fwd_in + size * out.numel() + 4 * probs.numel(),
             lambda: bak.banded_attention_fwd(*args[:4], W),
             lambda: bak.banded_attention(*args[:4], W), sdpa_fwd),
        ) + (() if not backward else (
            ("banded_attention_bwd", bwd_flops,
             bwd_in + size * sum(t.numel() for t in grads[:3])
             + 4 * grads[3].numel(),
             lambda: bak.banded_attention_bwd(*args),
             lambda: bak.banded_attention_bwd_plain(*args),
             lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), g,
                                         retain_graph=True)),
            ("banded_attention_bwd_partials", part_flops,
             bwd_in + size * parts[0].numel()
             + 4 * sum(t.numel() for t in parts[1:]),
             lambda: bak.banded_attention_bwd_partials(*args),
             lambda: bak.banded_attention_bwd_partials_plain(*args), None)))
        for name, flops, nbytes, kernel, plain, library in spec:
            bound_ms, bound_by = bound(flops, nbytes, peak)
            row = by_name[name + tag]
            row.update({
                f"ms{suffix}": time_ms(kernel),
                f"plain_ms{suffix}": time_ms(plain),
                f"bound_ms{suffix}": bound_ms,
                f"bound_by{suffix}": bound_by,
                f"library_ms{suffix}": (time_ms(library) if library
                                        else None),
                f"max_abs_err{suffix}": errs[name + tag]})
        del qh, kh, vh, mask, sdpa_out


def hold_attention_at(rng, b: int, t: int, h: int, d: int,
                      names=ATTENTION_ROWS, fwd16_rule: bool = False):
    """The attention wrappers `names` at B x T frames, H heads of Dh, on
    `attention_draw`'s inputs: the fp32 kernels within ATTN_TOL / GRAD_TOL
    (over max|ref|) of their plain versions and within TF32X3_TRUTH_FACTOR
    x the fp32 plain version's error against float64; the bf16 kernels
    against their bf16 plain versions by `bf16_held` (phase 11c's rule);
    with `fwd16_rule` the bf16 forward also by phase 3d's per-element
    rule and, on the bf16 operands widened, within TF32X3_TRUTH_FACTOR x
    its bf16 plain version's error against float64. Returns (x32, rel,
    the errors by row name, a line to log)."""
    from reconvat_tpu_torch.ops import banded_attention_kernel as bak

    x32, rel = attention_draw(rng, b, t, h, d)
    x16 = tuple(x.to(torch.bfloat16) for x in x32)
    x64 = tuple(x.double() for x in x32)
    what = f"attention at {b} x {t}, H={h}, Dh={d}"
    errs, line = {}, [f"{b} x {t}, H={h}, Dh={d}:"]
    for name, fn, plain, labels in (
            ("banded_attention_fwd", bak.banded_attention_fwd,
             bak.banded_attention, ("out", "probs")),
            ("banded_attention_bwd", bak.banded_attention_bwd,
             bak.banded_attention_bwd_plain, ("dq", "dk", "dv", "drel")),
            ("banded_attention_bwd_partials",
             bak.banded_attention_bwd_partials,
             bak.banded_attention_bwd_partials_plain,
             ("dq", "dk_part", "dv_part", "drel_part"))):
        if name not in names:
            continue

        def call(f, x):
            r = rel.double() if x[0].dtype == torch.float64 else rel
            return (f(*x[:3], r, W) if name == "banded_attention_fwd"
                    else f(*x[:3], r, x[3], W))

        k32, p32 = call(fn, x32), call(plain, x32)
        k16, p16 = call(fn, x16), call(plain, x16)
        torch.cuda.synchronize()
        if name == "banded_attention_fwd":
            errs[name] = max(check_close(f"fp32 {what} {label}", a, r,
                                         ATTN_TOL)
                             for label, a, r in zip(labels, k32, p32))
        else:
            errs[name] = check_grads(f"fp32 {what} {name}", k32, p32,
                                     labels)
        truth = nearer_float64(f"fp32 {what} {name}", k32, p32,
                               call(plain, x64), labels)
        if k16[0].dtype != torch.bfloat16:
            fail(f"bf16 {what} {name} returned {k16[0].dtype}")
        share, errs[name + "_bf16"], outside = held_outputs(
            f"{what} {name}", labels, k16, p16, k32, p32)
        extra = ""
        if name == "banded_attention_fwd" and fwd16_rule:
            err_out, err_p, moved = check_bf16_fwd(f"bf16 {what}", k16, p16)
            truth16 = nearer_float64(
                f"bf16 {what} {name}", k16, p16,
                call(plain, tuple(x.double() for x in x16)), labels)
            extra = (f"; bf16 by phase 3d's rule: out err {err_out}, probs "
                     f"{err_p}, share of out elements moved {moved}; "
                     f"against float64 {truth16}")
        line.append(f"{name} fp32 err {errs[name]}, against float64 "
                    f"{truth}; bf16 share of limit {share}, elements "
                    f"outside phases 3d-3f's bound {outside}{extra}")
    return x32, rel, errs, " ".join(line)


def phase_attention_unet_onset(rows) -> None:
    """Phase 12: the six attention rows at UNetOnset's Stack shapes (H =
    UO_H heads of Dh = UO_D), B x 640 frames (the training CLI's labeled
    and unlabeled chains) and 1 x the evaluation bucket of a
    CORPUS_SECONDS song, forward, backward and its first pass: the fp32
    kernels within ATTN_TOL / GRAD_TOL (over max|ref|) of their plain
    versions and within TF32X3_TRUTH_FACTOR x the fp32 plain version's
    error against float64; the bf16 kernels against their bf16 plain
    versions by `bf16_held` (phase 11c's rule). Then each row's time and
    bound at B x 640 (keys `*_h6` of the kernels line)."""
    from reconvat_tpu_torch.models.common import frames_in, next_bucket

    bucket = next_bucket(frames_in(int(CORPUS_SECONDS * 16000)) + 2)
    rng = torch.Generator(device="cuda").manual_seed(12)
    read = []
    for b, t in ((B, frames_in(SAMPLES)), (1, bucket)):
        x32, rel, errs, line = hold_attention_at(rng, b, t, UO_H, UO_D)
        if b == B:
            time_rows_at(rows, x32, rel, errs)
        read.append(line)
        del x32
    timing = {row["name"]: {k: row[k] for k in (
        "ms_h6", "plain_ms_h6", "library_ms_h6", "bound_ms_h6",
        "bound_by_h6")} for row in rows if "ms_h6" in row}
    log(f"phase 12 attention kernels at UNetOnset's Stack shapes (H={UO_H}, "
        f"Dh={UO_D}, W={W}; B x T frames: the training CLI's chains, the "
        f"evaluation bucket) against their plain versions (fp32 {ATTN_TOL}, "
        f"{GRAD_TOL} over max|ref|, against float64 at most "
        f"{TF32X3_TRUTH_FACTOR} x the plain version's error; bf16 by "
        f"bf16_held): {'; '.join(read)}; times at {B} x 640: {timing}")


def onset_batches(seed: int):
    """train_batches(seed) with ~1 % of the onset labels active."""
    batch_l, batch_ul = train_batches(seed)
    rng = np.random.RandomState(seed + 100)
    batch_l["onset"] = torch.tensor(
        rng.rand(*batch_l["frame"].shape) < 0.01, dtype=torch.float32,
        device="cuda")
    return batch_l, batch_ul


def phase_unet_onset_step(rows) -> None:
    """Phase 12a: UNetOnset (fp32, reconstruction=True) on B labeled + B
    unlabeled clips: two VAT train steps with the counts reset just
    before and read just after, then one step through the kernels against
    the same step through the plain versions (phase 8's rule: losses and
    every gradient without VAT, losses with VAT at xi 1e-2)."""
    from reconvat_tpu_torch.models.unet_onset import UNetOnset
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    model = UNetOnset(seed=0, reconstruction=True)
    state = create_train_state(model)
    step = make_train_step(model, 1.0, vat=True, use_unlabeled=True)
    batches = [onset_batches(seed) for seed in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, *batches[0], gen)                        # warm-up
    ms, peak_gb, launches, losses = counted_steps(step, state, batches, gen,
                                                  2, "fp32")
    for row in rows:
        row["launches_unet_onset_step"] = launches[row["name"]] / 2
    last = {k: v.item() for k, v in losses[-1].items()}
    log(f"phase 12a UNetOnset train step (fp32, reconstruction=True, VAT, "
        f"B={B} + {B} x {SAMPLES} samples): {ms} ms/step, peak "
        f"{peak_gb} GB, launches per step "
        f"{ {k: n / 2 for k, n in launches.items()} }, last losses {last}; "
        f"kernels vs plain versions: {compare_routes(model, *batches[0])}")


def phase_unet_onset_cli(rows, tmp: str) -> dict:
    """Phase 12b: `python -m reconvat_tpu_torch.train_UNet_Onset_VAT` at its
    defaults (bf16, reconstruction=False, VAT, B = 8 labeled + 8
    unlabeled x 640 frames) on a corpus of write_corpus's layout with B
    labeled songs, TRAIN_CLI's overrides: 2 epochs of 10 steps, logging, a
    checkpoint, the full-song evaluation; then the bare step of its
    weights at the same batch, and its profile."""
    import pickle

    from reconvat_tpu_torch import train_UNet_Onset_VAT as onset_cli
    from reconvat_tpu_torch.models.unet_onset import UNetOnset
    from reconvat_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    env = write_corpus(os.path.join(tmp, "corpus_onset"), seed=1, labeled=B)
    corpus_s = time.perf_counter() - t0
    rec = train_cli(dict(TRAIN_CLI, root=os.path.join(tmp, "runs_onset")),
                    env, onset_cli)
    launches, steps = rec["launches"], rec["steps"]
    for name, n in launches.items():
        expected = name == "mel_power" or name.endswith("_bf16")
        if (n > 0) != expected:
            fail(f"the UNetOnset training CLI (bf16) launched {name} {n} "
                 f"times")
    if steps != 20 or rec["state"].step != 20:
        fail(f"the UNetOnset CLI ran {steps} steps, state at "
             f"{rec['state'].step}")
    for row in rows:
        row["launches_unet_onset_cli"] = launches[row["name"]]
    path = ckpt.latest_checkpoint(rec["logdir"])
    if path is None or os.path.basename(path) != "model-2":
        fail(f"the UNetOnset CLI's latest checkpoint is {path}")
    with open(os.path.join(rec["logdir"], "result_dict"), "rb") as f:
        result = pickle.load(f)
    if sorted(result) != sorted(ONSET_RESULT_KEYS):
        fail(f"UNetOnset result_dict keys {sorted(result)}")
    if not all(np.isfinite(v).all() for v in result.values()):
        fail("UNetOnset result_dict holds a non-finite value")
    copy = UNetOnset(seed=42, reconstruction=False, compute_dtype="bfloat16")
    copy.load_state_dict(rec["model"].state_dict(), strict=True)
    bare = bare_step_ms(copy, *onset_batches(5),
                        f"phase 12b bare UNetOnset CLI step profile (2 "
                        f"steps, B = {B} + {B}, bf16, reconstruction=False)")
    del copy
    ms = step_ms(rec)
    per_step = {k: n / steps for k, n in rec["step_launches"].items()}
    audio_s = B * SAMPLES / 16000                  # labeled audio per step
    log(f"phase 12b UNetOnset training CLI (bf16, reconstruction=False, "
        f"VAT, batch_size {B} unlabeled + train_batch_size {B} labeled x "
        f"{SAMPLES} samples, {TRAIN_CLI}; corpus of {B + 10} x "
        f"{CORPUS_SECONDS} s written in {corpus_s} s): {steps} steps; "
        f"ms/step (loop StepTimer, within epochs) median {np.median(ms)} "
        f"mean {np.mean(ms)} min {min(ms)} max {max(ms)}; audio-s/s "
        f"trained (labeled) {audio_s / (np.median(ms) / 1e3)}; kernel "
        f"launches per train step {per_step}; launches in the whole run "
        f"{launches}; final evaluation {rec['eval_ms'][0] / 2} ms/song (2 "
        f"songs); save_checkpoint host-blocking ms {rec['ckpt_ms']}; peak "
        f"device GB {rec['peak_gb']}; run wall {rec['wall_s']} s; the bare "
        f"step, two rounds of 10: {bare} ms/step; note f1 "
        f"{np.mean(result['metric/note/f1'])}, frame f1 "
        f"{np.mean(result['metric/frame/f1'])}")
    return rec


def phase_evaluate_cli(rows, flagship, onset, tmp: str) -> None:
    """Phase 12c: `python -m reconvat_tpu_torch.evaluate_cli` through its
    `Experiment` on the `model-2` of phase 12b (UNet_Onset) and of phase
    11 (ReconVAT), counts reset just before and read just after. Then, on
    each model's weights with its output layers sharpened
    (`sharpen_output`: UNetOnset's onset head, then its frame head), the
    bucketed full-song posteriograms through the kernels against the
    plain versions (`same_notes`, each roll), a non-zero note count, and
    the CLI on a `.pt` of those weights equal to the kernels' evaluation
    (deterministic cuDNN). Last, one 60-s song streamed with the
    sharpened UNetOnset against its bucketed transcription, both rolls
    (phase 10b's bounds)."""
    import pickle

    from reconvat_tpu_torch import decode, evaluate, evaluate_cli
    from reconvat_tpu_torch.data.datasets import MAPS
    from reconvat_tpu_torch.models import get_model
    from reconvat_tpu_torch.train import checkpoint as ckpt

    counters = kernel_counters()
    cudnn = torch.backends.cudnn
    read, onset_model = [], None
    for model_type, rec, keys, corpus in (
            ("UNet_Onset", onset, ONSET_RESULT_KEYS, "corpus_onset"),
            ("ReconVAT", flagship, RESULT_KEYS, "corpus")):
        heads = ("frame", "onset") if model_type == "UNet_Onset" else (
            "frame",)
        maps = os.path.join(tmp, corpus, "MAPS")
        weight = ckpt.latest_checkpoint(rec["logdir"])
        out = os.path.join(tmp, f"evaluated_{model_type}")
        saved_root = os.environ.get("RECONVAT_MAPS_ROOT")
        os.environ["RECONVAT_MAPS_ROOT"] = maps

        def run_cli(weight_file):
            """(result_dict, launches, seconds) of one CLI run."""
            torch.cuda.synchronize()
            for f, c in counters.values():
                setattr(f, c, 0)
            t0 = time.perf_counter()
            evaluate_cli.ex.run(evaluate_cli.main, dict(
                model_type=model_type, weight_file=weight_file,
                output_folder=out))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = {k: getattr(f, c) for k, (f, c) in counters.items()}
            with open(os.path.join(evaluate_cli.ex.current_run.config[
                    "logdir"], "result_dict_infer"), "rb") as f:
                return pickle.load(f), launches, sec

        try:
            result, launches, sec = run_cli(weight)
            for name, n in launches.items():
                expected = name in ("mel_power", "banded_attention_fwd")
                if (n > 0) != expected:
                    fail(f"the evaluation CLI ({model_type}, fp32) launched "
                         f"{name} {n} times")
            for row in rows:
                row[f"launches_evaluate_cli_{model_type}"] = \
                    launches[row["name"]]
            if sorted(result) != sorted(keys) or not all(
                    np.isfinite(v).all() for v in result.values()):
                fail(f"evaluation CLI ({model_type}) result_dict keys "
                     f"{sorted(result)} or a non-finite value")
            songs = MAPS(maps, groups=["ENSTDkAm", "ENSTDkCl"],
                         sequence_length=None, verbose=False)
            models = {}
            for route in ("kernels", "plain"):
                m = get_model(model_type, reconstruction=False, seed=0)
                m.load_reference_weights(ckpt.load_state(weight)["model"])
                m.use_kernels(route == "kernels")
                models[route] = m
            clips = [torch.from_numpy(s["audio"])[None].cuda()
                     for s in songs]
            layers = ([models["kernels"].transcriber.linear_onset,
                       models["kernels"].transcriber.combine_stack.linear]
                      if model_type == "UNet_Onset" else [None])
            for lin in layers:
                sharpen_output(models["kernels"], clips, lin=lin)
            sharpened = models["kernels"].state_dict()
            models["plain"].load_state_dict(sharpened, strict=True)
            runners = {k: evaluate.make_bucketed_runner(m)
                       for k, m in models.items()}
            diffs, notes, set_aside = [], 0, 0
            for song in songs:
                pk, lk, _ = runners["kernels"](song)
                pp, lp, _ = runners["plain"](song)
                for head in heads:
                    d, n_aside, _ = same_notes(
                        f"phase 12c {model_type} {head}",
                        pk[head][0].float().cpu().numpy(),
                        pp[head][0].float().cpu().numpy())
                    diffs.append(d)
                    set_aside += n_aside
                for k in lp:
                    if not np.isclose(float(lk[k]), float(lp[k]), rtol=1e-4,
                                      atol=1e-6):
                        fail(f"phase 12c {model_type} loss {k}: kernels "
                             f"{float(lk[k])}, plain {float(lp[k])}")
                p, _ = decode.extract_notes_wo_velocity(
                    pk["onset"][0].float().cpu().numpy(),
                    pk["frame"][0].float().cpu().numpy(), rule="rule2")
                notes += len(p)
            if notes == 0:
                fail(f"phase 12c {model_type}: no note in the sharpened "
                     f"evaluation")
            pt = os.path.join(tmp, f"{model_type}_sharpened.pt")
            torch.save(sharpened, pt)
            cudnn.deterministic = True
            try:
                sharp, _, sharp_sec = run_cli(pt)
                mine = evaluate.evaluate_wo_velocity(
                    songs, evaluate.make_bucketed_runner(models["kernels"]),
                    reconstruction=False)
            finally:
                cudnn.deterministic = False
            for k in mine:
                if not np.allclose(sharp[k], mine[k], rtol=0, atol=1e-12):
                    fail(f"phase 12c {model_type}: the CLI's {k} "
                         f"{sharp[k]}, the kernels' evaluation {mine[k]}")
        finally:
            if saved_root is None:
                os.environ.pop("RECONVAT_MAPS_ROOT", None)
            else:
                os.environ["RECONVAT_MAPS_ROOT"] = saved_root
        if model_type == "UNet_Onset":
            onset_model = models["kernels"]
        read.append(
            f"{model_type}: CLI on {os.path.basename(weight)} {sec} s "
            f"(2 songs), launches {launches}, note f1 "
            f"{np.mean(result['metric/note/f1'])}; sharpened: kernels vs "
            f"plain max abs diff {max(diffs)} (tol {POST_ATOL}), {notes} "
            f"notes, {set_aside} pitch columns set aside, the CLI on its "
            f".pt ({sharp_sec} s) equal to the kernels' evaluation, note "
            f"f1 {np.mean(sharp['metric/note/f1'])}, frame f1 "
            f"{np.mean(sharp['metric/frame/f1'])}")

    rng = np.random.RandomState(3)
    _, audio = synth_song(rng, ONSET_SONG_SECONDS)
    song = torch.from_numpy(audio.astype(np.float32) / 32768.0)[None].cuda()
    streamed = onset_model.transcribe_streaming(song, STREAM_W, STREAM_H)
    full = onset_model.transcribe(song, CLI_BUCKET)
    stream_read = {}
    for head in ("onset", "frame"):
        gap = (streamed[head] - full[head].cpu()).abs()
        inner = gap[:, :-STREAM_TAIL].max().item()
        tail = gap[:, -STREAM_TAIL:].max().item()
        if inner > POST_ATOL or tail > STREAM_TAIL_ATOL:
            fail(f"UNetOnset streamed and bucketed {head} differ by {inner} "
                 f"inside and {tail} over the last {STREAM_TAIL} frames")
        stream_read[head] = (inner, tail,
                             (streamed[head] > 0.5).float().mean().item())
    log(f"phase 12c evaluation CLI: {'; '.join(read)}; UNetOnset streaming "
        f"(1 x {ONSET_SONG_SECONDS} s, W={STREAM_W} H={STREAM_H}) against "
        f"bucketed transcribe (bucket {CLI_BUCKET}), by roll (max abs diff "
        f"inside, tol {POST_ATOL}; over the last {STREAM_TAIL} frames, tol "
        f"{STREAM_TAIL_ATOL}; share of bins above 0.5) {stream_read}")


def phase_mel_at_family_shapes(fe) -> str:
    """The mel kernel against its plain version at the shapes the new
    paths give it (B x T frames): the O&F steps' 8 x 640, Thickstun's 1 x
    640, Prestack's 1 x PRESTACK_FRAMES crops and the evaluation bucket
    1 x 1280."""
    from reconvat_tpu_torch.ops.mel_kernel import mel_power, mel_power_plain

    rng = torch.Generator(device="cuda").manual_seed(13)
    hop = fe.stft.hop_length
    args = (fe.stft.wcos, fe.stft.wsin, fe.mel_basis, hop)
    errs = []
    for b, t in ((B, 640), (1, 640), (1, PRESTACK_FRAMES), (1, 1280)):
        x = torch.randn((b, t * hop - 1), generator=rng, device="cuda") * 0.1
        got = mel_power(x, *args, fe.stft.window, fe.twiddle, fe.band)
        if tuple(got.shape) != (b, t, fe.n_mels):
            fail(f"mel_power at {b} x {t} frames gave {tuple(got.shape)}")
        errs.append(f"{b} x {t}: " + str(check_close(
            f"mel_power at {b} x {t} frames", got, mel_power_plain(x, *args),
            MEL_TOL)))
    return "; ".join(errs)


def phase_onsets_frames_steps(rows, fe) -> None:
    """Phase 13: the O&F family's fp32 train steps at its CLI's shape
    (model_complexity 48, 8 x 640 frames): `OnsetsAndFrames` without VAT
    and `FrameStackVAT` with VAT on 8 + 8 clips (the CLI's xi 1e-6 and
    eps 0.1), each timed with the counts reset just before and read just
    after (mel launches per step) and held through the kernels against the
    plain versions (phase 8's rule, the same weights, dropout masks and
    generator state); the plain O&F step profiled (the cuDNN RNN
    operators' device ms against the convolutions', the busy share)."""
    from reconvat_tpu_torch.models.onsets_frames import (FrameStackVAT,
                                                         OnsetsAndFrames)
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    mel_read = phase_mel_at_family_shapes(fe)
    batches = [onset_batches(seed) for seed in range(2)]
    read = []
    for key, cls, vat in (("onsets_frames_step", OnsetsAndFrames, False),
                          ("framestack_vat_step", FrameStackVAT, True)):
        model = cls(seed=0, xi=1e-6, eps=0.1)
        state = create_train_state(model)
        step = make_train_step(model, 1.0, vat=vat, use_unlabeled=vat)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step(state, *batches[0], gen)                    # warm-up
        n = 3
        ms, peak_gb, launches, losses = counted_steps(
            step, state, batches, gen, n, "fp32", path_kernels={"mel_power"})
        for row in rows:
            row[f"launches_{key}"] = launches[row["name"]] / n
        if not vat:
            # one step of the plain O&F step: the profiler's own pass over
            # a step's 15,000 device operations (40,000 with VAT) takes
            # seconds
            log_profile(f"phase 13 {cls.__name__} step profile (1 step, "
                        f"fp32, B = {B} x 640)", "step", 1,
                        profile_groups(lambda: step(state, *batches[0],
                                                    gen)))
        read.append(
            f"{cls.__name__} ({'VAT, 8 + 8' if vat else 'no VAT, 8'} x 640):"
            f" {ms} ms/step, peak {peak_gb} GB, mel launches per step "
            f"{launches['mel_power'] / n}, last losses "
            f"{ {k: v.item() for k, v in losses[-1].items()} }; kernels vs "
            f"plain versions: {compare_routes(model, *batches[0])}")
        del model, state, step
        torch.cuda.empty_cache()
    log(f"phase 13 the O&F family's train steps (fp32, model_complexity "
        f"48): {'; '.join(read)}; the mel kernel at the family's shapes, max "
        f"abs err against its plain version (tol {MEL_TOL}): {mel_read}")


def _corpus_env(tmp: str) -> dict:
    """The RECONVAT_*_ROOT variables of phase 12b's corpus (B labeled
    songs)."""
    root = os.path.join(tmp, "corpus_onset")
    return {"RECONVAT_MAPS_ROOT": os.path.join(root, "MAPS"),
            "RECONVAT_MAESTRO_ROOT": os.path.join(root, "MAESTRO")}


def _only_mel(what, launches) -> None:
    for name, n in launches.items():
        if (n > 0) != (name == "mel_power"):
            fail(f"{what} launched {name} {n} times")


def _result(logdir, name, keys) -> dict:
    import pickle

    with open(os.path.join(logdir, name), "rb") as f:
        result = pickle.load(f)
    if sorted(result) != sorted(keys):
        fail(f"{logdir}/{name} keys {sorted(result)}")
    if not all(np.isfinite(v).all() for v in result.values()):
        fail(f"{logdir}/{name} holds a non-finite value")
    return result


def phase_onsets_frames_cli(rows, tmp: str) -> None:
    """Phase 13a: `python -m reconvat_tpu_torch.train_baseline_onset_frame_
    VAT` through its `Experiment` on phase 12b's corpus with TRAIN_CLI's
    overrides, at its defaults (`onset_frame`, fp32, VAT off, 8 labeled
    clips of 640 frames, 10 steps an epoch) and with `model_name=frame
    VAT=True` (8 + 8 clips; its `tensorboard_log` differentiates the
    eval-mode VAT through the BiLSTM, cuDNN's RNN backward); each against
    its bare step on the same batch."""
    from reconvat_tpu_torch import train_baseline_onset_frame_VAT as of_cli
    from reconvat_tpu_torch.models.onsets_frames import (FrameStackVAT,
                                                         OnsetsAndFrames)

    env = _corpus_env(tmp)
    read = []
    for key, overrides, cls in (
            ("of_cli", {}, OnsetsAndFrames),
            ("of_cli_frame_vat", {"model_name": "frame", "VAT": True},
             FrameStackVAT)):
        rec = train_cli(dict(TRAIN_CLI, root=os.path.join(tmp, key),
                             **overrides), env, of_cli)
        _only_mel(f"the O&F CLI ({overrides})", rec["launches"])
        if rec["steps"] != 20 or rec["state"].step != 20:
            fail(f"the O&F CLI ran {rec['steps']} steps")
        for row in rows:
            row[f"launches_{key}"] = rec["launches"][row["name"]]
        result = _result(rec["logdir"], "result_dict",
                         OF_RESULT_KEYS[overrides.get("model_name",
                                                      "onset_frame")])
        vat = overrides.get("VAT", False)
        copy = cls(seed=42, xi=1e-6, eps=0.1)
        copy.load_state_dict(rec["model"].state_dict(), strict=True)
        batch_l, batch_ul = onset_batches(6)
        # the step phase 13 profiled, at the CLI's weights
        bare = bare_step_ms(copy, batch_l, batch_ul, "", vat=vat, steps=3,
                            profile_steps=0)
        del copy
        torch.cuda.empty_cache()
        ms = step_ms(rec)
        per_step = rec["step_launches"]["mel_power"] / rec["steps"]
        read.append(
            f"{overrides or 'defaults'}: ms/step (loop StepTimer, within "
            f"epochs) median {np.median(ms)} mean {np.mean(ms)} min "
            f"{min(ms)} max {max(ms)}, the bare step {bare}; mel launches "
            f"per step {per_step}, in the run {rec['launches']['mel_power']};"
            f" final evaluation {rec['eval_ms'][0] / 2} ms/song (2 songs of "
            f"{CORPUS_SECONDS} s); save_checkpoint ms {rec['ckpt_ms']}; peak "
            f"device GB {rec['peak_gb']}; run wall {rec['wall_s']} s; note "
            f"f1 {np.mean(result['metric/note/f1'])}, frame f1 "
            f"{np.mean(result['metric/frame/f1'])}")
    log(f"phase 13a the O&F training CLI (fp32, {B} labeled x 640 frames, "
        f"{TRAIN_CLI}): {'; '.join(read)}")


def phase_baseline_clis(rows, tmp: str) -> None:
    """Phase 13b: the bare Prestack step at 640 frames (its peak memory);
    `train_baseline_Thickstun` and `train_baseline_Prestack` for one epoch
    at batch 1 (a full sweep of phase 12b's B labeled songs; Thickstun on
    640-frame crops, Prestack on PRESTACK_FRAMES), each against its bare
    step; then `evaluate_cli` on each `model-1`, counts
    reset just before and read just after, and the bucketed full-song
    posteriograms of those weights through the kernels against the plain
    versions (`same_notes`)."""
    from reconvat_tpu_torch import evaluate, evaluate_cli
    from reconvat_tpu_torch import train_baseline_Prestack as prestack_cli
    from reconvat_tpu_torch import train_baseline_Thickstun as thickstun_cli
    from reconvat_tpu_torch.data.datasets import MAPS
    from reconvat_tpu_torch.models import get_model
    from reconvat_tpu_torch.train import checkpoint as ckpt
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    env = _corpus_env(tmp)
    counters = kernel_counters()
    # the bare Prestack step at the CLI's 640 frames, for its peak (the
    # reason for PRESTACK_FRAMES)
    model = get_model("Prestack", seed=0)
    step = make_train_step(model, 1.0, vat=False, use_unlabeled=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(create_train_state(model),
         {k: v[:1] for k, v in onset_batches(7)[0].items()}, None, None)
    read = [f"the bare Prestack step at 1 x 640 frames: peak "
            f"{torch.cuda.max_memory_allocated() / 1e9} GB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 1e9} GB"]
    del model, step
    torch.cuda.empty_cache()
    for name, cli, frames in (("Thickstun", thickstun_cli, 640),
                              ("Prestack", prestack_cli, PRESTACK_FRAMES)):
        rec = train_cli(dict(TRAIN_CLI, epoches=1, saving_freq=1,
                             sequence_length=frames * 512,
                             root=os.path.join(tmp, name)), env, cli)
        _only_mel(f"the {name} CLI", rec["launches"])
        if rec["steps"] != B or rec["state"].step != B:
            fail(f"the {name} CLI ran {rec['steps']} steps, not one per "
                 f"labeled song")
        _result(rec["logdir"], "result_dict", BASELINE_RESULT_KEYS)
        copy = get_model(name, seed=42)
        copy.load_state_dict(rec["model"].state_dict(), strict=True)
        batch_l = {k: v[:1, :frames] if k != "audio"
                   else v[:1, :frames * 512]
                   for k, v in onset_batches(7)[0].items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bare = bare_step_ms(copy, batch_l, None, f"phase 13b bare {name} "
                            f"CLI step profile (1 step, fp32, 1 x {frames})",
                            vat=False, steps=1, profile_steps=1, warmup=1)
        bare_gb = torch.cuda.max_memory_allocated() / 1e9
        del copy
        torch.cuda.empty_cache()
        weight = ckpt.latest_checkpoint(rec["logdir"])
        if weight is None or os.path.basename(weight) != "model-1":
            fail(f"the {name} CLI's latest checkpoint is {weight}")
        saved_root = os.environ.get("RECONVAT_MAPS_ROOT")
        os.environ["RECONVAT_MAPS_ROOT"] = env["RECONVAT_MAPS_ROOT"]
        try:
            torch.cuda.synchronize()
            for f, c in counters.values():
                setattr(f, c, 0)
            t0 = time.perf_counter()
            evaluate_cli.ex.run(evaluate_cli.main, dict(
                model_type=name, weight_file=weight,
                output_folder=os.path.join(tmp, f"evaluated_{name}")))
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            launches = {k: getattr(f, c) for k, (f, c) in counters.items()}
            _only_mel(f"the evaluation CLI ({name})", launches)
            for row in rows:
                row[f"launches_{name.lower()}_cli"] = \
                    rec["launches"][row["name"]]
                row[f"launches_evaluate_cli_{name}"] = launches[row["name"]]
            result = _result(evaluate_cli.ex.current_run.config["logdir"],
                             "result_dict_infer", BASELINE_RESULT_KEYS)
        finally:
            if saved_root is None:
                os.environ.pop("RECONVAT_MAPS_ROOT", None)
            else:
                os.environ["RECONVAT_MAPS_ROOT"] = saved_root
        songs = MAPS(env["RECONVAT_MAPS_ROOT"],
                     groups=["ENSTDkAm", "ENSTDkCl"], sequence_length=None,
                     verbose=False)
        runners = {}
        for route in ("kernels", "plain"):
            m = get_model(name, seed=0)
            m.load_reference_weights(ckpt.load_state(weight)["model"])
            m.use_kernels(route == "kernels")
            runners[route] = evaluate.make_bucketed_runner(m)
        diffs, aside, notes = [], 0, 0
        for song in songs:
            pk, lk, _ = runners["kernels"](song)
            pp, lp, _ = runners["plain"](song)
            d, n_aside, n_notes = same_notes(
                f"phase 13b {name}", pk["frame"][0].float().cpu().numpy(),
                pp["frame"][0].float().cpu().numpy())
            diffs.append(d)
            aside += n_aside
            notes += n_notes
            for k in lp:
                if not np.isclose(float(lk[k]), float(lp[k]), rtol=1e-4,
                                  atol=1e-6):
                    fail(f"phase 13b {name} loss {k}: kernels "
                         f"{float(lk[k])}, plain {float(lp[k])}")
        del runners
        torch.cuda.empty_cache()
        ms = step_ms(rec, iteration=B)
        read.append(
            f"{name} (1 x {frames} frames): {rec['steps']} steps, ms/step "
            f"(loop StepTimer) median {np.median(ms)} min {min(ms)} max "
            f"{max(ms)}, the bare step {bare}, its peak {bare_gb} GB; mel launches in the run "
            f"{rec['launches']['mel_power']}; final evaluation "
            f"{rec['eval_ms'][0] / 2} ms/song; CLI peak GB {rec['peak_gb']};"
            f" run wall {rec['wall_s']} s; evaluation CLI {eval_s} s, mel "
            f"launches {launches['mel_power']}, note f1 "
            f"{np.mean(result['metric/note/f1'])}; kernels vs plain "
            f"posteriograms max abs diff {max(diffs)} (tol {POST_ATOL}), "
            f"{notes} notes, {aside} pitch columns set aside")
    log(f"phase 13b the baseline CLIs (fp32, batch 1, one epoch over {B} "
        f"songs) and the evaluation CLI on their model-1: {'; '.join(read)}")


def phase_families_bf16(rows, names=("OnsetsAndFrames", "FrameStack",
                                      "OnsetStack", "Thickstun", "Prestack"),
                        label: str = "13c") -> None:
    """Phase 13c (and 14c): the eval forward of each model in bf16
    (`compute_dtype='bfloat16'`, the fp32 model's weights): `transcribe`
    of 2 clips of 640 frames through the mel kernel against the plain mel
    route, both rolls, by `bf16_held`. The mel kernel is fp32 in both
    dtypes, so the two bf16 routes differ only by the frontend's fp32
    rounding carried through the bf16 trunk, where it can flip a bf16
    rounding; the limit is BF16_FACTOR x the plain route's own bf16-vs-fp32
    gap + the two fp32 routes' gap, all read in this run."""
    from reconvat_tpu_torch.models import get_model

    rng = np.random.RandomState(14)
    audio = torch.tensor(rng.randn(2, SAMPLES) * 0.1, dtype=torch.float32,
                         device="cuda")
    read = []
    for name in names:
        clip = audio[:, :PRESTACK_FRAMES * 512] if name == "Prestack" \
            else audio
        out = {}
        for dtype in (None, "bfloat16"):
            for route in ("kernels", "plain"):
                m = get_model(name, seed=0, compute_dtype=dtype)
                m.use_kernels(route == "kernels")
                out[dtype, route] = m.transcribe(clip)
                del m
        gaps = {}
        for roll in ("onset", "frame"):
            diff, tol = bf16_held(
                f"{name} {roll}", out["bfloat16", "kernels"][roll],
                out["bfloat16", "plain"][roll], out[None, "kernels"][roll],
                out[None, "plain"][roll])
            move = (out["bfloat16", "kernels"][roll]
                    - out[None, "kernels"][roll]).abs().max().item()
            if move == 0:
                fail(f"{name} {roll}: the bf16 model equals the fp32 one")
            gaps[roll] = (diff, tol, move)
        read.append(f"{name} {gaps}")
        torch.cuda.empty_cache()
    log(f"phase {label} bf16 eval forwards (2 x 640 frames; Prestack 2 x "
        f"{PRESTACK_FRAMES}), kernels vs plain mel route by bf16_held, per "
        f"roll (largest gap, limit, the kernel route's bf16-vs-fp32 move): "
        f"{'; '.join(read)}")


# Segmentation (phase 14): the song it streams and the halo of its
# `transcribe_streaming` (the 17 x 17 attention pair's reach at time / 16).
# The attention models (phase 15): their heads, 8 of Dh = 6 (width 48) and
# 8 of Dh = 96 (`OnsetsAndFramesSelfAttention`'s 768).
SEG_SONG_SECONDS, SEG_HALO = 60.0, 256
AM_H, AM_DH = 8, (6, 96)


def phase_segmentation_step(rows) -> None:
    """Phase 14: a Segmentation VAT train step at the CLI's shape (fp32,
    8 labeled + 8 unlabeled clips of 640 frames, xi 1e-6, eps 1e-2): three
    steps with the counts reset just before and read just after (the mel
    kernel, 2 launches a step, and no other), ms/step and peak GB; one
    step profiled (busy share, top device operations); then one step
    through the mel kernel against the plain mel route (phase 8's rule,
    the same weights, dropout masks and generator state; the VAT step's
    r_norm entries by the plain route's spread, `compare_routes`)."""
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    model = SemanticSegmentation(seed=0)
    state = create_train_state(model)
    step = make_train_step(model, 1.0, vat=True, use_unlabeled=True)
    batches = [train_batches(seed) for seed in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, *batches[0], gen)                        # warm-up
    n = 3
    ms, peak_gb, launches, losses = counted_steps(
        step, state, batches, gen, n, "fp32", path_kernels={"mel_power"})
    for row in rows:
        row["launches_segmentation_step"] = launches[row["name"]] / n
    log_profile(f"phase 14 Segmentation step profile (1 step, fp32, VAT, "
                f"B = {B} + {B} x 640)", "step", 1,
                profile_groups(lambda: step(state, *batches[0], gen)))
    log(f"phase 14 Segmentation train step (fp32, VAT, xi 1e-6, eps 1e-2, "
        f"B = {B} + {B} x 640 frames): {ms} ms/step, peak {peak_gb} GB, "
        f"mel launches per step {launches['mel_power'] / n}, last losses "
        f"{ {k: v.item() for k, v in losses[-1].items()} }; kernels vs "
        f"plain versions: "
        f"{compare_routes(model, *batches[0], r_norm_spread=True)}")


def rule_models(name: str) -> list:
    """The models whose train step a phase holds through the kernels
    against the plain versions (`compare_routes`), for `step_rule`: [(label,
    constructor, batches, trained with VAT)] of phase 8 ('flagship'), 12a
    ('onset'), 13 ('onsets-frames'), 14 ('segmentation'), 15a
    ('attention') or 16c ('cqt'), each as its phase builds and trains it."""
    from reconvat_tpu_torch.models import get_model
    from reconvat_tpu_torch.models.onsets_frames import (FrameStackVAT,
                                                         OnsetsAndFrames)
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
    from reconvat_tpu_torch.models.unet_onset import UNetOnset

    return {
        "flagship": [("ReconVAT", lambda: ReconVAT(seed=0), train_batches,
                      True)],
        "onset": [("UNetOnset", lambda: UNetOnset(seed=0,
                                                  reconstruction=True),
                   onset_batches, True)],
        "onsets-frames": [
            (cls.__name__, lambda cls=cls: cls(seed=0, xi=1e-6, eps=0.1),
             onset_batches, vat)
            for cls, vat in ((OnsetsAndFrames, False),
                             (FrameStackVAT, True))],
        "segmentation": [("SemanticSegmentation",
                          lambda: SemanticSegmentation(seed=0),
                          train_batches, True)],
        "attention": [
            (n + kw.get("version", ""),
             lambda n=n, kw=kw: get_model(n, seed=0, **kw), onset_batches,
             vat) for n, kw, vat in ATTENTION_MODELS],
        "cqt": [("ReconVAT on CQT", lambda: ReconVAT(seed=0, spec="CQT"),
                 train_batches, True)]}[name]


def step_rule(name: str, n_states: int) -> None:
    """The gradient rule of a phase's `compare_routes` (`rule_models(name)`)
    over several weight states. Trains each model at its phase's shape for
    4 steps at a time (with VAT where its phase trains with VAT); after
    each 4 it takes the step without VAT from that state through the
    kernels and through the plain versions (the same dropout masks, the
    Reconstructor's clamp-margin BCE, `route_objective`), and reads each
    gradient leaf's gap against its first limit (PROBE_FACTOR x the plain
    route's move under one probe + GRAD_FLOOR of the largest) and its
    second (+ PROBE_FACTOR x the plain route's spread under R_NORM_PROBES
    further probes), by `grad_rule`. Prints, per state, the largest share
    of each limit with its leaf, the leaves above the first limit with
    both shares, and one JSON line of every leaf's shares [first,
    second]."""
    import copy

    from reconvat_tpu_torch.kernels import _build
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    _build.build_all()
    log(f"{name} step rule: {nvidia_smi()}")
    for label, build, make_batches, vat in rule_models(name):
        model = build()
        state = create_train_state(model)
        step = make_train_step(model, 1.0, vat=vat, use_unlabeled=vat)
        batches = [make_batches(seed) for seed in range(2)]
        gen = torch.Generator(device=model.device).manual_seed(0)
        batch_l = batches[0][0]
        plain = copy.deepcopy(model)
        plain.use_kernels(False)
        for m in plain.modules():
            if isinstance(m, torch.nn.LSTM):
                m.flatten_parameters()
        beyond = 0
        for k in range(n_states):
            for i in range(4):
                step(state, *batches[i % 2], gen)
            start = {n: v.clone() for n, v in model.state_dict().items()}
            objective, _, keys = route_objective(model, plain, start,
                                                 batch_l)

            def run(m, bl, bul, vat):
                m.load_state_dict(start)
                return step_grads(m, bl, bul, seed=5, vat=vat,
                                  objective=objective)

            gk = run(model, batch_l, None, False)[1]
            gp = run(plain, batch_l, None, False)[1]
            gq = run(plain, probed(batch_l, 9, keys), None, False)[1]
            top, read = grad_rule(gk, gp, gq, plain_spread(
                run, plain, batch_l, gp, keys))
            shares = {n: (d / a, d / b) for n, (d, a, b, _) in read.items()}
            first = max((v[0], n) for n, v in shares.items())
            second = max((v[1], n) for n, v in shares.items())
            above = [(n, v) for n, v in shares.items() if v[0] > 1]
            beyond += sum(v[1] > 1 for v in shares.values())
            log(f"{label} after {4 * (k + 1)} steps (largest gradient "
                f"{top}): largest share of the first limit {first}; of the "
                f"second {second}; leaves above the first limit (shares of "
                f"the first, the second) {above}")
            log(json.dumps({"model": label, "state": k + 1,
                            "shares": shares}))
        log(f"{label}: {n_states} states, {beyond} leaves beyond the second "
            f"limit")
        del model, plain, state, step
        torch.cuda.empty_cache()


def phase_multi_inst_cli(rows, tmp: str) -> dict:
    """Phase 14a: `python -m reconvat_tpu_torch.train_baseline_Multi_Inst`
    through its `Experiment` for one epoch at its defaults (fp32, VAT off,
    8 labeled clips of 640 frames, 10 steps) with TRAIN_CLI's overrides on
    phase 12b's corpus, against its bare step on the same batch size."""
    from reconvat_tpu_torch import train_baseline_Multi_Inst as multi_cli
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation

    rec = train_cli(dict(TRAIN_CLI, epoches=1, saving_freq=1,
                         root=os.path.join(tmp, "multi_inst")),
                    _corpus_env(tmp), multi_cli)
    _only_mel("the Multi_Inst CLI", rec["launches"])
    if rec["steps"] != 10 or rec["state"].step != 10:
        fail(f"the Multi_Inst CLI ran {rec['steps']} steps")
    for row in rows:
        row["launches_multi_inst_cli"] = rec["launches"][row["name"]]
    result = _result(rec["logdir"], "result_dict", RESULT_KEYS)
    copy = SemanticSegmentation(seed=42)
    copy.load_state_dict(rec["model"].state_dict(), strict=True)
    bare = bare_step_ms(copy, onset_batches(6)[0], None, "", vat=False,
                        steps=3, profile_steps=0)
    del copy
    torch.cuda.empty_cache()
    ms = step_ms(rec)
    log(f"phase 14a the Multi_Inst training CLI (fp32, VAT off, {B} labeled "
        f"x 640 frames, one epoch of 10 steps, {TRAIN_CLI} but epoches=1 "
        f"saving_freq=1): ms/step (loop "
        f"StepTimer, within the epoch) median {np.median(ms)} min "
        f"{min(ms)} max {max(ms)}, the bare step {bare}; mel launches per "
        f"step {rec['step_launches']['mel_power'] / rec['steps']}, in the "
        f"run {rec['launches']['mel_power']}; final evaluation "
        f"{rec['eval_ms'][0] / 2} ms/song (2 songs of {CORPUS_SECONDS} s); "
        f"save_checkpoint ms {rec['ckpt_ms']}; peak device GB "
        f"{rec['peak_gb']}; run wall {rec['wall_s']} s; note f1 "
        f"{np.mean(result['metric/note/f1'])}, frame f1 "
        f"{np.mean(result['metric/frame/f1'])}")
    return rec


def phase_segmentation_clis(rows, rec, tmp: str) -> None:
    """Phase 14b: on phase 14a's final weights, statistics and biases
    perturbed and the output layer sharpened (phase 10's `perturb_stats`,
    `sharpen_output`), saved as a `.pt`: the transcription CLI with
    `model_type=baseline_Multi_Inst` on `Application/Input` through its
    `Experiment` (one mel launch per clip) against `transcribe2midi`
    through the plain versions (`same_notes`); the evaluation CLI with
    `model_type=Segmentation` on phase 14a's `model-1` (one mel launch per
    song, the JAX package's keys), and the bucketed full-song
    posteriograms of the `.pt` through the kernels against the plain
    versions; and a SEG_SONG_SECONDS song streamed at halo SEG_HALO
    against its bucketed transcription at the seeded init (phase 10b's
    bounds, the JAX package's test's) and on the sharpened weights (those
    bounds + PROBE_FACTOR x the plain route's own gap there)."""
    import pickle

    from reconvat_tpu_torch import evaluate, evaluate_cli
    from reconvat_tpu_torch import transcribe_files as cli
    from reconvat_tpu_torch.data.datasets import MAPS, ApplicationDataset
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
    from reconvat_tpu_torch.train import checkpoint as ckpt

    counters = kernel_counters()

    def counts_reset():
        torch.cuda.synchronize()
        for f, c in counters.values():
            setattr(f, c, 0)

    def counts():
        return {k: getattr(f, c) for k, (f, c) in counters.items()}

    input_path = os.path.join(HERE, "Application", "Input")
    data = ApplicationDataset(input_path)
    kernels = SemanticSegmentation(seed=0)
    kernels.load_state_dict(rec["model"].state_dict(), strict=True)
    perturb_stats(kernels, seed=3)
    sharpen_output(kernels, [torch.from_numpy(d["audio"])[None].cuda()
                             for d in data], lin=kernels.inference_model)
    pt = os.path.join(tmp, "segmentation.pt")
    torch.save(kernels.state_dict(), pt)
    plain = SemanticSegmentation(seed=1)
    plain.load_reference_weights(pt)
    plain.use_kernels(False)

    counts_reset()
    t0 = time.perf_counter()
    written = cli.ex.run(cli.main, dict(
        device="cuda", model_type="baseline_Multi_Inst", weight_path=pt,
        input_path=input_path, output_path=os.path.join(tmp, "seg_cli")))
    cli_s = time.perf_counter() - t0
    launches = counts()
    _only_mel("the transcription CLI (baseline_Multi_Inst)", launches)
    if launches["mel_power"] != len(data):
        fail(f"the transcription CLI made {launches} for {len(data)} clips")
    for row in rows:
        row["launches_transcribe_cli_multi_inst"] = launches[row["name"]]
    names = [os.path.basename(w) for w, _ in written]
    if names != ["baseline_Multi_Inst-clip_amid",
                 "baseline_Multi_Inst-clip_bmid"]:
        fail(f"the CLI wrote {names}")
    ref = cli.transcribe2midi(data, plain, "baseline_Multi_Inst",
                              save_path=os.path.join(tmp, "seg_plain"),
                              bucket_frames=CLI_BUCKET)
    cli_read = [same_notes(f"phase 14b transcription CLI {path}", roll,
                           ref_roll)
                for (path, roll), (_, ref_roll) in zip(written, ref)]

    env = _corpus_env(tmp)
    saved_root = os.environ.get("RECONVAT_MAPS_ROOT")
    os.environ["RECONVAT_MAPS_ROOT"] = env["RECONVAT_MAPS_ROOT"]
    try:
        counts_reset()
        t0 = time.perf_counter()
        evaluate_cli.ex.run(evaluate_cli.main, dict(
            model_type="Segmentation",
            weight_file=ckpt.latest_checkpoint(rec["logdir"]),
            output_folder=os.path.join(tmp, "evaluated_segmentation")))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = counts()
        _only_mel("the evaluation CLI (Segmentation)", launches)
        for row in rows:
            row["launches_evaluate_cli_Segmentation"] = launches[row["name"]]
        with open(os.path.join(evaluate_cli.ex.current_run.config["logdir"],
                               "result_dict_infer"), "rb") as f:
            result = pickle.load(f)
        if sorted(result) != sorted(RESULT_KEYS):
            fail(f"evaluation CLI (Segmentation) result_dict keys "
                 f"{sorted(result)}")
    finally:
        if saved_root is None:
            os.environ.pop("RECONVAT_MAPS_ROOT", None)
        else:
            os.environ["RECONVAT_MAPS_ROOT"] = saved_root
    songs = MAPS(env["RECONVAT_MAPS_ROOT"], groups=["ENSTDkAm", "ENSTDkCl"],
                 sequence_length=None, verbose=False)
    runners = {k: evaluate.make_bucketed_runner(m)
               for k, m in (("kernels", kernels), ("plain", plain))}
    eval_read = []
    for song in songs:
        pk, lk, _ = runners["kernels"](song)
        pp, lp, _ = runners["plain"](song)
        eval_read.append(same_notes(
            "phase 14b evaluation", pk["frame"][0].float().cpu().numpy(),
            pp["frame"][0].float().cpu().numpy()))
        for k in lp:
            if not np.isclose(float(lk[k]), float(lp[k]), rtol=1e-4,
                              atol=1e-6):
                fail(f"phase 14b evaluation loss {k}: kernels "
                     f"{float(lk[k])}, plain {float(lp[k])}")
    del runners
    torch.cuda.empty_cache()

    # streaming is exact only where the halo covers the receptive field,
    # and Segmentation's exceeds any halo: held at the seeded init, as
    # the JAX package's test holds it (tests/test_streaming_transcribe.py:
    # 102-119); on the sharpened weights (x 16 at the logits), where the
    # gap is the model's own, the kernel route's within those bounds +
    # PROBE_FACTOR x the plain route's gap on the same weights
    _, audio = synth_song(np.random.RandomState(4), SEG_SONG_SECONDS)
    song = torch.from_numpy(audio.astype(np.float32) / 32768.0)[None].cuda()

    def stream_gaps(model):
        """(streamed roll, max |streamed - bucketed| inside and over the
        last STREAM_TAIL frames, streaming s, its mel launches)."""
        counts_reset()
        t0 = time.perf_counter()
        streamed = model.transcribe_streaming(song, STREAM_W, SEG_HALO)
        sec, launches = time.perf_counter() - t0, counts()["mel_power"]
        full = model.transcribe(song, CLI_BUCKET)["frame"].cpu()
        if streamed["frame"].shape != full.shape:
            fail(f"Segmentation streamed {tuple(streamed['frame'].shape)} "
                 f"against bucketed {tuple(full.shape)}")
        gap = (streamed["frame"] - full).abs()
        return (streamed, gap[:, :-STREAM_TAIL].max().item(),
                gap[:, -STREAM_TAIL:].max().item(), sec, launches)

    sharp_gaps = stream_gaps(kernels)[1:3]
    plain_gaps = stream_gaps(plain)[1:3]
    del plain
    for got, own, atol, where in zip(
            sharp_gaps, plain_gaps, (POST_ATOL, STREAM_TAIL_ATOL),
            ("inside", f"over the last {STREAM_TAIL} frames")):
        if got > atol + PROBE_FACTOR * own:
            fail(f"Segmentation streamed and bucketed posteriograms on the "
                 f"sharpened weights differ by {got} {where}, the plain "
                 f"route's by {own}")
    streamed, inner, tail, stream_s, stream_launches = stream_gaps(
        SemanticSegmentation(seed=0))
    if inner > POST_ATOL or tail > STREAM_TAIL_ATOL:
        fail(f"Segmentation streamed and bucketed posteriograms differ by "
             f"{inner} inside and {tail} over the last {STREAM_TAIL} frames")
    log(f"phase 14b Segmentation CLIs on the Multi_Inst CLI's weights: "
        f"the transcription CLI (sharpened) {cli_s * 1e3 / len(data)} "
        f"ms/clip (Experiment run), kernels vs plain (max abs diff, pitches "
        f"set aside, notes) {cli_read}; the evaluation CLI on model-1 "
        f"{eval_s} s (2 songs), note f1 "
        f"{np.mean(result['metric/note/f1'])}; sharpened, evaluated kernels "
        f"vs plain {eval_read}; streaming 1 x {SEG_SONG_SECONDS} s "
        f"(W={STREAM_W}, H={SEG_HALO}) at the seeded init {stream_s} s, "
        f"{stream_launches} mel launches, against bucketed transcribe max "
        f"abs diff {inner} inside (tol {POST_ATOL}), {tail} "
        f"over the last {STREAM_TAIL} frames (tol {STREAM_TAIL_ATOL}), share "
        f"of bins above 0.5 {(streamed['frame'] > 0.5).float().mean().item()}"
        f"; on the sharpened weights (inside, tail) kernels {sharp_gaps}, "
        f"plain {plain_gaps} (kernels within those tolerances + "
        f"{PROBE_FACTOR} x plain)")


def phase_segmentation_clis_of_run(rows, tmp: str) -> None:
    """Phases 14a and 14b: the Multi_Inst training CLI, then the
    transcription and evaluation CLIs and streaming on its weights."""
    phase_segmentation_clis(rows, phase_multi_inst_cli(rows, tmp), tmp)


def phase_attention_model_kernels(rows) -> None:
    """Phase 15: kernels 2, 3 and 4 (fp32) at the attention models' heads
    (AM_H heads of each Dh in AM_DH, W = 31) at B x 640 frames, with
    `rel` and with the zero `rel` of `position=False`: against their
    plain versions (ATTN_TOL, GRAD_TOL over max|ref|) and within
    TF32X3_TRUTH_FACTOR x the plain version's error against float64. Then
    each row's time and bound with `rel` (keys `*_h8d6`, `*_h8d96` of the
    kernels line)."""
    from reconvat_tpu_torch.ops import banded_attention_kernel as bak

    rng = torch.Generator(device="cuda").manual_seed(15)
    read = []
    for d in AM_DH:
        x32, rel = attention_draw(rng, B, 640, AM_H, d)
        x64 = tuple(x.double() for x in x32)
        errs, line = {}, [f"Dh={d}:"]
        for with_rel in (True, False):
            r32 = rel if with_rel else torch.zeros_like(rel)
            for name, fn, plain, labels in (
                    ("banded_attention_fwd", bak.banded_attention_fwd,
                     bak.banded_attention, ("out", "probs")),
                    ("banded_attention_bwd", bak.banded_attention_bwd,
                     bak.banded_attention_bwd_plain,
                     ("dq", "dk", "dv", "drel")),
                    ("banded_attention_bwd_partials",
                     bak.banded_attention_bwd_partials,
                     bak.banded_attention_bwd_partials_plain,
                     ("dq", "dk_part", "dv_part", "drel_part"))):
                def call(f, x):
                    r = r32.double() if x[0].dtype == torch.float64 else r32
                    return (f(*x[:3], r, W) if name == "banded_attention_fwd"
                            else f(*x[:3], r, x[3], W))

                k32, p32 = call(fn, x32), call(plain, x32)
                torch.cuda.synchronize()
                what = f"{name} at {B} x 640, H={AM_H}, Dh={d}, rel " \
                       f"{'drawn' if with_rel else 'zero'}"
                if name == "banded_attention_fwd":
                    err = max(check_close(f"{what} {label}", a, b, ATTN_TOL)
                              for label, a, b in zip(labels, k32, p32))
                else:
                    err = check_grads(what, k32, p32, labels)
                truth = nearer_float64(what, k32, p32, call(plain, x64),
                                       labels)
                errs[name] = max(errs.get(name, 0.0), err)
                line.append(f"{name} (rel {'drawn' if with_rel else 'zero'})"
                            f" err {err}, against float64 {truth}")
        time_rows_at(rows, x32, rel, errs, suffix=f"_h8d{d}",
                     dtypes=(torch.float32,))
        read.append(" ".join(line))
        del x32, x64
    timing = {row["name"]: {k: row[k] for k in row
                            if k.endswith(("_h8d6", "_h8d96"))}
              for row in rows if "ms_h8d6" in row}
    log(f"phase 15 attention kernels at the attention models' heads (H="
        f"{AM_H}, W={W}, {B} x 640) against their plain versions (fp32 "
        f"{ATTN_TOL}, {GRAD_TOL} over max|ref|, against float64 at most "
        f"{TF32X3_TRUTH_FACTOR} x the plain version's error): "
        f"{'; '.join(read)}; times: {timing}")


# phase 15a: (registry name, constructor keys, the VAT step or the
# supervised one); `StandaloneSelfAttention2D`'s 2-D attention is plain
# PyTorch, so its path launches the mel kernel alone
ATTENTION_MODELS = (
    ("VATSelfAttention1D", {}, True),
    ("VATCNNAttention1D", {"version": "a"}, True),
    ("VATCNNAttention1D", {"version": "b"}, True),
    ("VATCNNAttentionOnsetFrame", {}, True),
    ("OnsetsAndFramesSelfAttention", {}, False),
    ("SimpleOnsetFrame", {}, False),
    ("StandaloneSelfAttention1D", {}, False),
    ("StandaloneSelfAttention2D", {}, False),
    ("Reconstructor", {}, False))


def phase_attention_model_steps(rows) -> None:
    """Phase 15a: a train step of each attention model (fp32) at B x 640
    frames, the VAT models on B + B clips (their xi 1e-5, eps 1e-2), the
    others supervised on B: two steps with the counts reset just before and read
    just after (failing where a kernel of the path launched no time, or a
    kernel off it did), then one step through the kernels against the
    plain versions (phase 8's rule; the VAT models' losses also with VAT
    at xi 1e-2)."""
    from reconvat_tpu_torch.models import get_model
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    fp32_kernels = {"mel_power", "banded_attention_fwd",
                    "banded_attention_bwd", "banded_attention_bwd_partials"}
    batches = [onset_batches(seed) for seed in range(2)]
    read = []
    for name, kw, vat in ATTENTION_MODELS:
        model = get_model(name, seed=0, **kw)
        state = create_train_state(model)
        step = make_train_step(model, 1.0, vat=vat, use_unlabeled=vat)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step(state, *batches[0], gen)                    # warm-up
        n = 2
        ms, peak_gb, launches, losses = counted_steps(
            step, state, batches, gen, n, "fp32",
            path_kernels=({"mel_power"} if name == "StandaloneSelfAttention2D"
                          else fp32_kernels))
        key = name + kw.get("version", "")
        for row in rows:
            row[f"launches_{key}_step"] = launches[row["name"]] / n
        read.append(
            f"{key} ({'VAT, 8 + 8' if vat else 'supervised, 8'} x 640): {ms} "
            f"ms/step, peak {peak_gb} GB, launches per step "
            f"{ {k: v / n for k, v in launches.items() if v} }, last "
            f"losses { {k: v.item() for k, v in losses[-1].items()} }; "
            f"kernels vs plain: {compare_routes(model, *batches[0])}")
        del model, state, step
        torch.cuda.empty_cache()
    log(f"phase 15a the attention models' train steps (fp32): "
        f"{'; '.join(read)}")


# CQT and CFP (phase 16): their bins, the heads of Dh = n_bins that they
# give the flagship's attention (4), CFP's frames (T - 2 of the chain's
# T); each frontend on the card (fp32, TF32 off) against itself in float64
# on the CPU: the largest error over max|truth| at most FRONTEND_RTOL (the
# CPU tests' bound) and at most 2x the CPU's fp32 error + 1e-6
CQT_BINS, CFP_BINS = 176, 386
CFP_FRAMES = (SAMPLES - 1) // 512 - 1
FRONTEND_RTOL = 1e-4


def cfp_full_fft(fe, x):
    """CFP as the JAX package reads it, every FFT a full complex one (the
    second route that phase 16a times beside the module's real FFTs)."""
    import torch.nn.functional as F

    n = fe.N
    frames = F.pad(x, (n // 2, n // 2)).unfold(-1, n, fe.hop_length)
    tfr0 = torch.fft.fft(frames * fe.window, dim=-1).abs()[:, 1:-1]
    spec = (tfr0 / fe.h_norm).clamp_min(0.0) ** fe.g[0]
    ceps = torch.zeros_like(spec)
    for gc in range(1, len(fe.g)):
        if gc % 2 == 1:
            ceps = fe._nonlinear(torch.fft.fft(spec, dim=-1).real / n ** 0.5,
                                 fe.g[gc], fe.tc_idx)
        else:
            spec = fe._nonlinear(torch.fft.fft(ceps, dim=-1).real / n ** 0.5,
                                 fe.g[gc], fe.fc_idx)
    half = round(n / 2)
    tfr = spec[..., :half][..., :fe.high_freq_idx]
    cep = ceps[..., :half][..., :fe.high_quef_idx]
    return (tfr @ fe.freq2logfreq) * (cep @ fe.quef2logfreq)


def phase_frontends_cqt_cfp() -> None:
    """Phase 16a: the CQT and CFP frontends (`make_frontend`) on B clips of
    20.48 s, on the card against float64 on the CPU (FRONTEND_RTOL), and
    timed beside a second PyTorch route that must agree with them (CQT:
    `F.conv1d` against the chunked products; CFP: full complex FFTs
    against real ones), with their bounds: the bytes of the audio and the
    spec, and the operations the function needs (CQT: each bin's kernel
    taps, real and imaginary, per frame; CFP: three real FFTs per frame
    and the projections' nonzeros)."""
    import math

    from reconvat_tpu_torch.models.base import fp32_math
    from reconvat_tpu_torch.ops.spectrogram import make_frontend, reflect_pad

    audio = torch.tensor(np.random.RandomState(16).randn(B, SAMPLES - 1)
                         * 0.1, dtype=torch.float32)
    x = audio.cuda()
    read = []
    for spec, frames in (("CQT", 640), ("CFP", CFP_FRAMES)):
        fe, n_bins = make_frontend(spec)
        truth = fe.double()(audio.double())
        fe = fe.float()
        cpu32 = fe(audio)
        fe = fe.cuda()
        with fp32_math():
            got = fe(x)
            if spec == "CQT":
                second = lambda: fe.magnitude(fe.conv1d(     # noqa: E731
                    reflect_pad(x, fe.kernel_width // 2)))
            else:
                second = lambda: cfp_full_fft(fe, x)          # noqa: E731
            other = second()
            torch.cuda.synchronize()
            ms = time_ms(lambda: fe(x))
            second_ms = time_ms(second)
        if tuple(got.shape) != (B, frames, n_bins) or \
                not torch.isfinite(got).all():
            fail(f"{spec} frontend gave {tuple(got.shape)}, not finite "
                 f"({B}, {frames}, {n_bins})")
        top = truth.abs().max().item()
        err = (got.cpu().double() - truth).abs().max().item() / top
        err_cpu = (cpu32.double() - truth).abs().max().item() / top
        err_second = (other - got).abs().max().item() / top
        if not (err <= FRONTEND_RTOL and err <= 2 * err_cpu + 1e-6
                and err_second <= FRONTEND_RTOL):
            fail(f"{spec} frontend: error against float64 {err} (the CPU's "
                 f"fp32 {err_cpu}; at most {FRONTEND_RTOL} and 2x the "
                 f"CPU's + 1e-6), the second route {err_second} from it")
        if spec == "CQT":
            k, hop, n2 = fe.chunks.shape
            taps = float((fe.sqrt_lengths.double() ** 2).round().sum())
            flops = 2 * B * frames * 2 * taps
            dense = 2 * B * frames * k * hop * n2
            how = (f"{taps * 2:.0f} kernel taps of the {k * hop * n2} the "
                   f"dense products multiply ({dense / 1e9} GFLOP)")
        else:
            nnz = int((fe.freq2logfreq != 0).sum() + (fe.quef2logfreq
                                                       != 0).sum())
            fft = 2.5 * fe.N * math.log2(fe.N)
            flops = B * (frames + 2) * fft + B * frames * (2 * fft + 2 * nnz)
            how = f"3 real FFTs of {fe.N} per frame, {nnz} projection taps"
        nbytes = 4 * (x.numel() + got.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        read.append(f"{spec} ({n_bins} bins, {frames} frames): error "
                    f"against float64 {err} of max|truth| (the CPU's fp32 "
                    f"{err_cpu}), ms {ms}, second route ms {second_ms} "
                    f"(from the first {err_second}), bound_ms {bound_ms} "
                    f"({bound_by}; {flops / 1e9} GFLOP: {how}; "
                    f"{nbytes / 1e6} MB)")
        del fe, truth
    log(f"phase 16a the CQT and CFP frontends on {B} x {SAMPLES - 1} "
        f"samples (fp32, TF32 off; against float64 on the CPU): "
        f"{'; '.join(read)}")


def phase_attention_cqt_cfp(rows) -> None:
    """Phase 16b: the attention rows at the heads CQT and CFP give the
    flagship (H heads of Dh = n_bins): all six at CQT's Dh = CQT_BINS on B
    x 640, the forward's two at CFP's Dh = CFP_BINS on B x CFP_FRAMES (its
    backward takes Dh <= 256: no path trains at CFP), held by
    `hold_attention_at` (the bf16 forward also by phase 3d's rule), then
    timed into the kernels line's `*_cqt` and `*_cfp` keys."""
    rng = torch.Generator(device="cuda").manual_seed(16)
    read = []
    for d, t, names, suffix in (
            (CQT_BINS, 640, ATTENTION_ROWS, "_cqt"),
            (CFP_BINS, CFP_FRAMES, ("banded_attention_fwd",), "_cfp")):
        x32, rel, errs, line = hold_attention_at(rng, B, t, H, d, names,
                                                 fwd16_rule=True)
        time_rows_at(rows, x32, rel, errs, suffix=suffix, names=names)
        read.append(line)
        del x32
    timing = {row["name"]: {k: row[k] for k in row
                            if k.endswith(("_cqt", "_cfp"))
                            and not k.startswith("launches")}
              for row in rows}
    log(f"phase 16b attention kernels at CQT's and CFP's heads (H={H}, W={W}"
        f") against their plain versions (fp32 {ATTN_TOL}, {GRAD_TOL} over "
        f"max|ref|, against float64 at most {TF32X3_TRUTH_FACTOR} x the "
        f"plain version's error; bf16 by bf16_held, the forward also by "
        f"phase 3d's rule): {'; '.join(read)}; times: {timing}")


def phase_reconvat_cqt_step(rows) -> None:
    """Phase 16c: the flagship on CQT, an fp32 VAT train step with
    reconstruction at B + B x 640 frames: two steps with the counts reset
    just before and read just after (the path launches the three fp32
    attention kernels at Dh = CQT_BINS and no mel kernel), then one step
    through the kernels against the plain versions (phase 8's rule)."""
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    model = ReconVAT(seed=0, spec="CQT")
    if model.transcriber.lstm1.W_q.out_features != H * CQT_BINS:
        fail("the CQT model's attention is not 4 heads of its 176 bins")
    state = create_train_state(model)
    step = make_train_step(model, alpha=1.0, vat=True, use_unlabeled=True)
    batches = [train_batches(seed) for seed in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, *batches[0], gen)                        # warm-up
    n = 2
    ms, peak_gb, launches, losses = counted_steps(
        step, state, batches, gen, n, "fp32",
        path_kernels=set(ATTENTION_ROWS))
    for row in rows:
        row["launches_cqt_step"] = launches[row["name"]] / n
    log(f"phase 16c ReconVAT on CQT ({CQT_BINS} bins; VAT + "
        f"reconstruction, fp32, {B} + {B} x {SAMPLES} samples): {ms} "
        f"ms/step, peak {peak_gb} GB, launches per step "
        f"{ {k: v / n for k, v in launches.items() if v} }, last losses "
        f"{ {k: v.item() for k, v in losses[-1].items()} }; kernels vs "
        f"plain: {compare_routes(model, *batches[0])}")


def phase_serve_cfp(rows) -> None:
    """Phase 16d: the flagship on CFP serving through `serve.submit` at B x
    20.48 s (CFP_FRAMES frames), fp32 and bf16 with the same weights
    (statistics and biases perturbed, `perturb_stats`, and the output
    sharpened on two clips, `sharpen_output`, so that notes sit away from
    0.5): the main path of each with the counts reset just before and read just
    after (rows 2 or 2b at Dh = CFP_BINS and nothing else), kernels
    against plain versions (fp32: posteriograms within POST_ATOL; bf16 by
    `bf16_held`) and equal notes on every pitch away from 0.5 (no element
    within the larger of POST_ATOL and the routes' largest gap of it: no
    other element can fall on the other side), and ms/batch in turns
    (fp32, bf16, bf16, fp32)."""
    from reconvat_tpu_torch import serve
    from reconvat_tpu_torch.models.reconvat import ReconVAT

    rng = np.random.RandomState(160)
    batches = [(rng.randn(B, SAMPLES) * 3276.8).astype(np.int16)
               for _ in range(4)]
    audio = torch.tensor(batches[0], device="cuda").float() / 32768.0
    model = ReconVAT(seed=0, spec="CFP")
    perturb_stats(model, seed=16)
    sharpen_output(model, [audio[i:i + 1] for i in range(2)])
    model16 = ReconVAT(seed=0, spec="CFP", compute_dtype="bfloat16")
    model16.load_state_dict(model.state_dict(), strict=True)
    counters = kernel_counters()
    runs, launches = {}, {}
    for label, m in (("fp32", model), ("bf16", model16), ("bf16 again",
                                                          model16),
                     ("fp32 again", model)):
        serve_loop(serve, m, batches[:1])                  # warm-up
        torch.cuda.synchronize()
        for f, c in counters.values():
            setattr(f, c, 0)
        runs[label] = serve_loop(serve, m, batches)
        if label in ("fp32", "bf16"):
            launches[label] = {k: getattr(f, c)
                               for k, (f, c) in counters.items()
                               if getattr(f, c)}
    expect = {"fp32": {"banded_attention_fwd"},
              "bf16": {"banded_attention_fwd_bf16"}}
    for label, got in launches.items():
        if set(got) != expect[label]:
            fail(f"CFP {label} serving launched {got}, not only "
                 f"{expect[label]}")
    for row in rows:
        row["launches_cfp_serve"] = sum(
            got.get(row["name"], 0) for got in launches.values()) / len(
            batches)

    rolls = {}
    for kernels in (True, False):
        for m, dt in ((model, "fp32"), (model16, "bf16")):
            m.use_kernels(kernels)
            rolls[dt, kernels] = m.transcribe(audio)["frame"]
            m.use_kernels(True)
    roll = rolls["fp32", True]
    if tuple(roll.shape) != (B, CFP_FRAMES, 88) or \
            not torch.isfinite(roll).all():
        fail(f"CFP posteriogram {tuple(roll.shape)}, not finite ({B}, "
             f"{CFP_FRAMES}, 88)")
    diff16, tol16 = bf16_held("CFP serving, kernels vs plain posteriograms",
                              rolls["bf16", True], rolls["bf16", False],
                              roll, rolls["fp32", False])
    read = []
    for dt, tol in (("fp32", POST_ATOL), ("bf16", tol16)):
        diffs, aside, notes = [], 0, 0
        near = max(POST_ATOL, (rolls[dt, True] - rolls[dt, False]).abs()
                   .max().item())
        for i in range(B):
            d, s, k = same_notes(f"CFP {dt} serving clip {i}",
                                 rolls[dt, True][i].cpu().numpy(),
                                 rolls[dt, False][i].cpu().numpy(), tol,
                                 near)
            diffs.append(d)
            aside += s
            notes += k
        density = (rolls[dt, True] > 0.5).float().mean().item()
        if notes == 0:
            fail(f"CFP {dt} serving: no note to compare away from 0.5 "
                 f"({aside} pitches set aside)")
        read.append(f"{dt}: posteriograms kernels vs plain {max(diffs)} "
                    f"(tol {tol}), {notes} notes equal, {aside} pitches "
                    f"set aside (within {near} of 0.5), density {density}")
    log(f"phase 16d ReconVAT on CFP serving ({B} x {SAMPLES} int16, "
        f"{len(batches)} batches, depth 2; {CFP_BINS} bins, 4 heads of "
        f"{CFP_BINS}, {CFP_FRAMES} frames): launches {launches}; "
        f"{'; '.join(read)}; bf16 kernels vs plain {diff16} (tol {tol16}); "
        f"in turns: " + "; ".join(f"{k} {per_batch(r)}"
                                  for k, r in runs.items()))


def phase_cli_cqt_cfp(rows) -> None:
    """Phase 16e: the transcription CLI with spec=CQT and spec=CFP on
    `Application/Input` (random weights from its seed, the default bucket):
    one MIDI file per clip, a posteriogram of the clip's frames, one
    launch of row 2 per clip and no mel launch."""
    import shutil
    import tempfile

    from reconvat_tpu_torch import transcribe_files as cli
    from reconvat_tpu_torch.data.datasets import ApplicationDataset

    input_path = os.path.join(HERE, "Application", "Input")
    data = ApplicationDataset(input_path)
    frames = [(len(d["audio"]) - 1) // 512 + 1 for d in data.data]
    counters = kernel_counters()
    tmp = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    read = []
    try:
        for spec in ("CQT", "CFP"):
            torch.cuda.synchronize()
            for f, c in counters.values():
                setattr(f, c, 0)
            t0 = time.perf_counter()
            written = cli.ex.run(cli.main, dict(
                device="cuda", spec=spec, input_path=input_path,
                weight_path=os.path.join(tmp, "none.pt"),
                output_path=os.path.join(tmp, spec)))
            cli_s = time.perf_counter() - t0
            launches = {k: getattr(f, c) for k, (f, c) in counters.items()
                        if getattr(f, c)}
            if launches != {"banded_attention_fwd": len(data)}:
                fail(f"the CLI with spec={spec} launched {launches} for "
                     f"{len(data)} clips")
            names = sorted(os.listdir(os.path.join(tmp, spec)))
            if names != ["ReconVAT-clip_amid", "ReconVAT-clip_bmid"]:
                fail(f"the CLI with spec={spec} wrote {names}")
            shapes = [roll.shape for _, roll in written]
            if shapes != [(t, 88) for t in frames] or not all(
                    np.isfinite(r).all() for _, r in written):
                fail(f"the CLI with spec={spec} gave posteriograms "
                     f"{shapes} for clips of {frames} frames")
            for row in rows:
                row[f"launches_cli_{spec.lower()}"] = launches.get(
                    row["name"], 0) / len(data)
            read.append(f"{spec}: {cli_s * 1e3 / len(data)} ms/clip "
                        f"(Experiment run, model and audio included), "
                        f"launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 16e the transcription CLI on {len(data)} clips of "
        f"{frames} frames: {'; '.join(read)}")


# phases 17a-17c: streaming on CQT and CFP (a song of STREAM_SONG_SECONDS at
# phase 10b's windows), data-parallel steps over DP_RANKS ranks (each a
# process of this script, `--dp-rank`) and the training CLI at mesh_dp =
# DP_RANKS; the data-parallel step against one process by the JAX
# package's criterion (tests/test_parallel_families.py:102-117): losses
# within DP_LOSS_TOL, after one Adam step every parameter delta at most
# 2.05 x lr, the median under 1e-6, over 85 % under 1e-4
STREAM_SONG_SECONDS = 60.0
DP_RANKS, DP_STEPS = 2, 3
DP_LOSS_TOL = dict(rtol=3e-3, atol=1e-4)
DP_MODELS = ("flagship", "segmentation")
SP_RANKS = 2
SP_MODELS = ("flagship", "onset")
# phase 19: the families that take sequence parallelism besides (19a, 19b),
# Thickstun on a global batch of THICKSTUN_SP_B clips
SP_FAMILIES = ("segmentation", "thickstun")
THICKSTUN_SP_B = 4
# the models each `--dp-rank` stream entry streams (`sp_streams`), and
# each eval entry's model (`sp_eval`) with its outputs
STREAMS = {"stream": ("flagship", "onset"),
           "stream_segmentation": ("segmentation",)}
EVALS = {"eval": "flagship", "eval_segmentation": "segmentation"}
EVAL_OUTPUTS = {"flagship": ("reconstruction", "pianoroll", "pianoroll2",
                             "attention"),
                "segmentation": ("posteriogram",)}
# phase 18a's and 19a's eval forward at mesh_sp against one process, both
# fp32 with deterministic cuDNN: each output's largest gap over its
# largest magnitude. The ranks run each convolution on 320 + its halo
# frames where one process runs 640 + its pad, so cuDNN may sum in
# another order (~1e-7 a layer); a halo that is wrong or missing moves
# the frames beside the ranks' boundary by O(1).
SP_EVAL_RTOL = 1e-5
RESULTS: dict = {}      # figures an earlier phase leaves for a later one


def tone_song(seconds: float, seed: int):
    """(1, n) tones with a slow envelope and a little noise, on the card
    (phase 10b's song)."""
    n = int(seconds * 16000)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(n, device="cuda", dtype=torch.float64) / 16000
    phases = torch.rand(4, generator=g, device="cuda", dtype=torch.float64)
    sig = sum(0.2 * torch.sin(2 * np.pi * f * t + ph)
              for f, ph in zip((220.0, 440.0, 523.25, 660.0), phases))
    sig = sig * (0.5 + 0.5 * torch.sin(2 * np.pi * 0.3 * t))
    return (sig + 0.01 * torch.randn(n, generator=g, device="cuda",
                                     dtype=torch.float64)).float()[None]


def phase_streaming_cqt_cfp(rows) -> None:
    """Phase 17a: the flagship on CQT and on CFP (phase 16d's weights:
    statistics and biases perturbed, the output sharpened on two clips)
    streams a song of STREAM_SONG_SECONDS at phase 10b's windows (halo
    STREAM_H, past CQT's 32-frame reach): the main path at depth 3 with
    the counts reset just before and read just after (row 2 once per
    window group, nothing else: no mel kernel on these frontends; on CFP
    the wide kernel at Dh 386); depth 1 and 3 bit-identical under
    deterministic cuDNN; against the bucketed transcribe (bucket
    CLI_BUCKET) within POST_ATOL inside and STREAM_TAIL_ATOL over the last
    STREAM_TAIL frames; through the kernels against the plain versions
    within POST_ATOL; audio-s/s and peak GB."""
    from reconvat_tpu_torch.models.common import frames_in
    from reconvat_tpu_torch.models.reconvat import ReconVAT

    song = tone_song(STREAM_SONG_SECONDS, seed=17)
    t_true = frames_in(song.shape[1])
    n_windows = -(-t_true // STREAM_W)
    rng = np.random.RandomState(160)
    clips = torch.tensor(rng.randn(2, SAMPLES) * 0.1, dtype=torch.float32,
                         device="cuda")
    counters = kernel_counters()
    read = []
    for spec in ("CQT", "CFP"):
        model = ReconVAT(seed=0, spec=spec)
        perturb_stats(model, seed=16)
        sharpen_output(model, [clips[i:i + 1] for i in range(2)])

        def run(fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for f, c in counters.values():
                setattr(f, c, 0)
            t0 = time.perf_counter()
            roll = fn()["frame"].cpu()
            torch.cuda.synchronize()
            return (roll, time.perf_counter() - t0,
                    torch.cuda.max_memory_allocated() / 1e9,
                    {k: getattr(f, c) for k, (f, c) in counters.items()
                     if getattr(f, c)})

        def stream(**kw):
            return run(lambda: model.transcribe_streaming(
                song, STREAM_W, STREAM_H, **kw))

        stream()                                          # warm-up
        s3, sec3, gb3, launches = stream(pipeline_depth=3)    # main path
        if launches != {"banded_attention_fwd": n_windows}:
            fail(f"{spec} streaming of {n_windows} windows launched "
                 f"{launches}: one row 2 per window group and nothing else")
        if tuple(s3.shape) != (1, t_true, 88) or not torch.isfinite(
                s3).all():
            fail(f"{spec} streamed roll {tuple(s3.shape)} is not finite of "
                 f"(1, {t_true}, 88)")
        cudnn = torch.backends.cudnn
        cudnn.deterministic = True
        try:
            det3, det1 = (stream(pipeline_depth=d)[0] for d in (3, 1))
        finally:
            cudnn.deterministic = False
        if not torch.equal(det1, det3):
            fail(f"{spec} streaming at depth 1 and 3 differ by "
                 f"{(det1 - det3).abs().max().item()} with deterministic "
                 f"cuDNN")
        run(lambda: model.transcribe(song, CLI_BUCKET))        # warm-up
        full, sec_b, gb_b, _ = run(lambda: model.transcribe(song,
                                                            CLI_BUCKET))
        inner = (s3 - full)[:, :-STREAM_TAIL].abs().max().item()
        tail = (s3 - full)[:, -STREAM_TAIL:].abs().max().item()
        if inner > POST_ATOL or tail > STREAM_TAIL_ATOL:
            fail(f"{spec} streamed and bucketed rolls differ by {inner} "
                 f"inside and {tail} over the last {STREAM_TAIL} frames")
        model.use_kernels(False)
        plain = stream(pipeline_depth=3)
        model.use_kernels(True)
        if plain[3]:
            fail(f"{spec} plain streaming launched {plain[3]}")
        routes = (plain[0] - s3).abs().max().item()
        if routes > POST_ATOL:
            fail(f"{spec} streaming through the kernels and the plain "
                 f"versions differ by {routes}")
        for row in rows:
            row[f"launches_{spec.lower()}_stream"] = launches.get(
                row["name"], 0) / n_windows
        read.append(
            f"{spec}: against bucketed {inner} inside, {tail} over the "
            f"last {STREAM_TAIL} frames (tols {POST_ATOL}, "
            f"{STREAM_TAIL_ATOL}); kernels vs plain {routes}; density "
            f"{(s3 > 0.5).float().mean().item()}; launches {launches} for "
            f"{n_windows} window groups; audio-s/s streamed "
            f"{STREAM_SONG_SECONDS / sec3} (plain "
            f"{STREAM_SONG_SECONDS / plain[1]}), "
            f"bucketed {STREAM_SONG_SECONDS / sec_b}; peak GB streamed "
            f"{gb3}, bucketed {gb_b}")
        del model
        torch.cuda.empty_cache()
    log(f"phase 17a streaming on CQT and CFP (1 x {STREAM_SONG_SECONDS} s, "
        f"{t_true} frames, W={STREAM_W} H={STREAM_H}, {n_windows} windows, "
        f"fp32, sharpened weights; depth 1 and 3 identical under "
        f"deterministic cuDNN): {'; '.join(read)}")


def dp_model(name: str):
    """(model, VAT step's batches) of phase 17b's, 18's and 19's `name`:
    the flagship (reconstruction, fp32), Segmentation (dropout 0.4, fp32)
    or UNetOnset ('onset': reconstruction, fp32; `onset_batches`), seed 0,
    on the global batch of B + B clips of 20.48 s; or Thickstun (fp32,
    supervised: no unlabeled batch) on THICKSTUN_SP_B labeled clips."""
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
    from reconvat_tpu_torch.models.thickstun import Thickstun
    from reconvat_tpu_torch.models.unet_onset import UNetOnset

    if name == "onset":
        return (UNetOnset(seed=0, reconstruction=True),
                [onset_batches(seed) for seed in range(2)])
    if name == "thickstun":
        return Thickstun(seed=0), [
            ({k: v[:THICKSTUN_SP_B] for k, v in
              train_batches(seed)[0].items()}, None) for seed in range(2)]
    model = (ReconVAT(seed=0) if name == "flagship"
             else SemanticSegmentation(seed=0))
    return model, [train_batches(seed) for seed in range(2)]


def _union_ms(spans) -> float:
    """The length (ms) of the union of (start, end) spans in us."""
    total, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def step_split(run) -> dict:
    """How one call of `run` (a train step) splits, from torch.profiler
    (CPU and CUDA): its wall ms, the device's busy ms (the union of every
    kernel, copy and set on any stream) and within that the NCCL kernels'
    ms; the host's ms inside the `batchnorm_moments` spans (the train-mode
    BatchNorm moment all-reduces, `parallel.mesh.global_moments`), their
    number and the device's idle ms inside them; the host's ms inside the
    `gradient_all_reduce` span; the number of `halo_exchange` spans (the
    time halos of sequence parallelism, `parallel.mesh.time_halo`) and
    the host's ms inside them; and the device's idle ms elsewhere (the
    host's dispatch and every other wait; under sp the halos' too).""" 
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device, nccl, bn, grad, halo = [], [], [], [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CUDA"):
            device.append(span)
            if "nccl" in e.name.lower():
                nccl.append(span)
        elif e.name == "batchnorm_moments":
            bn.append(span)
        elif e.name == "gradient_all_reduce":
            grad.append(span)
        elif e.name == "halo_exchange":
            halo.append(span)
    busy = _union_ms(device)
    bn_ms = _union_ms(bn)
    # device busy inside the BatchNorm spans: the union of the device
    # spans clipped to each BatchNorm span
    inside = _union_ms([(max(a, c), min(b, d)) for a, b in bn
                        for c, d in device if c < b and d > a])
    return {"wall_ms": wall,
            # None: the profiler recorded no device time (not measured)
            "device_busy_ms": busy if device else None,
            "nccl_kernel_ms": _union_ms(nccl),
            "batchnorm_calls": len(bn), "batchnorm_host_ms": bn_ms,
            "device_idle_in_batchnorm_ms": bn_ms - inside,
            "gradient_ms": _union_ms(grad),
            "halo_calls": len(halo), "halo_host_ms": _union_ms(halo),
            "device_idle_elsewhere_ms": wall - busy - (bn_ms - inside)}


def dp_rank(rank: int, world: int, port: int, out: str, sp: int = 1,
            what=DP_MODELS) -> None:
    """One rank of phase 17b or 18 (`python3 chip_smoke.py --dp-rank rank
    world port out [sp [what]]`, `what` comma-separated): joins the
    process group (NCCL with a card per rank, else gloo) and lays a mesh
    of world / sp x sp ranks over it. For each model of `what` it takes
    DP_STEPS sharded VAT steps on its share of the global batches
    (`parallel.mesh.shard_batch`: its rows, and under sp its frames of
    the labels) with the counts set to 0 just before and read just after;
    after every step it holds its parameters and statistics bit-equal to
    rank 0's (broadcast). Saves the first step's losses and state (rank
    0), the ms/step of the later steps, the `gradient_all_reduce` span's
    ms of a profiled step, the step's split (`step_split`), peak GB and
    the launches to `out`. 'stream' in `what` streams phase 18c's song
    over the mesh (`sp_streams`), 'stream_segmentation' phase 19c's,
    'eval' and 'eval_segmentation' run phase 18a's and 19a's eval forward
    on it (`sp_eval`)."""
    import torch.distributed as dist

    from reconvat_tpu_torch.kernels import _build
    from reconvat_tpu_torch.parallel import distributed
    from reconvat_tpu_torch.parallel import mesh as pmesh
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    _build.build_all()
    device = distributed.initialize("localhost", port, world, rank,
                                    device="cuda")
    counters = kernel_counters()
    result = {"backend": dist.get_backend(), "device": str(device)}
    try:
        with pmesh.activate(pmesh.make_mesh(world // sp, sp,
                                            device=device)) as ctx:
            for name in what:
                if name in STREAMS:
                    result[name] = sp_streams(ctx, STREAMS[name])
                    continue
                if name in EVALS:
                    result[name] = sp_eval(ctx, EVALS[name])
                    continue
                model, batches = dp_model(name)
                batches = [tuple(b if b is None else pmesh.shard_batch(b, ctx)
                                 for b in pair) for pair in batches]
                state = create_train_state(model)
                step = make_train_step(model, 1.0, vat=True,
                                       use_unlabeled=True)
                gen = torch.Generator(device=device).manual_seed(0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for f, c in counters.values():
                    setattr(f, c, 0)
                times, equal = [], []
                for i in range(DP_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses = step(state, *batches[i % 2], gen)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    if i == 0:
                        first = {k: v.item() for k, v in losses.items()}
                        saved = {k: v.detach().cpu().clone() for k, v in
                                 model.state_dict().items()}
                    flat = torch.cat([v.detach().reshape(-1).double()
                                      for v in model.state_dict().values()])
                    ref = flat.clone()
                    dist.broadcast(ref, 0)
                    equal.append(bool(torch.equal(ref, flat)))
                launches = {k: getattr(f, c) / DP_STEPS
                            for k, (f, c) in counters.items()}
                split = step_split(lambda: step(state, *batches[0], gen))
                result[name] = {
                    "losses": first, "state": saved if rank == 0 else None,
                    "ms": times, "all_reduce_ms": split["gradient_ms"],
                    "split": split,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": launches, "equal": equal}
                del model, state, batches
                torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    torch.save(result, out)


def dp_deltas(got: dict, ref: dict, names) -> np.ndarray:
    return torch.cat([(got[k].float() - ref[k].float()).abs().reshape(-1)
                      for k in names]).numpy()


def one_process_step(name: str, probe=None):
    """(losses, state, parameter names, ms) of one process's first VAT
    step of `dp_model(name)` from the seeded init on the global batches;
    `probe` j moves both batches' audio by PROBE (`probed`)."""
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    model, batches = dp_model(name)
    batch_l, batch_ul = batches[0]
    if probe is not None:
        batch_l = probed(batch_l, 20 + 2 * probe)
        batch_ul = probed(batch_ul, 40 + 2 * probe)
    state = create_train_state(model)
    step = make_train_step(model, 1.0, vat=True, use_unlabeled=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step(state, batch_l, batch_ul, gen)
    torch.cuda.synchronize()
    out = ({k: v.item() for k, v in losses.items()},
           {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()},
           [n for n, _ in model.named_parameters()],
           (time.perf_counter() - t0) * 1e3)
    del model, state, batches
    torch.cuda.empty_cache()
    return out


def one_process_reference(name: str):
    """(`one_process_step(name)`, its `r_norm` entries' spread under
    R_NORM_PROBES audio probes), read once per run (RESULTS)."""
    key = f"one_process_{name}"
    if key not in RESULTS:
        ref = one_process_step(name)
        probes = ([one_process_step(name, j)[0] for j in range(R_NORM_PROBES)]
                  if any("_r_norm_" in k for k in ref[0]) else [])
        RESULTS[key] = (ref, {k: max(abs(p[k] - v) for p in probes)
                              for k, v in ref[0].items() if "_r_norm_" in k})
    return RESULTS[key]


def run_ranks(label: str, visible: str, world: int, args=()) -> list:
    """Each rank's saved result of `world` `--dp-rank` processes of this
    script (extra arguments `args`) on the cards `visible`, started
    together; fails with a rank's output if one failed or outlasted 900
    s."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"),
         "--dp-rank", str(r), str(world), str(port),
         os.path.join(out, f"rank{r}.pt"), *args], env=env, cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            fail(f"rank {r} ({label}) exited with {p.returncode}: "
                 f"{text[-3000:]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"))
            for r in range(world)]


def hold_sharded_step(what: str, name: str, ranks: list, misses: list):
    """Phase 17b's, 18's and 19's criterion on `ranks`' results for `name`
    against one process (`one_process_reference`): every rank's
    parameters and statistics bit-equal to rank 0's after each step; each
    rank launches the path's rows (the flagship's and UNetOnset's rows
    1-4, Segmentation's and Thickstun's row 1) and no other; losses
    within DP_LOSS_TOL (the `r_norm` entries + PROBE_FACTOR x the one
    process's spread);
    parameter deltas at most 2.05 x lr, the median under 1e-6, over 85 %
    under 1e-4. Failures of the comparison with one process go to
    `misses`; returns (the largest relative loss gap, the deltas)."""
    (ref_losses, ref_state, params, _), spread = one_process_reference(name)
    got = ranks[0][name]
    expect = ({"mel_power"} | set(ATTENTION_ROWS) if name in SP_MODELS
              else {"mel_power"})
    for r, res in enumerate(ranks):
        mine = res[name]
        if not all(mine["equal"]):
            fail(f"{what} {name}: rank {r}'s parameters left rank 0's "
                 f"after the steps {mine['equal']}")
        ran = {k for k, n in mine["launches"].items() if n}
        if ran != expect:
            fail(f"{what} {name}: rank {r} launched {mine['launches']}, "
                 f"not {sorted(expect)}")
    for k, v in ref_losses.items():
        tol = (DP_LOSS_TOL["atol"] + DP_LOSS_TOL["rtol"] * abs(v)
               + PROBE_FACTOR * spread.get(k, 0.0))
        if not abs(got["losses"][k] - v) <= tol:
            misses.append(f"{what} {name}: {k} {got['losses'][k]} on "
                          f"{len(ranks)} ranks, {v} in one process "
                          f"(tolerance {tol})")
    d = dp_deltas(got["state"], ref_state, params)
    lr = 1e-3
    if not (d.max() <= 2.05 * lr and np.median(d) < 1e-6
            and np.mean(d < 1e-4) > 0.85):
        misses.append(f"{what} {name}: parameter deltas against one "
                      f"process max {d.max()} median {np.median(d)} share "
                      f"under 1e-4 {np.mean(d < 1e-4)}")
    return max(abs(got["losses"][k] - v) / max(abs(v), 1e-12)
               for k, v in ref_losses.items()), d


def sharded_read(name: str, ranks: list, gap: float, d) -> str:
    """What phases 17b, 18 and 19 print of `name`'s sharded steps."""
    _, spread = one_process_reference(name)
    launches = [{k: v for k, v in res[name]["launches"].items() if v}
                for res in ranks]
    return (f"ms/step per rank {[res[name]['ms'] for res in ranks]} (one "
            f"process, first step {one_process_reference(name)[0][3]}); "
            f"gradient all-reduce ms "
            f"{[res[name]['all_reduce_ms'] for res in ranks]}; peak GB per "
            f"rank {[res[name]['peak_gb'] for res in ranks]}; launches per "
            f"step per rank {launches}; losses max rel gap {gap}; deltas "
            f"max {d.max()} median "
            f"{np.median(d)} share under 1e-4 {np.mean(d < 1e-4)}; the one "
            f"process's r_norm spread under {R_NORM_PROBES} probes {spread}; "
            f"ranks bit-equal after each of {DP_STEPS} steps; a step's split "
            f"per rank {[res[name]['split'] for res in ranks]}")


def phase_data_parallel_steps(rows) -> None:
    """Phase 17b: the fp32 flagship VAT step and a Segmentation VAT step
    (dropout masks and train-mode BatchNorm over the global batch) at B +
    B x 640 frames, on DP_RANKS ranks of B/DP_RANKS + B/DP_RANKS clips
    (`dp_rank`, one process each; they share the card over gloo, and a
    machine with as many cards runs them again over NCCL, a card each),
    against one process taking the same first step from the same state on
    the same global batches (`hold_sharded_step`: losses and parameters
    by the JAX package's criterion, DP_LOSS_TOL, deltas against 2.05 x
    lr; the VAT `r_norm` entries, means of a direction that rounding sets
    at xi 1e-6, within DP_LOSS_TOL + PROBE_FACTOR x the one process's
    spread under R_NORM_PROBES audio probes, as phase 14 holds them; the
    ranks' parameters and statistics bit-equal after every step; each
    rank's launches: the flagship rows 1-4 and no bf16 row, Segmentation
    row 1 alone), ms/step per rank, the gradient all-reduce's ms and peak
    GB per rank, and how a step splits on each rank (`step_split`) beside
    one process's step on rank 0's rows alone."""
    from reconvat_tpu_torch.train.state import (create_train_state,
                                                make_train_step)

    def half_steps(name):
        """ms of DP_STEPS one-process steps on rank 0's rows alone (B/2 +
        B/2, no mesh: what a rank's own work takes) and the split of one
        more (`step_split`)."""
        model, batches = dp_model(name)
        half = [{k: v[:B // DP_RANKS] for k, v in b.items()}
                for b in batches[0]]
        state = create_train_state(model)
        step = make_train_step(model, 1.0, vat=True, use_unlabeled=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        times = []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, *half, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        split = step_split(lambda: step(state, *half, gen))
        del model, state, batches, half
        torch.cuda.empty_cache()
        return times, split

    alone = {}
    for name in DP_MODELS:
        one_process_reference(name)
        alone[name] = half_steps(name)
    layouts = [("gloo, ranks share a card", "0")]
    if torch.cuda.device_count() >= DP_RANKS:
        layouts.append(("NCCL, a card per rank", ",".join(
            str(i) for i in range(DP_RANKS))))
    read, misses = [], []
    for label, visible in layouts:
        ranks = run_ranks(f"phase 17b, {label}", visible, DP_RANKS)
        for name in DP_MODELS:
            gap, d = hold_sharded_step(f"phase 17b ({label})", name, ranks,
                                       misses)
            if label.startswith("gloo"):
                for row in rows:
                    row["launches_dp_step"] = max(
                        row.get("launches_dp_step", 0),
                        ranks[0][name]["launches"][row["name"]])
            read.append(
                f"{name} ({label}; {ranks[0]['backend']}): "
                f"{sharded_read(name, ranks, gap, d)}; one process on rank "
                f"0's rows alone ({B // DP_RANKS} + {B // DP_RANKS}, no "
                f"mesh) ms/step {alone[name][0]}, split {alone[name][1]}")
    log(f"phase 17b data-parallel VAT steps (fp32, {DP_RANKS} ranks of "
        f"{B // DP_RANKS} + {B // DP_RANKS} x 640 against one process of "
        f"{B} + {B}): {'; '.join(read)}")
    if misses:
        fail(f"phase 17b: {misses}")


def sp_streams(ctx=None, names=STREAMS["stream"]) -> dict:
    """Phases 18c and 19c: the flagship and UNetOnset, or Segmentation
    (`names`; seed 0, fp32, random weights) stream a song of
    STREAM_SONG_SECONDS (`tone_song`) at their default windows (W 640, H
    128; Segmentation's H 256) with deterministic cuDNN, over the ranks of
    mesh `ctx` (`transcribe_streaming(mesh_ctx=ctx)`) or on one device:
    {model: (the frame roll, the onset roll or None, seconds, the
    launches)}."""
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
    from reconvat_tpu_torch.models.unet_onset import UNetOnset
    from reconvat_tpu_torch.parallel import distributed

    makers = {"flagship": ReconVAT, "onset": UNetOnset,
              "segmentation": SemanticSegmentation}
    counters = kernel_counters()
    cudnn = torch.backends.cudnn
    song = tone_song(STREAM_SONG_SECONDS, seed=18)
    out = {}
    cudnn.deterministic = True
    try:
        for name in names:
            model = makers[name](seed=0)
            model.transcribe_streaming(song[:, :SAMPLES], mesh_ctx=ctx)
            for f, c in counters.values():
                setattr(f, c, 0)
            torch.cuda.synchronize()
            distributed.sync()          # the ranks start the clock together
            t0 = time.perf_counter()
            rolls = model.transcribe_streaming(song, mesh_ctx=ctx)
            torch.cuda.synchronize()
            out[name] = (rolls["frame"], rolls["onset"]
                         if name == "onset" else None,
                         time.perf_counter() - t0,
                         {k: getattr(f, c) for k, (f, c) in
                          counters.items() if getattr(f, c)})
            del model
    finally:
        cudnn.deterministic = False
    return out


def sp_eval(ctx=None, name: str = "flagship") -> dict:
    """Phase 18a's and 19a's forward: the flagship (reconstruction) or
    Segmentation (`name`; seed 0, fp32, random weights) in eval mode on
    the labeled audio of `train_batches(0)`, with deterministic cuDNN;
    under mesh `ctx` on this rank's rows, inside a sharded step (so on its
    frames of the spec): {output (EVAL_OUTPUTS, the spec): this rank's
    share of it, on the CPU}."""
    from reconvat_tpu_torch.models.base import fp32_math
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
    from reconvat_tpu_torch.parallel import mesh as pmesh

    model = (ReconVAT(seed=0) if name == "flagship"
             else SemanticSegmentation(seed=0)).eval()
    audio = train_batches(0)[0]["audio"]
    if ctx is not None:
        audio = pmesh.shard_batch({"audio": audio}, ctx)["audio"]
    cudnn = torch.backends.cudnn
    cudnn.deterministic = True
    try:
        with torch.no_grad(), fp32_math(), pmesh.sharded_step(ctx):
            spec = model.make_spec(audio)
            out = model(spec)
    finally:
        cudnn.deterministic = False
    out = out if isinstance(out, tuple) else (out,)
    return {k: v.float().cpu()
            for k, v in zip(EVAL_OUTPUTS[name] + ("spec",), out + (spec,))}


def hold_sp_eval(phase: str, label: str, ranks: list, key: str, one: dict,
                 dp: int, misses: list) -> dict:
    """Each output of the ranks' `sp_eval` (`ranks[r][key]`), their
    frames put together, against one process's (`one`): the largest gap
    over the largest magnitude by output; one past SP_EVAL_RTOL goes to
    `misses`."""
    gaps = {}
    for k, v in one.items():
        whole = torch.cat([torch.cat(
            [ranks[i * SP_RANKS + j][key][k] for j in range(SP_RANKS)],
            dim=1) for i in range(dp)])
        gaps[k] = ((whole - v).abs().max().item()
                   / max(v.abs().max().item(), 1e-30)
                   if whole.shape == v.shape else float("inf"))
        if not gaps[k] <= SP_EVAL_RTOL:
            misses.append(f"{phase} eval forward ({label}): {k} "
                          f"{tuple(whole.shape)} on the ranks, "
                          f"{tuple(v.shape)} in one process, largest gap "
                          f"{gaps[k]} of its largest magnitude (tolerance "
                          f"{SP_EVAL_RTOL})")
    return gaps


def phase_sequence_parallel(rows) -> None:
    """Phase 18a-18c, sequence parallelism (`mesh_sp`, the time axis over
    ranks) against one process on the card. 18a: the flagship's eval-mode
    forward with reconstruction on the B x 640 labeled batch at
    mesh_sp=SP_RANKS (`sp_eval`), every output (the spec, the
    reconstruction, both rolls, the attention) within SP_EVAL_RTOL of one
    process's, which holds every frame beside the ranks' boundaries; and
    the flagship's fp32 VAT
    step with reconstruction on SP_RANKS ranks of mesh_sp=SP_RANKS, each
    holding B + B clips x 640 / SP_RANKS frames of the global B + B x
    640 (`dp_rank` processes sharing the card over gloo; over NCCL a card
    each on a machine with as many cards, and on four cards also at
    mesh_dp=2 x mesh_sp=2), held by phase 17b's criterion
    (`hold_sharded_step`: DP_LOSS_TOL, deltas within 2.05 x lr, `r_norm`
    with the spread, the ranks bit-equal after every step, each rank
    launching rows 1-4 and no bf16 row); ms/step, peak GB, launches and
    the `halo_exchange` spans' count and host ms per rank (`step_split`).
    18b: UNetOnset's fp32 VAT step at mesh_sp=SP_RANKS, held the same
    way. 18c: a 60-s song streamed by the flagship and by UNetOnset over
    the ranks (`sp_streams`) against one device's stream, within 1e-6
    (deterministic cuDNN; each window is the same computation)."""
    for name in SP_MODELS:
        one_process_reference(name)
    one = sp_streams()
    one_eval = sp_eval()
    layouts = [("gloo, ranks share a card", "0", 1)]
    if torch.cuda.device_count() >= SP_RANKS:
        layouts.append(("NCCL, a card per rank", ",".join(
            str(i) for i in range(SP_RANKS)), 1))
    if torch.cuda.device_count() >= 2 * SP_RANKS:
        layouts.append(("NCCL, mesh_dp=2 x mesh_sp=2", ",".join(
            str(i) for i in range(2 * SP_RANKS)), 2))
    read, misses = [], []
    for label, visible, dp in layouts:
        what = ("eval",) + (SP_MODELS + ("stream",) if dp == 1
                            else ("flagship",))
        ranks = run_ranks(f"phase 18, {label}", visible, dp * SP_RANKS,
                          (str(SP_RANKS), ",".join(what)))
        gaps = hold_sp_eval("18a", label, ranks, "eval", one_eval, dp, misses)
        read.append(f"18a eval forward ({label}, dp {dp} x sp {SP_RANKS}): "
                    f"largest gap over largest magnitude {gaps}")
        for name in what:
            if name in ("stream", "eval"):
                continue
            gap, d = hold_sharded_step(f"phase 18 ({label})", name, ranks,
                                       misses)
            halos = [res[name]["split"]["halo_calls"] for res in ranks]
            if min(halos) == 0:
                fail(f"phase 18 {name} ({label}): a rank ran no halo "
                     f"exchange {halos}")
            if label.startswith("gloo"):
                for row in rows:
                    row[f"launches_sp_{name}_step"] = \
                        ranks[0][name]["launches"][row["name"]]
            read.append(f"18{'ab'[SP_MODELS.index(name)]} {name} ({label}; "
                        f"{ranks[0]['backend']}, dp {dp} x sp {SP_RANKS}): "
                        f"{sharded_read(name, ranks, gap, d)}")
        if "stream" not in what:
            continue
        for name, (frame, onset, sec, _) in one.items():
            gaps = []
            for r, res in enumerate(ranks):
                got = res["stream"][name]
                for a, b in ((got[0], frame), (got[1], onset)):
                    if b is None:
                        continue
                    if a.shape != b.shape or not torch.isfinite(a).all():
                        fail(f"phase 18c {name} ({label}): rank {r}'s roll "
                             f"{tuple(a.shape)}, one device's "
                             f"{tuple(b.shape)}")
                    gaps.append((a - b).abs().max().item())
            if max(gaps) > 1e-6:
                misses.append(f"18c {name} ({label}): streamed over "
                              f"{SP_RANKS} ranks {max(gaps)} from one "
                              f"device's roll")
            audio_s = STREAM_SONG_SECONDS
            read.append(
                f"18c {name} ({label}): {audio_s}-s song, {frame.shape[1]} "
                f"frames, largest gap to one device's roll {max(gaps)}; "
                f"audio-s/s per rank "
                f"{[audio_s / res['stream'][name][2] for res in ranks]} "
                f"(one device {audio_s / sec}); launches per rank "
                f"{[res['stream'][name][3] for res in ranks]} (one device "
                f"{one[name][3]})")
    log(f"phase 18 sequence-parallel steps (fp32, {SP_RANKS} ranks of {B} "
        f"+ {B} x {640 // SP_RANKS} frames against one process of {B} + "
        f"{B} x 640) and streaming: {'; '.join(read)}")
    if misses:
        fail(f"phase 18: {misses}")


def phase_sequence_parallel_families(rows) -> None:
    """Phase 19a-19c, sequence parallelism in Segmentation and Thickstun
    (their TF-SAME pads, transposed convolutions, 17 x 17 windows and
    25-frame kernel take the other rank's frames) against one process on
    the card. 19a: Segmentation's eval-mode forward on the B x 640
    labeled batch at mesh_sp=SP_RANKS (`sp_eval`), its posteriogram and
    spec within SP_EVAL_RTOL of one process's, which holds every frame
    beside the ranks' boundaries (the interior TF-SAME pads, the
    transposed convolutions' front frames, the attention's windows); and
    its fp32 VAT step (dropout 0.4) on SP_RANKS ranks of
    mesh_sp=SP_RANKS, each holding B + B clips x 640 / SP_RANKS frames of
    the global B + B x 640; 19b: Thickstun's fp32 step on
    THICKSTUN_SP_B x 640 global; both held by phase 17b's criterion
    (`hold_sharded_step`: DP_LOSS_TOL, deltas within 2.05 x lr, the ranks
    bit-equal after every step, each rank launching row 1 and nothing
    else: 2 a Segmentation step, 1 a Thickstun step), with ms/step, peak
    GB, launches and the `halo_exchange` and `batchnorm_moments` spans'
    counts and host ms per rank (`step_split`). 19c: a 60-s song streamed
    by Segmentation over the ranks against one device's stream, within
    1e-6 (deterministic cuDNN). The ranks share the card over gloo; over
    NCCL a card each on a machine with as many cards, and on four 19a
    also at mesh_dp=2 x mesh_sp=2."""
    for name in SP_FAMILIES:
        one_process_reference(name)
    one = sp_streams(names=STREAMS["stream_segmentation"])
    one_eval = sp_eval(name="segmentation")
    layouts = [("gloo, ranks share a card", "0", 1)]
    if torch.cuda.device_count() >= SP_RANKS:
        layouts.append(("NCCL, a card per rank", ",".join(
            str(i) for i in range(SP_RANKS)), 1))
    if torch.cuda.device_count() >= 2 * SP_RANKS:
        layouts.append(("NCCL, mesh_dp=2 x mesh_sp=2", ",".join(
            str(i) for i in range(2 * SP_RANKS)), 2))
    read, misses = [], []
    for label, visible, dp in layouts:
        what = ("eval_segmentation",) + (
            SP_FAMILIES + ("stream_segmentation",) if dp == 1
            else ("segmentation",))
        ranks = run_ranks(f"phase 19, {label}", visible, dp * SP_RANKS,
                          (str(SP_RANKS), ",".join(what)))
        gaps = hold_sp_eval("19a", label, ranks, "eval_segmentation",
                            one_eval, dp, misses)
        read.append(f"19a segmentation eval forward ({label}, dp {dp} x sp "
                    f"{SP_RANKS}): largest gap over largest magnitude {gaps}")
        for name in what:
            if name in STREAMS or name in EVALS:
                continue
            gap, d = hold_sharded_step(f"phase 19 ({label})", name, ranks,
                                       misses)
            halos = [res[name]["split"]["halo_calls"] for res in ranks]
            if min(halos) == 0:
                fail(f"phase 19 {name} ({label}): a rank ran no halo "
                     f"exchange {halos}")
            if label.startswith("gloo"):
                for row in rows:
                    row[f"launches_sp_{name}_step"] = \
                        ranks[0][name]["launches"][row["name"]]
            read.append(f"19{'ab'[SP_FAMILIES.index(name)]} {name} ({label}; "
                        f"{ranks[0]['backend']}, dp {dp} x sp {SP_RANKS}): "
                        f"{sharded_read(name, ranks, gap, d)}")
        if "stream_segmentation" not in what:
            continue
        frame, _, sec, launches = one["segmentation"]
        streams = [res["stream_segmentation"]["segmentation"]
                   for res in ranks]
        gaps = []
        for r, st in enumerate(streams):
            got = st[0]
            if got.shape != frame.shape or not torch.isfinite(got).all():
                fail(f"phase 19c ({label}): rank {r}'s roll "
                     f"{tuple(got.shape)}, one device's {tuple(frame.shape)}")
            gaps.append((got - frame).abs().max().item())
        if max(gaps) > 1e-6:
            misses.append(f"19c ({label}): streamed over {SP_RANKS} ranks "
                          f"{max(gaps)} from one device's roll")
        read.append(
            f"19c segmentation ({label}): {STREAM_SONG_SECONDS}-s song, "
            f"{frame.shape[1]} frames, largest gap to one device's roll "
            f"{max(gaps)}; audio-s/s per rank "
            f"{[STREAM_SONG_SECONDS / st[2] for st in streams]} (one device "
            f"{STREAM_SONG_SECONDS / sec}); launches per rank "
            f"{[st[3] for st in streams]} (one device {launches})")
    log(f"phase 19 sequence-parallel Segmentation and Thickstun (fp32, "
        f"{SP_RANKS} ranks of {B} + {B} and {THICKSTUN_SP_B} x "
        f"{640 // SP_RANKS} frames against one process of {B} + {B} and "
        f"{THICKSTUN_SP_B} x 640) and Segmentation streaming: "
        f"{'; '.join(read)}")
    if misses:
        fail(f"phase 19: {misses}")


def phase_sharded_cli(rows, tmp: str, phase: str, mesh: dict,
                      cli=None, resume: bool = True) -> None:
    """Phase 17c (`mesh` {mesh_dp: DP_RANKS, train_batch_size: DP_RANKS,
    supersmall: False}: the batch must divide over the ranks, so the four
    labeled songs of phase 11's corpus) or 18d (`mesh` {mesh_sp:
    SP_RANKS}: each crop's 640 frames over the ranks): `python -m
    reconvat_tpu_torch.train_UNet_VAT with <mesh>` (this process rank 0,
    the CLI starts the others) at its defaults otherwise (bf16, VAT), one
    epoch with one checkpoint: rank 0's launches (rows 1, 2b, 3b, 4b),
    only rank 0's artifacts in the run directory, ms/step against phase
    11's one-process figure; then a resume on the same mesh restoring
    every tensor bit-equal. 19d: the same of `cli` (`train_baseline_
    Multi_Inst` or `train_baseline_Thickstun`, fp32 at their defaults, on
    phase 12b's corpus of B labeled songs), which launches row 1 alone;
    with `resume` False, no resume."""
    import datetime

    from reconvat_tpu_torch.parallel import distributed
    from reconvat_tpu_torch.train import checkpoint as ckpt

    flagship = cli is None
    if flagship:
        corpus = os.path.join(tmp, "corpus")
        env = {"RECONVAT_MAPS_ROOT": os.path.join(corpus, "MAPS"),
               "RECONVAT_MAESTRO_ROOT": os.path.join(corpus, "MAESTRO")}
    else:
        env = _corpus_env(tmp)
    cli_name = ("train_UNet_VAT" if flagship
                else cli.__name__.rsplit(".", 1)[1])
    args = dict(TRAIN_CLI, epoches=1, saving_freq=1, **mesh)
    world = int(mesh.get("mesh_dp", 1)) * int(mesh.get("mesh_sp", 1))
    root = os.path.join(tmp, f"runs_{phase}_{cli_name}")
    backend = distributed.choose_backend("cuda", world)
    # a rank that waits longer than this at a collective fails the phase
    # (and rank 0 then stops the others) inside the script's time limit
    timeout = distributed.TIMEOUT
    distributed.TIMEOUT = datetime.timedelta(minutes=5)
    try:
        rec = train_cli(dict(args, root=root), env, cli)
        resumed = resume and train_cli(dict(
            args, root=os.path.join(tmp, f"resumed_{phase}_{cli_name}"),
            epoches=0, resume_iteration="latest", trained_dir=rec["logdir"]),
            env, cli)
    finally:
        distributed.TIMEOUT = timeout
    for name, n in rec["launches"].items():
        if (n > 0) != (name == "mel_power"
                       or flagship and name.endswith("_bf16")):
            fail(f"phase {phase}, the sharded {cli_name} launched {name} "
                 f"{n} times on rank 0")
    logdir, steps = rec["logdir"], rec["steps"]
    names = sorted(os.listdir(logdir))
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    if os.listdir(root) != [os.path.basename(logdir)] or len(events) != 1 \
            or not {"model-1", "result_dict", "MIDI_results",
                    "config.json"} <= set(names):
        fail(f"phase {phase}: the sharded CLI wrote {os.listdir(root)}: "
             f"{names}")
    saved = ckpt.load_state(os.path.join(logdir, "model-1"))
    n_tensors = 0
    for k, v in (resumed["model"].state_dict().items() if resume else ()):
        if not torch.equal(v.cpu(), saved["model"][k]):
            fail(f"phase {phase} resume: tensor {k} differs from the saved")
        n_tensors += 1
    opt = resumed and resumed["state"].optimizer.state_dict()["state"]
    for i, slots in (saved["optimizer"]["state"].items() if resume else ()):
        for name, v in slots.items():
            if not torch.equal(opt[i][name].cpu(), v):
                fail(f"phase {phase} resume: optimizer state {i}.{name}")
            n_tensors += 1
    key = ("launches_dp_cli" if "mesh_dp" in mesh else "launches_sp_cli"
           + ("" if flagship else f"_{cli_name}"))
    for row in rows:
        row[key] = rec["step_launches"][row["name"]] / steps
    # a full-epoch sweep takes one step per labeled song
    ms = step_ms(rec, iteration=min(steps, 10))
    log(f"phase {phase} {cli_name} at {mesh} "
        f"({'bf16, VAT' if flagship else 'fp32, its defaults'}, "
        f"{world} ranks on {backend}, "
        f"{'a card each' if backend == 'nccl' else 'sharing the card'}, "
        f"{steps} steps): ms/step "
        f"(rank 0's StepTimer) median {np.median(ms)} min {min(ms)} max "
        f"{max(ms)}"
        + (f", against phase 11's one process (1 + 8) median "
           f"{RESULTS.get('phase11_ms')}" if flagship else "")
        + f"; rank 0's launches per step "
        f"{ {k: n / steps for k, n in rec['step_launches'].items() if n} }; "
        f"rank 0's peak GB {rec['peak_gb']}; run wall {rec['wall_s']} s; "
        f"artifacts (rank 0 alone) {names}; "
        + (f"resumed on the same mesh with {n_tensors} tensors bit-equal to "
           f"the saved ones" if resume else "no resume"))


DP_CLI = {"mesh_dp": DP_RANKS, "train_batch_size": DP_RANKS,
          "supersmall": False}
SP_CLI = {"mesh_sp": SP_RANKS}


def phase_sharded_family_clis(rows, tmp: str) -> None:
    """Phase 19d: `train_baseline_Multi_Inst` and `train_baseline_
    Thickstun` at mesh_sp=SP_RANKS (`phase_sharded_cli`), Multi_Inst with
    a resume (its 943 tensors; Thickstun's resume runs the same driver
    code on 20, and is left out to keep the phase short)."""
    from reconvat_tpu_torch import train_baseline_Multi_Inst as multi_cli
    from reconvat_tpu_torch import train_baseline_Thickstun as thickstun_cli

    phase_sharded_cli(rows, tmp, "19d", SP_CLI, multi_cli)
    phase_sharded_cli(rows, tmp, "19d", SP_CLI, thickstun_cli, resume=False)


# ---------------------------------------------------------------------------
# phase 20: the library frontends (ops/extra_frontends.py)
# ---------------------------------------------------------------------------

# phase 20's audio: XF_CLIPS clips of XF_SAMPLES samples (2.97 s at the
# classes' default 22.05 kHz), noise of rms 0.1 from a seed
XF_CLIPS, XF_SAMPLES = 4, 65536
# an output is held when its largest error over max|truth| (float64 on the
# CPU) is at most XF_FACTOR x the CPU fp32 route's + XF_FLOOR; a round trip
# (DFT -> inverse, rfft -> ISTFT) within XF_ROUND_TRIP of max|audio|
XF_FACTOR, XF_FLOOR, XF_ROUND_TRIP = 2.0, 1e-6, 1e-5
# Griffin-Lim is held elementwise at XF_GL_ITERS iterations (each momentum
# step amplifies the rounding) and by the JAX package's tone criterion at
# its default 32 (tests/test_extra_frontends.py:77-86)
XF_GL_ITERS, XF_GL_TONE_ERR = 4, 0.15
# phase 20b: `MelSpectrogram` settings off its defaults, each with whether
# the mel_power kernel computes it (`htk` and `norm` change the basis
# alone, which the kernel reads with its band) and its key in the mel row
XF_MEL_SETTINGS = (({"center": False}, False, None),
                   ({"pad_mode": "constant"}, False, None),
                   ({"power": 1.0}, False, None),
                   ({"htk": True}, True, "htk"),
                   ({"norm": None}, True, "norm_none"))


def frontend_held(got, cpu32, truth) -> tuple:
    """(error, the CPU fp32 route's error, held) of one output: the
    largest error over max|truth| of `got` (on any device) and of `cpu32`
    against the float64 `truth`; held when `got` has the truth's shape, is
    finite, and its error is at most XF_FACTOR x the CPU's + XF_FLOOR."""
    truth = truth.detach().double().cpu()
    got = got.detach().double().cpu()
    top = truth.abs().max().item()
    err_cpu = (cpu32.detach().double() - truth).abs().max().item() / top
    if got.shape != truth.shape or not torch.isfinite(got).all():
        return float("inf"), err_cpu, False
    err = (got - truth).abs().max().item() / top
    return err, err_cpu, err <= XF_FACTOR * err_cpu + XF_FLOOR


def stft_parts(window, x):
    """(real, imag) of the rfft of x's centre reflect-padded frames
    (n_fft = len(window), hop n_fft // 4) times `window`: the ISTFT's
    input."""
    from reconvat_tpu_torch.ops.mel_kernel import frame_audio

    spec = torch.fft.rfft(frame_audio(x, len(window), len(window) // 4)
                          * window, dim=-1)
    return spec.real, spec.imag


def extra_frontend_cases(audio):
    """(name, module, input, call) of each class of `ops/extra_frontends`
    at its JAX defaults (CQT1992 at 60 bins: its default 84 from 220 Hz
    pass 22.05 kHz's Nyquist frequency, which both packages refuse);
    Griffin-Lim at XF_GL_ITERS iterations on the magnitude of the audio's
    STFT, with its initial phase drawn from a generator seeded 0."""
    from reconvat_tpu_torch.ops import extra_frontends as xf

    gl = xf.GriffinLim(n_iter=XF_GL_ITERS)
    mag = gl._stft_complex(audio).abs()
    n = audio.shape[1]
    return [
        ("MFCC", xf.MFCC(), audio, lambda m, a: m(a)),
        ("Gammatonegram", xf.Gammatonegram(), audio, lambda m, a: m(a)),
        ("DFT", xf.DFT(), audio, lambda m, a: m(a)),
        ("ISTFT", xf.ISTFT(), audio,
         lambda m, a: m(*stft_parts(m.window, a), length=n)),
        ("GriffinLim", gl, mag,
         lambda m, a: m(a, torch.Generator().manual_seed(0), length=n)),
        ("CQT1992", xf.CQT1992(n_bins=60), audio, lambda m, a: m(a)),
        ("CQT2010", xf.CQT2010(), audio, lambda m, a: m(a)),
        ("CQT2010v2", xf.CQT2010v2(), audio, lambda m, a: m(a))]


def phase_extra_frontends(rows) -> None:
    """Phase 20: each class of `ops/extra_frontends.py` on XF_CLIPS x
    XF_SAMPLES samples at fp32, TF32 off, on the card against a float64
    run on the CPU (`frontend_held`, beside the CPU's fp32 route), timed;
    DFT -> inverse and ISTFT round trips; Griffin-Lim's tone criterion.
    MFCC, the one class on a hand-written kernel (row 1, `mel_power`, at
    128 mels and 22.05 kHz): one call is a main path with every count set
    to 0 just before and read just after (one `mel_power` launch and no
    other; each further call one more), its kernel route is held against
    its plain route (`use_kernel = False`), timed beside it, and an MFCC
    at n_fft 1024, which the kernel does not compute, launches nothing.
    Then phase 20b (`phase_mel_settings`) on the same audio."""
    from reconvat_tpu_torch.models.base import fp32_math
    from reconvat_tpu_torch.ops import extra_frontends as xf
    from reconvat_tpu_torch.ops.mel_kernel import mel_power

    audio = torch.tensor(np.random.RandomState(20).randn(
        XF_CLIPS, XF_SAMPLES) * 0.1, dtype=torch.float32)
    x = audio.cuda()
    counters = kernel_counters()
    mel_row = next(row for row in rows if row["name"] == "mel_power")

    def counted(fn):
        torch.cuda.synchronize()
        for f, c in counters.values():
            setattr(f, c, 0)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: getattr(f, c) for k, (f, c) in counters.items()}

    read = []
    for name, module, inp, call in extra_frontend_cases(audio):
        truth = call(module.double(), inp.double())
        cpu32 = call(module.float(), inp)
        module = module.cuda()
        xin = inp.cuda()
        with fp32_math():
            if name == "MFCC":
                got, launches = counted(lambda: call(module, xin))
                if launches != {**{k: 0 for k in launches}, "mel_power": 1}:
                    fail(f"phase 20 MFCC: one call launched {launches}, "
                         f"not mel_power once")
                _, again = counted(lambda: [call(module, xin)
                                            for _ in range(3)])
                if again["mel_power"] != 3:
                    fail(f"phase 20 MFCC: 3 calls launched mel_power "
                         f"{again['mel_power']} times")
                mel_row["launches_mfcc"] = launches["mel_power"]
            else:
                got = call(module, xin)
            ms = time_ms(lambda: call(module, xin),
                         iters=5 if name == "GriffinLim" else 10)
        outs = got if isinstance(got, tuple) else (got,)
        cpus = cpu32 if isinstance(cpu32, tuple) else (cpu32,)
        truths = truth if isinstance(truth, tuple) else (truth,)
        held = [frontend_held(*o) for o in zip(outs, cpus, truths)]
        if not all(ok for _, _, ok in held):
            fail(f"phase 20 {name}: errors against float64 "
                 f"{[(e, c) for e, c, _ in held]} (the card's, the CPU's "
                 f"fp32; at most {XF_FACTOR}x the CPU's + {XF_FLOOR}), "
                 f"shapes {[tuple(o.shape) for o in outs]} against "
                 f"{[tuple(t.shape) for t in truths]}")
        line = (f"{name} {[tuple(o.shape) for o in outs]}: error "
                f"{max(e for e, _, _ in held)} (CPU fp32 "
                f"{max(c for _, c, _ in held)}), ms {ms}")
        if name == "MFCC":
            module.melspec.use_kernel = False
            with fp32_math():
                plain, plain_counts = counted(lambda: call(module, xin))
                plain_ms = time_ms(lambda: call(module, xin), iters=10)
            top = truth.abs().max().item()
            diff = (got - plain).abs().max().item() / top
            allowed = 2 * XF_FACTOR * held[0][1] + XF_FLOOR
            if diff > allowed or plain_counts["mel_power"]:
                fail(f"phase 20 MFCC: kernel route {diff} of max|truth| "
                     f"from the plain route (at most {allowed}), plain "
                     f"route launches {plain_counts}")
            short = xf.MFCC(n_fft=1024).cuda()
            _, short_counts = counted(lambda: short(x))
            if any(short_counts.values()):
                fail(f"phase 20 MFCC n_fft=1024 launched {short_counts}")
            line += (f", plain route ms {plain_ms} ({diff} from the kernel "
                     f"route); n_fft=1024 launched nothing")
        if name in ("DFT", "ISTFT"):
            rec = module.inverse(*got, length=XF_SAMPLES) if name == "DFT" \
                else got
            trip = (rec - x).abs().max().item() / x.abs().max().item()
            if trip > XF_ROUND_TRIP:
                fail(f"phase 20 {name}: round trip {trip} of max|audio| "
                     f"(at most {XF_ROUND_TRIP})")
            line += f", round trip {trip}"
        read.append(line)
        del module, truth, cpu32, got
    # Griffin-Lim at its default 32 iterations on a tone (the JAX test's)
    t = np.arange(8192) / 16000
    tone = torch.tensor(0.5 * np.sin(2 * np.pi * 523.25 * t),
                        dtype=torch.float32)[None].cuda()
    gl = xf.GriffinLim(n_fft=1024, hop_length=256).cuda()
    with fp32_math():
        mag = gl._stft_complex(tone).abs()
        rec = gl(mag, torch.Generator().manual_seed(3), length=8192)
        err = ((gl._stft_complex(rec).abs() - mag).norm() / mag.norm()).item()
    if not err < XF_GL_TONE_ERR:
        fail(f"phase 20 GriffinLim: tone magnitude error {err} (under "
             f"{XF_GL_TONE_ERR})")
    log(f"phase 20 the library frontends on {XF_CLIPS} x {XF_SAMPLES} "
        f"samples (fp32, TF32 off, against float64 on the CPU; MFCC's "
        f"launches per call {mel_row['launches_mfcc']}): "
        f"{'; '.join(read)}; Griffin-Lim tone error at 32 iterations {err}")
    phase_mel_settings(mel_row, audio, counted)


def phase_mel_settings(mel_row, audio, counted) -> None:
    """Phase 20b: `MelSpectrogram` at each of XF_MEL_SETTINGS on phase
    20's audio (22.05 kHz, 128 mels), fp32 with TF32 off, on the card
    against float64 on the CPU by `frontend_held`, beside the CPU's fp32
    route, timed. Its route is the one fixed when it was built: where the
    kernel computes the settings (an htk basis, norm=None) a call is a
    main path (`counted`: every count 0 just before, read just after)
    that launches `mel_power` once and nothing else, held against
    `mel_power_plain` on the same inputs within MEL_TOL and timed beside
    it, the launches, times and error going into the mel row under the
    setting's key; elsewhere a call launches nothing and `use_kernel =
    True` raises ValueError."""
    from reconvat_tpu_torch.models.base import fp32_math
    from reconvat_tpu_torch.ops.mel_kernel import mel_power_plain
    from reconvat_tpu_torch.ops.spectrogram import MelSpectrogram

    x = audio.cuda()
    read = []
    for kw, kernel, key in XF_MEL_SETTINGS:
        module = MelSpectrogram(**kw)
        if module.use_kernel is not kernel:
            fail(f"phase 20b MelSpectrogram({kw}) built with use_kernel "
                 f"{module.use_kernel}, not {kernel}")
        truth = module.double()(audio.double())
        cpu32 = module.float()(audio)
        module = module.cuda()
        with fp32_math():
            got, launches = counted(lambda: module(x))
            ms = time_ms(lambda: module(x))
        want = {**{k: 0 for k in launches}, "mel_power": int(kernel)}
        if launches != want:
            fail(f"phase 20b MelSpectrogram({kw}): one call launched "
                 f"{launches}, not {want}")
        err, err_cpu, ok = frontend_held(got, cpu32, truth)
        if not ok:
            fail(f"phase 20b MelSpectrogram({kw}): error against float64 "
                 f"{err}, the CPU fp32 route's {err_cpu} (at most "
                 f"{XF_FACTOR}x + {XF_FLOOR}), shape {tuple(got.shape)} "
                 f"against {tuple(truth.shape)}")
        line = (f"{kw} {'kernel' if kernel else 'plain'} route "
                f"{tuple(got.shape)}: error {err} (CPU fp32 {err_cpu}), "
                f"ms {ms}, launches {launches['mel_power']}")
        if kernel:
            args = (module.stft.wcos, module.stft.wsin, module.mel_basis,
                    module.stft.hop_length)
            with fp32_math():
                plain = mel_power_plain(x, *args)
                plain_ms = time_ms(lambda: mel_power_plain(x, *args))
            diff = check_close(f"phase 20b mel_power at {kw}", got, plain,
                               MEL_TOL)
            band = module.band.double()
            mel_row.update({f"launches_{key}": launches["mel_power"],
                            f"ms_{key}": ms, f"plain_ms_{key}": plain_ms,
                            f"max_abs_err_{key}": diff})
            line += (f", plain ms {plain_ms}, max abs diff {diff} (tol "
                     f"{MEL_TOL}), band mean width "
                     f"{(band[:, 1] - band[:, 0]).mean().item()}")
        else:
            try:
                module.use_kernel = True
            except ValueError:
                pass
            else:
                fail(f"phase 20b MelSpectrogram({kw}) took use_kernel = "
                     f"True where the kernel does not compute it")
        read.append(line)
        del module, truth, cpu32, got
    log(f"phase 20b MelSpectrogram settings on {XF_CLIPS} x {XF_SAMPLES} "
        f"samples (fp32, TF32 off, against float64 on the CPU): "
        f"{'; '.join(read)}")


def data_parallel_phases(groups=("17", "18", "19")) -> None:
    """`python3 chip_smoke.py --data-parallel [17] [18] [19]`: phases
    17b-17c, 18a-18d and 19a-19d alone, or the groups named (with the
    kernels built and phases 11's and 12b's corpora written first), for a
    machine with two or more cards, where they run over NCCL with a card
    per rank too (17b, 18a-18c and 19a-19c also over gloo on one card; on
    four cards 18a and 19a also at mesh_dp=2 x mesh_sp=2). Runs no other
    phase and prints no kernels line."""
    import shutil
    import tempfile

    from reconvat_tpu_torch.kernels import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} cards: {nvidia_smi()}")
    _build.build_all()
    rows = [{"name": name} for name in kernel_counters()]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    try:
        write_corpus(os.path.join(tmp, "corpus"))
        write_corpus(os.path.join(tmp, "corpus_onset"), seed=1, labeled=B)
        for label, phase, args in (
                ("17b", phase_data_parallel_steps, (rows,)),
                ("17c", phase_sharded_cli, (rows, tmp, "17c", DP_CLI)),
                ("18a-18c", phase_sequence_parallel, (rows,)),
                ("18d", phase_sharded_cli, (rows, tmp, "18d", SP_CLI)),
                ("19a-19c", phase_sequence_parallel_families, (rows,)),
                ("19d", phase_sharded_family_clis, (rows, tmp))):
            if label[:2] not in groups:
                continue
            t0 = time.perf_counter()
            phase(*args)
            torch.cuda.empty_cache()
            log(f"phase {label} took {time.perf_counter() - t0} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"rows' launches {rows}")


def main(argv: list) -> int:
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
    if argv[:1] == ["--bf16-step-rule"]:
        bf16_step_rule(int(argv[1]) if len(argv) > 1 else 8)
        return 0
    if argv[:1] == ["--dp-rank"]:
        dp_rank(*(int(a) for a in argv[1:4]), argv[4],
                *([int(argv[5])] if len(argv) > 5 else []),
                *([tuple(argv[6].split(","))] if len(argv) > 6 else []))
        return 0
    if argv[:1] and argv[0].startswith("--") and \
            argv[0].endswith("-step-rule"):
        step_rule(argv[0][2:-len("-step-rule")],
                  int(argv[1]) if len(argv) > 1 else 10)
        return 0
    if argv[:1] == ["--data-parallel"]:
        data_parallel_phases(tuple(argv[1:]) or ("17", "18", "19"))
        return 0
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
        phase_attention_unet_onset(rows)
        phase_unet_onset_step(rows)
        onset = phase_unet_onset_cli(rows, tmp)
        phase_evaluate_cli(rows, rec, onset, tmp)
        del rec, onset
        torch.cuda.empty_cache()
        took = [f"phases 1-12c {time.perf_counter() - t_start} s"]
        for label, phase, args in (
                ("13", phase_onsets_frames_steps, (rows, fe)),
                ("13a", phase_onsets_frames_cli, (rows, tmp)),
                ("13b", phase_baseline_clis, (rows, tmp)),
                ("13c", phase_families_bf16, (rows,)),
                ("14", phase_segmentation_step, (rows,)),
                ("14a-14b", phase_segmentation_clis_of_run, (rows, tmp)),
                ("14c", phase_families_bf16, (rows, ("Segmentation",),
                                              "14c")),
                ("15", phase_attention_model_kernels, (rows,)),
                ("15a", phase_attention_model_steps, (rows,)),
                ("16a", phase_frontends_cqt_cfp, ()),
                ("16b", phase_attention_cqt_cfp, (rows,)),
                ("16c", phase_reconvat_cqt_step, (rows,)),
                ("16d", phase_serve_cfp, (rows,)),
                ("16e", phase_cli_cqt_cfp, (rows,)),
                ("17a", phase_streaming_cqt_cfp, (rows,)),
                ("17b", phase_data_parallel_steps, (rows,)),
                ("17c", phase_sharded_cli, (rows, tmp, "17c", DP_CLI)),
                ("18a-18c", phase_sequence_parallel, (rows,)),
                ("18d", phase_sharded_cli, (rows, tmp, "18d", SP_CLI)),
                ("19a-19c", phase_sequence_parallel_families, (rows,)),
                ("19d", phase_sharded_family_clis, (rows, tmp)),
                ("20", phase_extra_frontends, (rows,))):
            t0 = time.perf_counter()
            phase(*args)
            torch.cuda.empty_cache()
            took.append(f"{label} {time.perf_counter() - t0} s")
        log(f"phase times: {', '.join(took)}")
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
    sys.exit(main(sys.argv[1:]))
