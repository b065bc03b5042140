#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `reconvat_tpu_torch/csrc/` with nvcc,
holds each kernel against its plain PyTorch version at the serving path's
full-width shapes and times it, then drives the serving path
(`serve.transcribe_batch` over `ReconVAT`, random weights from a fixed
seed) on 8 clips of 20.48 s, once through the kernels and once through the
plain versions, and checks that both agree and that the kernels ran.

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
PEAK_BYTES = 3.35e12

B, SAMPLES = 8, 327680            # 8 clips of 20.48 s -> 640 frames
H, W = 4, 31                      # attention heads, window
MEL_TOL = dict(rtol=1e-4, atol=1e-6)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
POST_ATOL = 1e-4                  # posteriogram, plain vs kernel path


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


def bound(flops: float, nbytes: float):
    """Least time on the card (ms) and what sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, with the 50 MB L2
    flushed (a 64 MB write) before each, timed by CUDA events."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def check_close(name, got, ref, tol) -> float:
    err = (got - ref).abs().max().item()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got, ref, **tol):
        fail(f"{name}: max abs err {err} outside {tol}")
    return err


def phase_mel(fe):
    from reconvat_tpu_torch.ops.mel_kernel import mel_power, mel_power_plain

    rng = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, SAMPLES - 1), generator=rng, device="cuda") * 0.1
    args = (fe.stft.wcos, fe.stft.wsin, fe.mel_basis, fe.stft.hop_length)
    got = mel_power(x, *args)
    torch.cuda.synchronize()
    ref = mel_power_plain(x, *args)
    err = check_close("mel_power", got, ref, MEL_TOL)
    T, n_mels = got.shape[1:]
    n_fft, n_freq = fe.stft.wcos.shape
    if (T, n_mels) != (640, 229):
        fail(f"mel_power shape {tuple(got.shape)}")
    window = torch.hann_window(n_fft, periodic=True, device="cuda")

    def library():
        spec = torch.stft(x, n_fft, fe.stft.hop_length, window=window,
                          center=True, pad_mode="reflect",
                          return_complex=True).abs().square()
        return spec.transpose(1, 2) @ fe.mel_basis

    lib_err = (library() - ref).abs().max().item()
    flops = B * T * (2 * 2 * n_fft * n_freq + 2 * n_freq * n_mels)
    nbytes = 4 * (x.numel() + 2 * n_fft * n_freq + n_freq * n_mels
                  + got.numel())
    bound_ms, bound_by = bound(flops, nbytes)
    row = dict(
        name="mel_power", route="cuda", source="reconvat_tpu_torch/csrc/mel.cu",
        replaces="reconvat_tpu/ops/pallas_mel.py:36",
        max_abs_err=err, ms=time_ms(lambda: mel_power(x, *args)),
        plain_ms=time_ms(lambda: mel_power_plain(x, *args)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library))
    log(f"phase 2 mel_power (B={B}, N={SAMPLES - 1}) -> {tuple(got.shape)}: "
        f"max_abs_err {err} (tol {MEL_TOL}), library (torch.stft) err "
        f"{lib_err}, ms {row['ms']}, plain_ms {row['plain_ms']}, library_ms "
        f"{row['library_ms']}, bound_ms {bound_ms} ({bound_by}; "
        f"{flops / 1e9} GFLOP, {nbytes / 1e6} MB)")
    return row


def phase_attention():
    import torch.nn.functional as F

    from reconvat_tpu_torch.ops.banded_attention_kernel import (
        banded_attention, banded_attention_fwd)

    L, D, hw = 640, 229, (W - 1) // 2
    rng = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=rng, device="cuda") * scale

    q = randn(B, L, H, D, scale=D ** -0.25)
    kpad = F.pad(randn(B, L, H, D, scale=D ** -0.25), (0, 0, 0, 0, hw, hw))
    vpad = F.pad(randn(B, L, H, D), (0, 0, 0, 0, hw, hw))
    rel = randn(H, D, W, scale=0.1 * D ** -0.25)
    out, probs = banded_attention_fwd(q, kpad, vpad, rel, W)
    torch.cuda.synchronize()
    ref_out, ref_probs = banded_attention(q, kpad, vpad, rel, W)
    err_out = check_close("attention out", out, ref_out, ATTN_TOL)
    err_p = check_close("attention probs", probs, ref_probs, ATTN_TOL)

    # library yardstick: SDPA over the padded sequence with a dense additive
    # mask carrying the band and the skewed q.rel bias (built untimed)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kpad, vpad))
    qrel = torch.einsum("blhd,hdw->bhlw", q, rel)
    mask = torch.full((B, H, L, L + W - 1), float("-inf"), device="cuda")
    cols = torch.arange(L, device="cuda")[:, None] + torch.arange(
        W, device="cuda")
    mask.scatter_(3, cols.expand(B, H, L, W), qrel)

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
        replaces="reconvat_tpu/ops/pallas_attention.py:56",
        max_abs_err=max(err_out, err_p),
        ms=time_ms(lambda: banded_attention_fwd(q, kpad, vpad, rel, W)),
        plain_ms=time_ms(lambda: banded_attention(q, kpad, vpad, rel,
                                                         W)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(library))
    log(f"phase 3 banded_attention_fwd (B={B}, L={L}, H={H}, Dh={D}, W={W}): "
        f"max_abs_err out {err_out} probs {err_p} (tol {ATTN_TOL}), library "
        f"(SDPA, dense mask) err {lib_err}, ms {row['ms']}, plain_ms "
        f"{row['plain_ms']}, library_ms {row['library_ms']}, bound_ms "
        f"{bound_ms} ({bound_by}; {flops / 1e9} GFLOP, {nbytes / 1e6} MB)")
    return row


def serve_loop(serve, model, batches, depth: int = 2) -> dict:
    """Run every batch through the serving path with up to `depth` batches
    in flight. Returns the notes of the first batch, the total note count,
    the wall seconds, and the host seconds spent enqueuing (`submit`),
    waiting for the packed rolls, and decoding."""
    copy_stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    r = dict(first=None, notes=0, seconds=0.0, submit=0.0, wait=0.0,
             decode=0.0)

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


KERNEL_GROUPS = (("mel_power", ("mel_partial", "sum_chunks")),
                 ("banded_attention_fwd", ("banded_attention",)),
                 ("convolutions_bn", ("conv", "cudnn", "implicit", "dgrad",
                                      "fprop", "fft", "bn_fw")),
                 ("matmuls", ("gemm", "gemv")),
                 ("copies", ("memcpy", "memset")))


def phase_profile(serve, model, batches) -> None:
    """Device time by kernel over a short steady window of the serving path
    (torch.profiler) and the device's busy share of the window's wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sec = serve_loop(serve, model, batches)["seconds"]
    kernels = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms == 0:
        log("phase 5 profile: the profiler recorded no device kernels; "
            "device time not measured")
        return
    groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    for name, us in kernels.items():
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] += us / 1e3
    n = len(batches)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"phase 5 profile ({n} batches, depth 2): wall {sec * 1e3 / n} "
        f"ms/batch, device busy {busy_ms / n} ms/batch, busy share "
        f"{busy_ms / (sec * 1e3)}; device ms/batch by group "
        f"{ {g: v / n for g, v in groups.items()} }; top kernels (ms/batch) "
        f"{[(k[:60], v / 1e3 / n) for k, v in top]}")


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
    audio_s = B * SAMPLES / 16000

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

    def per_batch(r):
        ms = r["seconds"] / n_batches * 1e3
        host = ", ".join(f"{k} {r[k] / n_batches * 1e3}"
                         for k in ("submit", "wait", "decode"))
        return (f"{ms} ms/batch {audio_s / (ms / 1e3)} audio-s/s "
                f"(host ms/batch: {host})")

    log(f"phase 4 serving (B={B} x {SAMPLES} int16, {n_batches} batches, "
        f"depth 2): posteriogram max abs diff kernel vs plain {diff}, packed "
        f"bits agreeing {agree}, roll density {density}, CUDA vs CPU (1 x 64 "
        f"frames) {cpu_diff}, notes decoded {run['notes']} (first batch "
        f"{sum(len(p) for p, _ in run['first'])}; plain run "
        f"{run_plain['notes']}); kernels {per_batch(run)}; plain "
        f"{per_batch(run_plain)}; launches {launches} over {n_batches} "
        f"batches")
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_profile(serve, model, batches[:4])


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
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    log(f"phase 1 {card}; kernels built in {time.perf_counter() - t0} s")

    fe = make_frontend("Mel")[0].cuda()
    rows = [phase_mel(fe), phase_attention()]
    phase_serve(rows)
    for row in rows:
        row["max_err"] = row["max_abs_err"]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
