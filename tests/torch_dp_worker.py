"""One rank of the data-parallel and sequence-parallel CPU tests
(tests/test_torch_parallel.py, tests/test_torch_sequence_parallel.py,
tests/test_torch_sequence_parallel_families.py, and the JAX comparisons
of tests/test_torch_train.py and tests/test_torch_segmentation.py), torch
only:

    python -m tests.torch_dp_worker <rank> <world> <port> <out.pt> [job.pt]

Joins a gloo group of `world` CPU ranks on localhost:<port>. Without a job
it runs each case of `CASES` on its rows of the global batch under an
active mesh and saves {case: result} to <out.pt> (rank 0 also the fp32
case in one process on SPREAD_THREADS threads, 'flagship32_threads'); the
test builds the same models, inputs and single-process results with the
functions below.
With a job (`run_job`) it takes one train step of the job's model and
weights on its share of the job's global batches (over `job["sp"]` sp
ranks, 1 by default) and saves `step_run`'s result; a job of `SP_CASES`
(`{"cases": [(case, sp), ...]}`) runs each sequence-parallel case on a mesh
of that sp (`sp_case`; a case named in the job's `jobs` dict is that
job's step, `job_run`). `spawn` starts the ranks.
"""
import contextlib
import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from reconvat_tpu_torch.models import get_model
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
from reconvat_tpu_torch.models.thickstun import Thickstun
from reconvat_tpu_torch.models.unet_onset import UNetOnset
from reconvat_tpu_torch.nn.layers import SharedDropout
from reconvat_tpu_torch.nn.unet import BatchNorm2d
from reconvat_tpu_torch.parallel import distributed
from reconvat_tpu_torch.parallel import mesh as pmesh
from reconvat_tpu_torch.train.state import (create_train_state,
                                            make_train_step)

BN_SHAPE = (8, 5, 6, 7)             # global batch, channels, H, W
FRAMES, SEG_FRAMES, SEED = 32, 37, 11
LR = 1e-3
CASES = ("bn", "flagship64", "segmentation64", "flagship32")
# Segmentation's step without VAT: in float64 its VAT step's gradients move
# by 9e-9 of the largest between 1 and 4 CPU threads of one process
VAT = {"flagship64": True, "segmentation64": False, "flagship32": True}
# threads of rank 0's one-process fp32 step beside the test's one thread
SPREAD_THREADS = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a collective that waits longer fails the rank (a skipped call hangs)
TIMEOUT = datetime.timedelta(seconds=120)


def bn_inputs():
    """The BatchNorm case's layer (float64, a drawn affine part), global
    input and output weights (the loss is sum(y * w))."""
    rng = np.random.RandomState(0)
    layer = BatchNorm2d(BN_SHAPE[1]).double()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5)))
        layer.bias.copy_(torch.from_numpy(rng.randn(5)))
    layer.train()
    x = torch.from_numpy(rng.randn(*BN_SHAPE) * 2.0 + 0.7)
    w = torch.from_numpy(rng.randn(*BN_SHAPE))
    return layer, x, w


def bn_run(layer, x, w, ctx=None) -> dict:
    """Forward and backward of sum(y * w) on x (this rank's rows under
    `ctx`): output, input gradient, the affine gradients (summed over the
    ranks) and the running statistics."""
    x = x.clone().requires_grad_(True)
    with pmesh.sharded_step(ctx):
        y = layer(x)
    (y * w).sum().backward()
    grads = [layer.weight.grad, layer.bias.grad]
    if ctx is not None:
        pmesh.all_reduce_mean(grads, ctx)
        grads = [g * ctx.world for g in grads]
    return {"y": y.detach(), "dx": x.grad, "dweight": grads[0],
            "dbias": grads[1], "running_mean": layer.running_mean.clone(),
            "running_var": layer.running_var.clone()}


def step_setup(case: str):
    """(model, global labeled batch, global unlabeled batch) of a step
    case: the flagship (float64 at xi 1e-2, or fp32 at the default xi) at
    4 + 4 clips of 32 frames, or Segmentation (float64, dropout 0.4) at 2
    clips of 37 frames."""
    rng = np.random.RandomState(3)
    if case == "segmentation64":
        model = SemanticSegmentation(device="cpu", seed=1).double()
        b, frames, dtype = 2, SEG_FRAMES, torch.float64
    elif case == "flagship64":
        model = ReconVAT(device="cpu", seed=2, xi=1e-2).double()
        b, frames, dtype = 4, FRAMES, torch.float64
    else:
        model = ReconVAT(device="cpu", seed=4)
        b, frames, dtype = 4, FRAMES, torch.float32
    n = frames * 512

    def audio():
        return torch.tensor(rng.randn(b, n) * 0.1, dtype=dtype)

    label = torch.tensor(rng.rand(b, frames, 88) < 0.05, dtype=dtype)
    return model, {"audio": audio(), "frame": label}, {"audio": audio()}


def step_run(model, batch_l, batch_ul, vat: bool, seed: int = SEED,
             clip: float = 3.0) -> dict:
    """One train step (`make_train_step`, Adam at LR, the gradient's norm
    clipped to `clip`, 0 for none; with VAT on both batches, or
    supervised) from the model's state, its draws from a generator seeded
    `seed`; the losses, the reduced (clipped) gradients and the new
    state."""
    state = create_train_state(model, learning_rate=LR,
                               clip_gradient_norm=clip)
    step = make_train_step(model, 1.0, vat=vat, use_unlabeled=vat)
    losses = step(state, batch_l, batch_ul,
                  torch.Generator().manual_seed(seed))
    return {"losses": {k: v.item() for k, v in losses.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


@contextlib.contextmanager
def jax_attention_casts():
    """Inside, Segmentation's `MultiHeadAttention2D` rounds as the JAX
    package's does in float64 (x64) mode (`reconvat_tpu/models/
    segmentation.py:312-314`): the energies cast to fp32 and the softmax
    taken in fp32, the output rounded to fp32, each cotangent rounded the
    same way in the backward. The port's `promote_fp32` there meets the
    (B, G, H, W, k) energies and the (B, C, H, W) output."""
    from reconvat_tpu_torch.models import segmentation

    promote = segmentation.promote_fp32

    def jax_rounding(x):
        return x.float() if x.dim() == 5 else x.float().to(x.dtype)

    segmentation.promote_fp32 = jax_rounding
    try:
        yield
    finally:
        segmentation.promote_fp32 = promote


def job_run(job: dict, ctx) -> dict:
    """A job's step on this rank's rows: `job` holds the model's registry
    name (`model`) and keyword arguments, its float64 `state`, the global
    `batch_l` and `batch_ul` (None without VAT), `vat` and `seed`, and
    optionally `jax_casts` (the step under `jax_attention_casts`); the
    gradient is not clipped."""
    model = get_model(job["model"], device="cpu", **job["kwargs"]).double()
    model.load_state_dict(job["state"], strict=True)
    batch_ul = job["batch_ul"]
    with (jax_attention_casts() if job.get("jax_casts")
          else contextlib.nullcontext()):
        return step_run(model, pmesh.shard_batch(job["batch_l"], ctx),
                        None if batch_ul is None
                        else pmesh.shard_batch(batch_ul, ctx),
                        job["vat"], job["seed"], clip=0.0)


def run_job(tmp_path, job: dict, world: int = 2) -> list:
    """Each of `world` ranks' `job_run` of `job` (written under
    tmp_path)."""
    path = os.path.join(tmp_path, "job.pt")
    torch.save(job, path)
    return spawn(tmp_path, world, path)()


def spawn(out_dir, world: int = 2, job: str | None = None):
    """Start `world` ranks (this module, one process each, on a free
    port) writing under out_dir; returns wait(timeout=600), which returns
    their results in rank order and fails with a rank's output if one
    failed or outlasted the timeout."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    outs = [os.path.join(out_dir, f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_worker", str(r), str(world),
         str(port), outs[r]] + ([job] if job else []), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

    def wait(timeout: float = 600) -> list:
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
        return [torch.load(o) for o in outs]

    return wait


# ---------------------------------------------------------------------------
# sequence parallelism (tests/test_torch_sequence_parallel.py)
# ---------------------------------------------------------------------------

SP_CASES = ("halo", "eval", "flagship64sp", "onset64sp", "stream_Mel",
            "stream_CQT", "halo_long", "draw", "seg64sp", "seg64sp_novat",
            "seg64sp_zero_strided_pads", "seg64sp_no_halos", "thick64sp",
            "thick64sp_narrow")
SP_B, SP_FRAMES = 2, 32         # global batch rows, frames (16 a rank at 2)
# per rank shape, dim, halo before, after: the U-Nets' 1 and 15 ("halo");
# halos of 1.5x and 3x a rank's frames, one-sided ones (a strided
# convolution's (0, 1), a transposed one's (1, 0)) and long one-sided ones
# ("halo_long")
HALO_SHAPES = (((2, 3, 4, 5), 2, 1, 1), ((2, 16, 3), 1, 15, 15))
LONG_HALO_SHAPES = (((2, 4, 3), 1, 6, 6), ((1, 2, 3, 4), 2, 9, 9),
                    ((2, 2, 4, 3), 2, 0, 1), ((2, 2, 4, 3), 2, 1, 0),
                    ((2, 4, 3), 1, 0, 10), ((2, 4, 3), 1, 7, 0))
STREAM_W, STREAM_H, STREAM_SECONDS = 64, 32, 8.0


def halo_inputs(sp: int, shapes=HALO_SHAPES) -> list:
    """Per halo shape: (whole x, whole output weights, dim, halo before,
    after), whole along `dim` over sp ranks, integer-valued float64 (so
    every sum of the gradient is exact in any order)."""
    rng = np.random.RandomState(sp)
    out = []
    for shape, dim, before, after in shapes:
        whole = list(shape)
        whole[dim] *= sp
        x = torch.from_numpy(rng.randint(-9, 10, whole).astype(np.float64))
        wshape = list(shape)
        wshape[dim] += before + after
        w = torch.from_numpy(rng.randint(-9, 10, [sp] + wshape).astype(
            np.float64))
        out.append((x, w, dim, before, after))
    return out


def halo_reference(sp: int, shapes=HALO_SHAPES) -> list:
    """Per halo shape, per rank: (its haloed slice of the whole x
    zero-padded on `dim`, the whole x's gradient of the sum over the ranks
    of sum(slice * w[rank]), this rank's frames of it)."""
    out = []
    for x, w, dim, before, after in halo_inputs(sp, shapes):
        x = x.clone().requires_grad_(True)
        per = x.shape[dim] // sp
        pad = [0, 0] * (x.dim() - dim - 1) + [before, after]
        xp = torch.nn.functional.pad(x, pad)
        ys = [xp.narrow(dim, r * per, per + before + after)
              for r in range(sp)]
        sum((y * w[r]).sum() for r, y in enumerate(ys)).backward()
        out.append([(ys[r].detach(), x.grad.narrow(dim, r * per, per))
                    for r in range(sp)])
    return out


def halo_run(ctx, shapes=HALO_SHAPES) -> list:
    """Per halo shape, this rank's (time_halo of its frames, their
    gradient of the sum over the ranks)."""
    out = []
    for x, w, dim, before, after in halo_inputs(ctx.sp, shapes):
        mine = pmesh.sp_frames(x, ctx, dim).clone().requires_grad_(True)
        y = pmesh.time_halo(mine, before, after, ctx, dim)
        (y * w[ctx.sp_rank]).sum().backward()
        out.append((y.detach(), mine.grad))
    return out


def sp_setup(case: str):
    """(model, global labeled batch, global unlabeled batch) of a
    sequence-parallel step case, float64 at xi 1e-2: the flagship, or
    UNetOnset (its batch with onset labels), SP_B + SP_B clips of
    SP_FRAMES frames."""
    rng = np.random.RandomState(5)
    if case == "onset64sp":
        model = UNetOnset(device="cpu", seed=3, xi=1e-2).double()
    else:
        model = ReconVAT(device="cpu", seed=2, xi=1e-2).double()
    n = SP_FRAMES * 512

    def audio():
        return torch.tensor(rng.randn(SP_B, n) * 0.1, dtype=torch.float64)

    batch_l = {"audio": audio(), "frame": torch.tensor(
        rng.rand(SP_B, SP_FRAMES, 88) < 0.05, dtype=torch.float64)}
    if case == "onset64sp":
        batch_l["onset"] = torch.tensor(rng.rand(SP_B, SP_FRAMES, 88) < 0.02,
                                        dtype=torch.float64)
    return model, batch_l, {"audio": audio()}


def eval_run(ctx=None) -> dict:
    """The flagship's eval-mode full forward (reconstruction, both
    transcriber passes, the attention) on the labeled batch of
    `sp_setup`, float64; under `ctx` inside a sharded step on this rank's
    frames."""
    model, batch_l, _ = sp_setup("eval")
    model.eval()
    with torch.no_grad(), pmesh.sharded_step(ctx):
        spec = model.make_spec(batch_l["audio"])
        out = model(spec)
    return dict(zip(("reconstruction", "pianoroll", "pianoroll2",
                     "attention", "spec"), out + (spec,)))


def stream_song() -> np.ndarray:
    rng = np.random.RandomState(8)
    n = int(STREAM_SECONDS * 16000)
    t = np.arange(n) / 16000
    tone = sum(np.sin(2 * np.pi * f * t) for f in (220, 330, 523))
    return (0.2 * tone * (t % 1 < 0.6) + 0.01 * rng.randn(n)).astype(
        np.float32)[None]


def stream_run(spec: str, ctx=None) -> torch.Tensor:
    """The flagship's stream (fp32, seed 6, windows of STREAM_W frames,
    halo STREAM_H) of `stream_song` on `spec`; over the ranks of `ctx`."""
    model = ReconVAT(device="cpu", seed=6, spec=spec)
    return model.transcribe_streaming(
        torch.from_numpy(stream_song()), window_frames=STREAM_W,
        halo_frames=STREAM_H, mesh_ctx=ctx)["frame"]


# ---------------------------------------------------------------------------
# sequence parallelism in Segmentation and Thickstun
# (tests/test_torch_sequence_parallel_families.py)
# ---------------------------------------------------------------------------

SEG_FRAMES, THICK_FRAMES = 64, 20   # 32 a rank at sp 2; 10 (< 12, the halo)
# the time convolution's channels of the narrow Thickstun ('thick64sp_narrow',
# the JAX comparison's: XLA's float64 convolution on the CPU takes 113 s for
# a step at the reference's 4096)
NARROW_K2_OUT = 64
# global shapes and their time axes: a (B, T, F) draw and an NCHW one
DRAW_SHAPES = (((4, 8, 3), 1), ((4, 3, 8, 5), 2))
DRAW_SEED, DROPOUT = 9, 0.4


def local_shape(shape, dim: int, ctx) -> tuple:
    """This rank's share of a global shape: rows over dp, axis dim over
    sp."""
    shape = list(shape)
    shape[0] //= ctx.dp
    shape[dim] //= ctx.sp
    return tuple(shape)


def draw_run(ctx=None) -> list:
    """Per DRAW_SHAPES entry, `draw_rows` of a uniform draw (seed
    DRAW_SEED) and a `SharedDropout(DROPOUT, time_dim)` of ones in
    training mode (its generator seeded DRAW_SEED), inside a sharded step
    on this rank's share of the shape (the whole shape without ctx)."""
    out = []
    for shape, dim in DRAW_SHAPES:
        mine = shape if ctx is None else local_shape(shape, dim, ctx)
        g = torch.Generator().manual_seed(DRAW_SEED)
        drop = SharedDropout(DROPOUT, dim).train()
        drop.new_masks(torch.Generator().manual_seed(DRAW_SEED))
        with pmesh.sharded_step(ctx):
            u = pmesh.draw_rows(lambda s: torch.rand(s, generator=g,
                                                     dtype=torch.float64),
                                mine, time_dim=dim)
            out.append((u, drop(torch.ones(mine, dtype=torch.float64))))
    return out


def thickstun(narrow: bool = False) -> Thickstun:
    """Thickstun (seed 1) at the reference's widths, or narrow: its time
    convolution's channels (`models/thickstun.py:K2_OUT`) NARROW_K2_OUT."""
    from reconvat_tpu_torch.models import thickstun as module

    wide = module.K2_OUT
    module.K2_OUT = NARROW_K2_OUT if narrow else wide
    try:
        return Thickstun(device="cpu", seed=1)
    finally:
        module.K2_OUT = wide


def family_setup(case: str):
    """(model, global labeled batch, global unlabeled batch or None, vat)
    of a family case, float64: Segmentation (seed 1, dropout 0.4) on 2
    clips of SEG_FRAMES, with VAT at xi 1e-2 on 2 + 2 ('seg64sp') or
    supervised ('seg64sp_novat' and the negative controls); Thickstun
    (seed 1, supervised) on 2 clips of THICK_FRAMES ('thick64sp'; with
    NARROW_K2_OUT time-convolution channels 'thick64sp_narrow')."""
    rng = np.random.RandomState(6)
    thick = case.startswith("thick64sp")
    frames = THICK_FRAMES if thick else SEG_FRAMES
    model = (thickstun(case == "thick64sp_narrow") if thick else
             SemanticSegmentation(device="cpu", seed=1, xi=1e-2))

    def audio():
        return torch.tensor(rng.randn(SP_B, frames * 512) * 0.1,
                            dtype=torch.float64)

    batch_l = {"audio": audio(), "frame": torch.tensor(
        rng.rand(SP_B, frames, 88) < 0.05, dtype=torch.float64)}
    vat = case == "seg64sp"
    return model.double(), batch_l, {"audio": audio()} if vat else None, vat


def broken_halos(which: str):
    """A stand-in for `parallel.mesh.time_halo` that zero-pads (as one
    clip's edge would) where a rank needs its neighbours' frames: every
    halo ('no_halos'), or the strided convolutions' end frame, the TF-SAME
    (0, 1) pad ('zero_strided_pads')."""
    halo = pmesh.time_halo

    def broken(x, before, after, ctx, dim=1):
        if which == "no_halos" or (before, after) == (0, 1):
            ctx = None
        return halo(x, before, after, ctx, dim)
    return broken


def family_run(case: str, ctx=None) -> dict:
    """`step_run` of a family case (`family_setup`) on this rank's share
    of the global batches under `ctx` (the whole batches without);
    'seg64sp_zero_strided_pads' and 'seg64sp_no_halos' take the
    supervised step with `broken_halos`."""
    model, batch_l, batch_ul, vat = family_setup(case)
    if ctx is not None:
        batch_l = pmesh.shard_batch(batch_l, ctx)
        batch_ul = None if batch_ul is None else pmesh.shard_batch(
            batch_ul, ctx)
    halo = pmesh.time_halo
    if case.startswith("seg64sp_") and case != "seg64sp_novat":
        pmesh.time_halo = broken_halos(case[len("seg64sp_"):])
    try:
        return step_run(model, batch_l, batch_ul, vat)
    finally:
        pmesh.time_halo = halo


def sp_case(case: str, ctx):
    """This rank's result of a sequence-parallel case on mesh `ctx`."""
    if case == "halo":
        return halo_run(ctx)
    if case == "halo_long":
        return halo_run(ctx, LONG_HALO_SHAPES)
    if case == "draw":
        return draw_run(ctx)
    if case.startswith(("seg64sp", "thick64sp")):
        return family_run(case, ctx)
    if case == "eval":
        return eval_run(ctx)
    if case.startswith("stream_"):
        return stream_run(case[len("stream_"):], ctx)
    model, batch_l, batch_ul = sp_setup(case)
    return step_run(model, pmesh.shard_batch(batch_l, ctx),
                    pmesh.shard_batch(batch_ul, ctx), True)


def run_rank(rank: int, world: int, port: int, job: str | None) -> dict:
    distributed.TIMEOUT = TIMEOUT
    distributed.initialize("localhost", port, world, rank, device="cpu")
    out = {}
    job = torch.load(job) if job is not None else None
    try:
        if job is not None and "cases" in job:
            jobs = job.get("jobs", {})
            for case, sp in job["cases"]:
                with pmesh.activate(pmesh.make_mesh(sp=sp)) as ctx:
                    out[case] = (job_run(jobs[case], ctx) if case in jobs
                                 else sp_case(case, ctx))
            return out
        with pmesh.activate(pmesh.make_mesh(
                sp=job.get("sp", 1) if job else 1)) as ctx:
            if job is not None:
                return job_run(job, ctx)
            layer, x, w = bn_inputs()
            out["bn"] = bn_run(layer, pmesh.batch_rows({"audio": x}, ctx)[
                "audio"], pmesh.batch_rows({"audio": w}, ctx)["audio"], ctx)
            for case in CASES[1:]:
                model, batch_l, batch_ul = step_setup(case)
                out[case] = step_run(model, pmesh.shard_batch(batch_l, ctx),
                                     pmesh.shard_batch(batch_ul, ctx),
                                     VAT[case])
        if rank == 0:
            # the fp32 step in one process on SPREAD_THREADS threads: the
            # test's second reading of its rounding-driven VAT losses
            torch.set_num_threads(SPREAD_THREADS)
            out["flagship32_threads"] = step_run(*step_setup("flagship32"),
                                                 VAT["flagship32"])
            torch.set_num_threads(1)
    finally:
        distributed.shutdown()
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    rank_, world_, port_, path, *job_ = sys.argv[1:]
    torch.save(run_rank(int(rank_), int(world_), int(port_),
                        job_[0] if job_ else None), path)
