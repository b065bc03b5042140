"""One rank of the data-parallel CPU tests (tests/test_torch_parallel.py,
and the JAX comparisons of tests/test_torch_train.py and
tests/test_torch_segmentation.py), torch only:

    python -m tests.torch_dp_worker <rank> <world> <port> <out.pt> [job.pt]

Joins a gloo group of `world` CPU ranks on localhost:<port>. Without a job
it runs each case of `CASES` on its rows of the global batch under an
active mesh and saves {case: result} to <out.pt>; the test builds the
same models, inputs and single-process results with the functions below.
With a job (`run_job`) it takes one train step of the job's model and
weights on its rows of the job's global batches and saves `step_run`'s
result. `spawn` starts the ranks.
"""
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


def job_run(job: dict, ctx) -> dict:
    """A job's step on this rank's rows: `job` holds the model's registry
    name (`model`) and keyword arguments, its float64 `state`, the global
    `batch_l` and `batch_ul` (None without VAT), `vat` and `seed`; the
    gradient is not clipped."""
    model = get_model(job["model"], device="cpu", **job["kwargs"]).double()
    model.load_state_dict(job["state"], strict=True)
    batch_ul = job["batch_ul"]
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


def run_rank(rank: int, world: int, port: int, job: str | None) -> dict:
    distributed.TIMEOUT = TIMEOUT
    distributed.initialize("localhost", port, world, rank, device="cpu")
    out = {}
    try:
        with pmesh.activate(pmesh.make_mesh()) as ctx:
            if job is not None:
                return job_run(torch.load(job), ctx)
            layer, x, w = bn_inputs()
            out["bn"] = bn_run(layer, pmesh.batch_rows({"audio": x}, ctx)[
                "audio"], pmesh.batch_rows({"audio": w}, ctx)["audio"], ctx)
            for case in CASES[1:]:
                model, batch_l, batch_ul = step_setup(case)
                out[case] = step_run(model, pmesh.shard_batch(batch_l, ctx),
                                     pmesh.shard_batch(batch_ul, ctx),
                                     VAT[case])
    finally:
        distributed.shutdown()
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    rank_, world_, port_, path, *job_ = sys.argv[1:]
    torch.save(run_rank(int(rank_), int(world_), int(port_),
                        job_[0] if job_ else None), path)
