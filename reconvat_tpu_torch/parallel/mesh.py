"""Data-parallel device mesh (the port's counterpart of
`reconvat_tpu/parallel/mesh.py`).

The JAX package lays a (dcn,) dp x sp mesh over its devices, shards the
batch over dp and the time axis over sp, replicates the parameters and
lets GSPMD insert the collectives. Here a mesh is dp processes, one rank
per device (`parallel/distributed.py`), and the collectives are explicit:

- `shard_batch`: each rank keeps its rows of the global batch (every rank
  loads the same global batch from the same seeded loaders);
- `replicate`: parameters, buffers and optimizer state broadcast from rank
  0;
- inside a data-parallel step (`sharded_step`): train-mode BatchNorm takes
  the global batch's moments (`global_moments`, a differentiable
  all-reduce), every random draw of the step takes the global batch's
  shape from the step's generator and keeps this rank's rows
  (`draw_rows`), so that the step draws what the one-device step draws;
  after the backward the gradients and the returned losses are
  all-reduced to their means (`all_reduce_mean`).

Averaging per-rank means gives the global mean because every rank holds
the same number of rows (the loaders' crops are equal in length; a loss
divided by a mask's sum would need the counts reduced too, and no
training loss is). Sequence parallelism (`sp > 1`) is not ported.
`spec_constraint`, GSPMD's placement hint, has no counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

BATCH_KEYS = ("audio", "onset", "offset", "frame", "velocity")
SP_ITEM = "ROADMAP §1 item 3.3, sequence parallelism"
STREAM_ITEM = "ROADMAP §1 item 3.2, streaming over devices"

_ACTIVE = None          # the MeshContext of `activate`
_STEP = None            # the MeshContext of the step in progress


def refuse_sp(sp: int) -> None:
    if sp > 1:
        raise NotImplementedError(
            f"mesh_sp={sp}: sequence parallelism (the time axis over ranks, "
            f"with the 15-frame attention halo and the convolutions' halos "
            f"exchanged) is not ported ({SP_ITEM})")


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The data-parallel mesh as this rank sees it: its rank, the number
    of ranks (each holds a shard of the batch) and its device."""
    rank: int
    world: int
    device: torch.device


def make_mesh(dp: int | None = None, sp: int = 1,
              device=None) -> MeshContext:
    """This rank's view of a dp x sp mesh over the process group (dp: the
    group's size by default; sp > 1 is not ported) on `device`
    (`distributed.initialize`'s by default)."""
    refuse_sp(sp)
    world = distributed.world_size()
    if dp not in (None, world):
        raise ValueError(f"a mesh of dp={dp} needs that many ranks; the "
                         f"process group has {world}")
    return MeshContext(distributed.rank(), world, torch.device(
        device if device is not None else distributed.device()))


@contextlib.contextmanager
def activate(ctx: MeshContext):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = ctx
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def active() -> MeshContext | None:
    return _ACTIVE


@contextlib.contextmanager
def sharded_step(ctx: MeshContext | None):
    """Inside, the batches are this rank's rows of the global batch: see
    `step_context`. A module global, not a thread's: the autograd engine
    runs a recomputed forward (`RECONVAT_VAT_REMAT`) on its own thread."""
    global _STEP
    prev = _STEP
    _STEP = ctx
    try:
        yield
    finally:
        _STEP = prev


def step_context() -> MeshContext | None:
    """The mesh of the data-parallel step in progress over more than one
    rank, else None."""
    return _STEP if _STEP is not None and _STEP.world > 1 else None


def batch_rows(batch: dict, ctx: MeshContext) -> dict:
    """This rank's rows of each array of `batch` (numpy or torch, on the
    host or not); label keys split along the batch only. Other keys
    (paths, crop offsets) pass through."""
    out = dict(batch)
    for k in BATCH_KEYS:
        if k not in batch:
            continue
        v = batch[k]
        n = v.shape[0]
        if n % ctx.world:
            raise ValueError(f"a batch of {n} rows does not divide over "
                             f"{ctx.world} ranks")
        per = n // ctx.world
        out[k] = v[ctx.rank * per:(ctx.rank + 1) * per]
    return out


def shard_batch(batch: dict, ctx: MeshContext) -> dict:
    """This rank's rows of the global batch, as tensors on its device."""
    out = batch_rows(batch, ctx)
    for k in BATCH_KEYS:
        if k in out:
            v = out[k]
            v = v if torch.is_tensor(v) else torch.from_numpy(
                np.ascontiguousarray(v))
            out[k] = v.to(ctx.device)
    return out


def _tensors_of(obj) -> list:
    """The tensors of a module (parameters, then buffers), of a train state
    (its optimizer's state), of a dict or list of tensors, or a tensor."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return [t.data for t in obj.parameters()] + list(obj.buffers())
    if hasattr(obj, "optimizer"):
        return [v for s in obj.optimizer.state.values() for v in s.values()
                if torch.is_tensor(v)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    return [t for v in obj for t in _tensors_of(v)]


def _flat(tensors: list, ctx: MeshContext, collective) -> None:
    """Run `collective(buffer)` in place on one flat buffer per dtype (on
    the rank's device, in the given order), and copy the result back into
    each tensor."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.cat([t.detach().reshape(-1).to(ctx.device)
                          for t in group])
        collective(flat)
        i = 0
        for t in group:
            n = t.numel()
            t.detach().copy_(flat[i:i + n].view_as(t))
            i += n


def replicate(obj, ctx: MeshContext):
    """Broadcast every tensor of `obj` (a module, a train state, a dict or
    list of tensors) from rank 0, in place; returns `obj`."""
    if ctx.world > 1:
        _flat(_tensors_of(obj), ctx, lambda b: dist.broadcast(b, 0))
    return obj


def all_reduce_mean(tensors, ctx: MeshContext) -> None:
    """Replace each tensor (in place) by its mean over the ranks: one
    all-reduce per dtype over a flat buffer in the given order, so every
    rank gets the same bits."""
    if ctx.world > 1:
        _flat(_tensors_of(tensors), ctx, lambda b: (
            dist.all_reduce(b), b.div_(ctx.world)))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward is the sum of the ranks' gradients
    (`torch.distributed.nn.functional.all_reduce`); each all-reduce, of
    the forward and of the backward, is a `batchnorm_moments` profiler
    span."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        with torch.profiler.record_function("batchnorm_moments"):
            dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def global_moments(mean: torch.Tensor, var: torch.Tensor,
                   ctx: MeshContext):
    """The global batch's per-channel mean and biased variance from each
    rank's own (over equal counts), differentiably. Each rank puts its
    (mean, var) in its row of a zero (world, 2, C) stack and one all-reduce
    sums the stacks: a sum with zeros is exact, so every rank holds the
    same rows bit for bit and combines them in the same order, by Chan's
    formula (the variance is the mean of the ranks' variances plus the
    variance of their means, with no E[x^2] - E[x]^2 cancellation)."""
    local = torch.stack([mean, var])[None]
    rows = torch.cat([local.new_zeros((ctx.rank,) + local.shape[1:]), local,
                      local.new_zeros((ctx.world - ctx.rank - 1,)
                                      + local.shape[1:])])
    rows = _AllReduceSum.apply(rows)
    means, variances = rows[:, 0], rows[:, 1]
    mean_g = means.mean(0)
    return mean_g, variances.mean(0) + (means - mean_g).square().mean(0)


def draw_rows(draw, shape, split: int | None = None) -> torch.Tensor:
    """`draw(shape)` (a seeded random tensor); inside a data-parallel step,
    `draw` of the global batch's shape, of which this rank keeps its rows,
    so each rank gets the rows the one-device step draws for them. With
    `split` the batch is two stacked parts, [:split] and [split:], each
    sharded over the ranks (VAT's batched chain), and the global draw is
    the two global parts stacked."""
    ctx = step_context()
    if ctx is None:
        return draw(tuple(shape))
    parts = [shape[0]] if split is None else [split, shape[0] - split]
    full = draw((sum(parts) * ctx.world,) + tuple(shape[1:]))
    rows, start = [], 0
    for n in parts:
        rows.append(full[start + ctx.rank * n:start + (ctx.rank + 1) * n])
        start += n * ctx.world
    return torch.cat(rows) if len(rows) > 1 else rows[0]
