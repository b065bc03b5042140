"""Device mesh: data parallelism and sequence parallelism (the port's
counterpart of `reconvat_tpu/parallel/mesh.py`).

The JAX package lays a (dcn,) dp x sp mesh over its devices, shards the
batch over dp and the time axis over sp, replicates the parameters and
lets GSPMD insert the collectives. Here a mesh is dp x sp processes, one
rank per device (`parallel/distributed.py`), rank `dp_index * sp +
sp_index` as JAX's `reshape(dp, sp)` lays the devices out (an sp group is
consecutive ranks), and the collectives are explicit:

- `shard_batch`: each rank keeps its rows of the global batch (every rank
  loads the same global batch from the same seeded loaders) and, along
  the time axis of the label keys, its sp group's share of the frames;
  audio stays whole per row, as the JAX package's `shard_batch` keeps it;
- `replicate`: parameters, buffers and optimizer state broadcast from rank
  0;
- inside a sharded step (`sharded_step`): train-mode BatchNorm takes the
  global batch's moments over all dp x sp ranks (`global_moments`, a
  differentiable all-reduce), every random draw of the step takes the
  global batch's shape from the step's generator and keeps this rank's
  rows and frames (`draw_rows`), so that the step draws what the
  one-device step draws; under sp the models' `make_spec` keeps this
  rank's frames (`sp_frames`) and each layer that reaches across frames
  takes the neighbouring ranks' frames (`time_halo`, as many ranks' as
  the halo spans: the U-Nets' 3x3 convolutions one frame, the window-31
  attention 15, Segmentation's TF-SAME pads, transposed convolutions and
  17 x 17 windows, Thickstun's 25-frame kernel 12); after the backward
  the gradients and the returned losses are all-reduced to their means
  over all ranks (`all_reduce_mean`).

Averaging per-rank means gives the global mean because every rank holds
the same number of rows and frames (the loaders' crops are equal in
length; a loss divided by a mask's sum would need the counts reduced too,
and no training loss is). Collectives use only what both gloo and NCCL
take on CUDA tensors, all-reduce and broadcast: a halo is a zero-stack
all-reduce over the sp group, as the BatchNorm moments are over all ranks.
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
LABEL_KEYS = ("onset", "offset", "frame", "velocity")   # (B, T, ...)
# the U-Nets' and Segmentation's total time stride: by default the frames
# of each sp rank must be a multiple (a model's `SP_FRAME_MULTIPLE`)
SP_FRAME_MULTIPLE = 16

_ACTIVE = None          # the MeshContext of `activate`
_STEP = None            # the MeshContext of the step in progress


def refuse_sp(sp: int, what: str) -> None:
    """Raise NotImplementedError for `mesh_sp` > 1 in `what` (a model
    family or CLI that runs data-parallel only)."""
    if sp > 1:
        raise NotImplementedError(
            f"mesh_sp={sp}: {what} runs data-parallel only (mesh_dp). The "
            f"JAX package runs the Onsets-and-Frames family and the "
            f"attention models (BiLSTMs scanned over time) and Prestack (a "
            f"patch per frame) data-parallel only by design; sequence "
            f"parallelism takes the flagship, UNetOnset, Segmentation and "
            f"Thickstun")


def check_sp_frames(frames: int, sp: int,
                    multiple: int = SP_FRAME_MULTIPLE) -> None:
    """Raise ValueError unless `frames` split over `sp` ranks into equal
    shares that are multiples of `multiple` (the model's total time
    stride, which keeps each rank's strided grids anchored like the whole
    clip's; 1 for a model without one)."""
    if sp > 1 and (frames % sp or (frames // sp) % multiple):
        raise ValueError(
            f"{frames} frames do not split over mesh_sp={sp} ranks into "
            f"multiples of {multiple} frames (the model's total time "
            f"stride): adjust sequence_length or mesh_sp")


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The dp x sp mesh as this rank sees it: its rank, the number of
    ranks, its device, the sp ranks of a row group (`sp`; rank = dp_rank *
    sp + sp_rank) and the process group of this rank's sp group (None when
    sp is 1 or the sp group is the whole world)."""
    rank: int
    world: int
    device: torch.device
    sp: int = 1
    sp_group: object = dataclasses.field(default=None, compare=False)

    @property
    def dp(self) -> int:
        return self.world // self.sp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp


def make_mesh(dp: int | None = None, sp: int = 1,
              device=None) -> MeshContext:
    """This rank's view of a dp x sp mesh over the process group (dp: the
    group's size over sp by default) on `device` (`distributed.
    initialize`'s by default). Under sp every rank creates every sp group
    (consecutive ranks), in the same order, as `dist.new_group` asks."""
    world = distributed.world_size()
    sp = max(int(sp or 1), 1)
    if world % sp or dp not in (None, world // sp):
        raise ValueError(f"a mesh of dp={dp} x sp={sp} does not fit the "
                         f"process group's {world} ranks")
    group = None
    if 1 < sp < world:
        for d in range(world // sp):
            g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == distributed.rank() // sp:
                group = g
    return MeshContext(distributed.rank(), world, torch.device(
        device if device is not None else distributed.device()), sp, group)


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
    """Inside, the batches are this rank's rows (and, under sp, frames) of
    the global batch: see `step_context`. A module global, not a thread's:
    the autograd engine runs a recomputed forward (`RECONVAT_VAT_REMAT`)
    on its own thread."""
    global _STEP
    prev = _STEP
    _STEP = ctx
    try:
        yield
    finally:
        _STEP = prev


def step_context() -> MeshContext | None:
    """The mesh of the sharded step in progress over more than one rank,
    else None."""
    return _STEP if _STEP is not None and _STEP.world > 1 else None


def sp_context() -> MeshContext | None:
    """The mesh of the sharded step in progress when it splits the time
    axis (sp > 1), else None."""
    ctx = step_context()
    return ctx if ctx is not None and ctx.sp > 1 else None


def _time_share(n: int, ctx: MeshContext) -> slice:
    if n % ctx.sp:
        raise ValueError(f"{n} frames do not divide over {ctx.sp} sp ranks")
    per = n // ctx.sp
    return slice(ctx.sp_rank * per, (ctx.sp_rank + 1) * per)


def sp_frames(x: torch.Tensor, ctx: MeshContext | None,
              dim: int = 1) -> torch.Tensor:
    """This rank's share of the frames (axis `dim`) of a whole clip's
    tensor; x itself without sp."""
    if ctx is None or ctx.sp == 1:
        return x
    return x.narrow(dim, _time_share(x.shape[dim], ctx).start,
                    x.shape[dim] // ctx.sp)


def batch_rows(batch: dict, ctx: MeshContext) -> dict:
    """This rank's rows of each array of `batch` (numpy or torch, on the
    host or not): every key's rows split over dp; the label keys' frames
    (axis 1) also over sp, the audio whole per row. Other keys (paths,
    crop offsets) pass through."""
    out = dict(batch)
    for k in BATCH_KEYS:
        if k not in batch:
            continue
        v = batch[k]
        n = v.shape[0]
        if n % ctx.dp:
            raise ValueError(f"a batch of {n} rows does not divide over "
                             f"{ctx.dp} data-parallel ranks")
        per = n // ctx.dp
        v = v[ctx.dp_rank * per:(ctx.dp_rank + 1) * per]
        if k in LABEL_KEYS and ctx.sp > 1:
            v = v[:, _time_share(v.shape[1], ctx)]
        out[k] = v
    return out


def shard_batch(batch: dict, ctx: MeshContext) -> dict:
    """This rank's share of the global batch (`batch_rows`), as tensors on
    its device."""
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


def _zero_stack(local: torch.Tensor, index: int, n: int) -> torch.Tensor:
    """`local` in row `index` of an (n, ...) stack of zeros."""
    rest = local.shape
    return torch.cat([local.new_zeros((index,) + rest), local[None],
                      local.new_zeros((n - index - 1,) + rest)])


def global_moments(mean: torch.Tensor, var: torch.Tensor,
                   ctx: MeshContext):
    """The global batch's per-channel mean and biased variance from each
    rank's own (over equal counts, all dp x sp ranks), differentiably.
    Each rank puts its (mean, var) in its row of a zero (world, 2, C)
    stack and one all-reduce sums the stacks: a sum with zeros is exact,
    so every rank holds the same rows bit for bit and combines them in the
    same order, by Chan's formula (the variance is the mean of the ranks'
    variances plus the variance of their means, with no E[x^2] - E[x]^2
    cancellation)."""
    rows = _AllReduceSum.apply(
        _zero_stack(torch.stack([mean, var]), ctx.rank, ctx.world))
    means, variances = rows[:, 0], rows[:, 1]
    mean_g = means.mean(0)
    return mean_g, variances.mean(0) + (means - mean_g).square().mean(0)


def time_halo(x: torch.Tensor, before: int, after: int,
              ctx: MeshContext | None, dim: int = 1) -> torch.Tensor:
    """x (this rank's frames on axis `dim`) with the `before` frames of the
    whole clip that precede them in front and the `after` that follow
    them behind, zeros past the clip's ends: the slice of the whole clip
    zero-padded by (before, after) that this rank's frames need,
    differentiably (the halo rows' gradients go back to the ranks that
    own them and are added there). A halo longer than a rank's t frames
    reads as many ranks as it spans. One zero-stack all-reduce over the
    sp group each way (a `halo_exchange` profiler span): each rank
    writes its last min(before, t) and first min(after, t) frames into
    its row of an (sp, ...) stack (in the backward, its halo rows'
    gradients). `ctx` None (no sequence-parallel step, `sp_context`): x
    zero-padded by (before, after)."""
    if ctx is None:
        pad = [0, 0] * (x.dim() - dim - 1) + [before, after]
        return torch.nn.functional.pad(x, pad)
    return _TimeHalo.apply(x, before, after, ctx, dim)


def _span(halo: int, t: int) -> int:
    """The number of ranks of t frames that a halo of `halo` frames
    reads."""
    return -(-halo // t)


class _TimeHalo(torch.autograd.Function):

    @staticmethod
    def forward(fctx, x, before, after, ctx, dim):
        fctx.args = (before, after, ctx, dim)
        n, i, t = ctx.sp, ctx.sp_rank, x.shape[dim]
        nb, na = min(before, t), min(after, t)
        edges = torch.cat([x.narrow(dim, t - nb, nb), x.narrow(dim, 0, na)],
                          dim)
        rows = _exchange(_zero_stack(edges, i, n), ctx)

        def part(j, start, length):      # rank j's edge frames, or zeros
            if 0 <= j < n:
                return rows[j].narrow(dim, start, length)
            return torch.zeros_like(edges.narrow(dim, start, length))

        head = [part(j, 0, nb) for j in range(i - _span(before, t), i)]
        tail = [part(j, nb, na)
                for j in range(i + 1, i + 1 + _span(after, t))]
        head = torch.cat(head, dim) if head else edges.narrow(dim, 0, 0)
        tail = torch.cat(tail, dim) if tail else edges.narrow(dim, 0, 0)
        return torch.cat([head.narrow(dim, head.shape[dim] - before, before),
                          x, tail.narrow(dim, 0, after)], dim)

    @staticmethod
    def backward(fctx, grad):
        before, after, ctx, dim = fctx.args
        n, i = ctx.sp, ctx.sp_rank
        t = grad.shape[dim] - before - after
        rows = _exchange(_zero_stack(torch.cat(
            [grad.narrow(dim, 0, before), grad.narrow(dim, before + t, after)],
            dim), i, n), ctx)
        dx = grad.narrow(dim, before, t).clone(
            memory_format=torch.contiguous_format)
        # the next ranks' halos in front cover my last frames: rank i + k's
        # front halo starts k * t - before frames past my first frame
        for k in range(1, min(_span(before, t), n - 1 - i) + 1):
            start = k * t - before
            lo = max(start, 0)
            dx.narrow(dim, lo, t - lo).add_(
                rows[i + k].narrow(dim, lo - start, t - lo))
        # the previous ranks' halos behind cover my first frames: rank
        # i - k's back halo starts (k - 1) * t frames before my first frame
        for k in range(1, min(_span(after, t), i) + 1):
            skip = (k - 1) * t
            m = min(after - skip, t)
            dx.narrow(dim, 0, m).add_(
                rows[i - k].narrow(dim, before + skip, m))
        return dx, None, None, None, None


def _exchange(stack: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """The sum of every sp rank's zero stack (exact: one row each)."""
    wide = stack.dtype in (torch.bfloat16, torch.float16)
    y = stack.float() if wide else stack.contiguous()
    with torch.profiler.record_function("halo_exchange"):
        dist.all_reduce(y, group=ctx.sp_group)
    return y.to(stack.dtype) if wide else y


def draw_rows(draw, shape, split: int | None = None,
              time_dim: int = 1) -> torch.Tensor:
    """`draw(shape)` (a seeded random tensor); inside a sharded step,
    `draw` of the global batch's shape, of which this rank keeps its rows
    and, under sp, its frames (axis `time_dim`: 1 in a (B, T, ...) draw, 2
    in an NCHW one), so each rank gets what the one-device step draws for
    them. With `split` the batch is two stacked parts, [:split] and
    [split:], each sharded over the dp ranks (VAT's batched chain), and
    the global draw is the two global parts stacked."""
    ctx = step_context()
    if ctx is None:
        return draw(tuple(shape))
    parts = [shape[0]] if split is None else [split, shape[0] - split]
    whole = list(shape)
    whole[0] = sum(parts) * ctx.dp
    whole[time_dim] *= ctx.sp
    full = draw(tuple(whole))
    rows, start = [], 0
    for n in parts:
        rows.append(full[start + ctx.dp_rank * n:
                         start + (ctx.dp_rank + 1) * n])
        start += n * ctx.dp
    return sp_frames(torch.cat(rows) if len(rows) > 1 else rows[0], ctx,
                     time_dim)
