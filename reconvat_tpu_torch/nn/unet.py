"""U-Net encoder/decoder blocks (PyTorch counterpart of the NHWC path of
`reconvat_tpu/nn/unet.py`, reference `model/self_attention_VAT.py:844-926`).

Activations are NCHW with time on H and frequency on W. Residual double-conv
encoder blocks with a 1x1 skip and strided downsampling; transpose-conv
decoder blocks whose upsampler is driven to an explicit target size
(`output_size=`). Inside a sequence-parallel step (time over the sp ranks)
each 3x3 stride-1 convolution and transposed convolution takes a
one-frame halo of the neighbouring ranks (`time_halo`); the 2x2 stride-2
down- and upsamplers need none when a rank's frames are a multiple of 16,
the U-Net's total stride. Submodule names match the reference state_dict
names. The frequency-folded layout of the JAX package is a TPU lane device
and is not ported: it equals this layout.

`compute_dtype=torch.bfloat16` follows the JAX package's mixed precision:
each convolution and transposed convolution casts its input, weight and
bias to bf16 and returns bf16; BatchNorm promotes its input to fp32 and
returns fp32, so the activations and the residual sum run in fp32 and the
next convolution casts back. Parameters and BatchNorm statistics stay fp32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as pmesh
from .precision import cast, promote_fp32

BATCHNORM_EPS = 1e-5
LEAKY_SLOPE = 0.01


def _act(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `compute_dtype` (the JAX package's
    `TorchConv`): input, weight and bias cast to it, output in it. None
    is `nn.Conv2d` itself. `time_halo=True` (a stride-1 convolution whose
    time padding is p) takes p frames of the neighbouring ranks on the time
    axis (H) inside a sequence-parallel step (`parallel.mesh.time_halo`)
    in place of its zero padding there; the frequency padding stays."""

    def __init__(self, *args, compute_dtype=None, time_halo=False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.time_halo = time_halo

    def forward(self, x):
        ctx = pmesh.sp_context() if self.time_halo else None
        if ctx is None:
            return self._conv_forward(*cast(self.compute_dtype, x,
                                            self.weight, self.bias))
        h = self.padding[0]
        x, w, b = cast(self.compute_dtype,
                       pmesh.time_halo(x, h, h, ctx, dim=2), self.weight,
                       self.bias)
        return F.conv2d(x, w, b, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in `compute_dtype` (the JAX package's
    `TorchConvTranspose`), with `output_size` resolved as torch does.
    `time_halo=True` (stride 1, kernel k, time padding p: the convolution
    of padding k - 1 - p) takes k - 1 - p frames of the neighbouring ranks
    on the time axis inside a sequence-parallel step, its time padding
    then p + that halo, so that the output keeps this rank's frames."""

    def __init__(self, *args, compute_dtype=None, time_halo=False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.time_halo = time_halo

    def forward(self, x, output_size=None):
        output_padding = self._output_padding(
            x, output_size, self.stride, self.padding, self.kernel_size, 2,
            self.dilation)
        padding = self.padding
        ctx = pmesh.sp_context() if self.time_halo else None
        if ctx is not None:
            h = self.kernel_size[0] - 1 - self.padding[0]
            x = pmesh.time_halo(x, h, h, ctx, dim=2)
            padding = (self.padding[0] + h, self.padding[1])
        x, w, b = cast(self.compute_dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, padding,
                                  output_padding, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` with the JAX package's training semantics
    (`reconvat_tpu/nn/unet.py:MaskedBatchNorm`): in training it normalizes
    with the biased batch variance and updates `running_var` with that
    biased variance too (torch's own layer updates it with the unbiased
    one); momentum 0.1 on both sides. Inside a sharded step over several
    ranks (`parallel.mesh.sharded_step`) the batch statistics are the
    global batch's over all dp x sp ranks (`_global_batch`).
    `update_stats = False` (see `frozen_batch_stats`) keeps the batch
    statistics but discards the running-statistics update. Eval mode is
    `nn.BatchNorm2d`'s. A bf16 input is promoted to fp32 first, and the
    output is fp32."""

    update_stats = True

    def forward(self, x):
        x = promote_fp32(x)
        if not self.training:
            return super().forward(x)
        ctx = pmesh.step_context()
        if ctx is not None:
            return self._global_batch(x, ctx)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_batch(self, x, ctx):
        """Training inside a data-parallel step: normalize by the global
        batch's mean and biased variance (`parallel.mesh.global_moments`,
        whose all-reduce carries the gradient through the statistics to
        every rank), as the JAX package's BatchNorm sees a sharded batch;
        the running statistics move by the same global moments on every
        rank."""
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        mean, var = pmesh.global_moments(mean, var, ctx)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


@contextlib.contextmanager
def frozen_batch_stats(model: nn.Module):
    """Within the block, train-mode `BatchNorm2d` layers of `model` use
    batch statistics and leave their running statistics unchanged (the
    JAX package's VAT chains, which discard the batch-stat updates)."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m in layers:
            m.update_stats = True


def running_stats(model: nn.Module) -> list:
    """Copies of the (running_mean, running_var) of each `BatchNorm2d` of
    `model`, in `modules()` order."""
    return [(m.running_mean.clone(), m.running_var.clone())
            for m in model.modules() if isinstance(m, BatchNorm2d)]


@contextlib.contextmanager
def use_running_stats(model: nn.Module, stats):
    """Within the block, eval-mode `BatchNorm2d` layers of `model` read the
    `running_stats` copies `stats` in place of their own buffers (which
    this step may already have updated in place); None changes nothing."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    own = [(m.running_mean, m.running_var) for m in layers]
    if stats is not None:
        for m, (mean, var) in zip(layers, stats):
            m.running_mean, m.running_var = mean, var
    try:
        yield
    finally:
        for m, (mean, var) in zip(layers, own):
            m.running_mean, m.running_var = mean, var


class EncBlock(nn.Module):
    """Reference `block` (`model/self_attention_VAT.py:844-859`)."""

    def __init__(self, inp: int, out: int, ksize=3, pad=1, ds_ksize=2,
                 ds_stride=2, compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.conv1 = Conv2d(inp, out, ksize, padding=pad, time_halo=True,
                            **cd)
        self.bn1 = BatchNorm2d(out, eps=BATCHNORM_EPS)
        self.conv2 = Conv2d(out, out, ksize, padding=pad, time_halo=True,
                            **cd)
        self.bn2 = BatchNorm2d(out, eps=BATCHNORM_EPS)
        self.skip = Conv2d(inp, out, 1, **cd)
        self.ds = Conv2d(out, out, ds_ksize, stride=ds_stride, **cd)

    def forward(self, x):
        x11 = _act(self.bn1(self.conv1(x)))
        # fp32 + the skip's compute dtype: fp32, as in the JAX package
        x12 = _act(self.bn2(self.conv2(x11))) + self.skip(x)
        return self.ds(x12), tuple(x12.shape[2:])  # (time, freq) pre-ds


class DBlock(nn.Module):
    """Reference `d_block` (`model/self_attention_VAT.py:861-882`)."""

    def __init__(self, inp: int, out: int, is_last: bool, ksize=3, pad=1,
                 ds_ksize=2, ds_stride=2, compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        mid = inp // 2
        self.is_last = is_last
        self.conv2d = ConvTranspose2d(inp, mid, ksize, 1, pad,
                                      time_halo=True, **cd)
        self.bn2d = BatchNorm2d(mid, eps=BATCHNORM_EPS)
        self.conv1d = ConvTranspose2d(mid, out, ksize, 1, pad,
                                      time_halo=True, **cd)
        if is_last:
            us_ch = inp
        else:
            self.bn1d = BatchNorm2d(out, eps=BATCHNORM_EPS)
            us_ch = inp - out
        self.us = ConvTranspose2d(us_ch, us_ch, ds_ksize, ds_stride, **cd)

    def forward(self, x, size, skip):
        x = self.us(x, output_size=size)
        if not self.is_last:
            x = torch.cat([x, skip], dim=1)
        x = _act(self.bn2d(self.conv2d(x)))
        if self.is_last:
            return self.conv1d(x)
        return _act(self.bn1d(self.conv1d(x)))


class Encoder(nn.Module):
    """Reference `Encoder` (`model/self_attention_VAT.py:884-906`)."""

    def __init__(self, ds_ksize=2, ds_stride=2, compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        kw = dict(ds_ksize=ds_ksize, ds_stride=ds_stride, **cd)
        self.block1 = EncBlock(1, 16, **kw)
        self.block2 = EncBlock(16, 32, **kw)
        self.block3 = EncBlock(32, 64, **kw)
        self.block4 = EncBlock(64, 128, **kw)
        halo = dict(padding=1, time_halo=True, **cd)
        self.conv1 = Conv2d(64, 64, 3, **halo)
        self.conv2 = Conv2d(32, 32, 3, **halo)
        self.conv3 = Conv2d(16, 16, 3, **halo)

    def forward(self, x):
        """x (B, 1, T, F) -> (bottleneck, pre-downsample sizes, skips)."""
        x1, s1 = self.block1(x)
        x2, s2 = self.block2(x1)
        x3, s3 = self.block3(x2)
        x4, s4 = self.block4(x3)
        return x4, [s1, s2, s3, s4], [self.conv1(x3), self.conv2(x2),
                                      self.conv3(x1), x1]


class Decoder(nn.Module):
    """Reference `Decoder` (`model/self_attention_VAT.py:908-926`); output
    width `num_instruments`, no final activation."""

    def __init__(self, num_instruments: int = 1, ds_ksize=2, ds_stride=2,
                 compute_dtype=None):
        super().__init__()
        kw = dict(ds_ksize=ds_ksize, ds_stride=ds_stride,
                  compute_dtype=compute_dtype)
        self.d_block1 = DBlock(192, 64, False, **kw)
        self.d_block2 = DBlock(96, 32, False, **kw)
        self.d_block3 = DBlock(48, 16, False, **kw)
        self.d_block4 = DBlock(16, num_instruments, True, **kw)

    def forward(self, x, s, c):
        x = self.d_block1(x, s[3], c[0])
        x = self.d_block2(x, s[2], c[1])
        x = self.d_block3(x, s[1], c[2])
        return self.d_block4(x, s[0], None)
