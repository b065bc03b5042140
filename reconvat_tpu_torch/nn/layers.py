"""Conv trunk and recurrent stacks of the Onsets-and-Frames family (PyTorch
counterpart of `reconvat_tpu/nn/layers.py`, reference `ConvStack` /
`Onset_Stack` / `Combine_Stack`, `model/onset_frame_VAT.py:321-414`).

Submodule names are the reference's, so its state_dict loads with
strict=True: `cnn.0/1/3/4/8/9` and `fc.0` in `ConvStack`, `sequence_model`
and `linear` in the stacks.

- `BiLSTM` is `torch.nn.LSTM(bidirectional=True, batch_first=True)`, which
  stays in training mode whatever the model's mode (the reference's
  workaround, `model/onset_frame_VAT.py:370-381`): cuDNN's RNN backward
  raises in eval mode, and VAT differentiates through the LSTM in eval mode
  too (`train/loop.tensorboard_log`). One layer without dropout computes
  the same thing in either mode. Its recurrence runs in fp32 (or the
  float64 of a float64 model) on an input promoted to it.
- `SharedDropout` draws one mask per input shape from the generator that
  the model hands it for the step (`new_dropout_masks`), and reuses it in
  every call until the next step: the JAX package's Flax dropout draws the
  same mask in each apply of one step (one `dropout` key), so the VAT
  chains and the supervised forward see the same masks.
- With `compute_dtype=torch.bfloat16` the convolutions and `ConvStack`'s
  FC layer run in bf16 (the JAX package's `dtype`); BatchNorm, the LSTM
  and the stacks' linear heads run in fp32 on promoted inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as pmesh
from .precision import cast, promote_fp32
from .unet import BATCHNORM_EPS, BatchNorm2d, Conv2d


class Linear(nn.Linear):
    """`nn.Linear` with the JAX package's `Dense(dtype=...)`: input, weight
    and bias cast to `compute_dtype`; with None, promoted to their common
    type (a bf16 input meets fp32 parameters in fp32)."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or torch.promote_types(x.dtype,
                                                          self.weight.dtype)
        return F.linear(*cast(dtype, x, self.weight, self.bias))


class SharedDropout(nn.Module):
    """Dropout whose mask is drawn once per input shape and step: kept
    elements are scaled by 1/(1 - p), as Flax's `Dropout` does. The masks
    come from `generator` (seed 0 when it is None, as the JAX package's
    default key) and hold until `new_masks`. Inside a sharded step each
    rank keeps its rows of the global batch's mask and, under sequence
    parallelism, its frames on axis `time_dim` (`parallel.mesh.
    draw_rows`: 1 for a (B, T, ...) input, 2 for an NCHW one)."""

    def __init__(self, p: float, time_dim: int = 1):
        super().__init__()
        self.p = p
        self.time_dim = time_dim
        self.new_masks(None)

    def new_masks(self, generator) -> None:
        self.generator = generator
        self.masks = {}

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = self.masks.get(tuple(x.shape))
        if keep is None:
            g = self.generator
            if g is None:
                g = self.generator = torch.Generator(x.device).manual_seed(0)
            keep = pmesh.draw_rows(lambda shape: torch.rand(
                shape, generator=g, device=g.device), x.shape,
                time_dim=self.time_dim) < 1.0 - self.p
            keep = self.masks[tuple(x.shape)] = keep.to(x.device)
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def new_dropout_masks(model: nn.Module, generator) -> None:
    """Start a step: every `SharedDropout` of `model` draws new masks from
    `generator` at its next call."""
    for m in model.modules():
        if isinstance(m, SharedDropout):
            m.new_masks(generator)


class ConvStack(nn.Module):
    """O&F conv trunk: three 3x3 convolutions with BatchNorm, two (1, 2)
    frequency max-pools and dropout, then the FC layer (reference
    `ConvStack`, `model/onset_frame_VAT.py:321-355`). (B, T, F) ->
    (B, T, output_features), in `compute_dtype` (fp32 by default)."""

    def __init__(self, input_features: int, output_features: int,
                 compute_dtype=None):
        super().__init__()
        of = output_features
        cd = dict(compute_dtype=compute_dtype)

        def bn(c):
            return BatchNorm2d(c, eps=BATCHNORM_EPS)

        self.cnn = nn.Sequential(
            Conv2d(1, of // 16, 3, padding=1, **cd), bn(of // 16), nn.ReLU(),
            Conv2d(of // 16, of // 16, 3, padding=1, **cd), bn(of // 16),
            nn.ReLU(), nn.MaxPool2d((1, 2)), SharedDropout(0.25),
            Conv2d(of // 16, of // 8, 3, padding=1, **cd), bn(of // 8),
            nn.ReLU(), nn.MaxPool2d((1, 2)), SharedDropout(0.25))
        self.fc = nn.Sequential(
            Linear((of // 8) * (input_features // 4), of, **cd),
            SharedDropout(0.5))

    def forward(self, spec):
        x = self.cnn(spec[:, None])                   # (B, C, T, F / 4)
        # channel-major flatten, as the reference's transpose(1, 2)
        return self.fc(x.transpose(1, 2).flatten(-2))


class BiLSTM(nn.LSTM):
    """Bidirectional single-layer LSTM, (B, T, F) -> (B, T, 2 * hidden),
    always in training mode (see the module's docstring)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True)

    def train(self, mode: bool = True):
        return super().train(True)

    def forward(self, x):
        return super().forward(promote_fp32(x))[0]


class OnsetStack(nn.Module):
    """Reference `Onset_Stack` (`model/onset_frame_VAT.py:357-387`): conv
    trunk (in `compute_dtype`), BiLSTM and linear head (fp32), sigmoid.
    With `use_lstm=False` there is no `sequence_model` and the head reads
    the trunk's model_size features."""

    def __init__(self, input_features: int, model_size: int,
                 output_features: int, use_lstm: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.convstack = ConvStack(input_features, model_size,
                                   compute_dtype=compute_dtype)
        self.sequence_model = (BiLSTM(model_size, model_size // 2)
                               if use_lstm else None)
        # the width the JAX package's `Dense` infers: both LSTM directions
        self.linear = Linear(2 * (model_size // 2) if use_lstm
                             else model_size, output_features)

    def forward(self, x):
        x = self.convstack(x)
        if self.sequence_model is not None:
            x = self.sequence_model(x)
        return torch.sigmoid(self.linear(x))


class CombineStack(nn.Module):
    """Reference `Combine_Stack` (`model/onset_frame_VAT.py:390-414`):
    BiLSTM, linear head, sigmoid, in fp32. With `use_lstm=False` there is
    no `sequence_model` and the head reads the input's input_features."""

    def __init__(self, input_features: int, model_size: int,
                 output_features: int, use_lstm: bool = True):
        super().__init__()
        self.sequence_model = (BiLSTM(input_features, model_size // 2)
                               if use_lstm else None)
        self.linear = Linear(2 * (model_size // 2) if use_lstm
                             else input_features, output_features)

    def forward(self, x):
        if self.sequence_model is not None:
            x = self.sequence_model(x)
        return torch.sigmoid(self.linear(x))

