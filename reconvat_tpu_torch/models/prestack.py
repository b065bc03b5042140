"""The Prestack baseline in PyTorch: a stride-1 U-Net "prestack" and a
ResNet-18 over each frame's 229 x 25 patch (counterpart of
`reconvat_tpu/models/prestack.py`, reference `Prestack_Model`,
`model/Unet_prestack.py:113-176`).

All T patches of a clip run as one batch of B x T images, as in the JAX
package. Module names give the reference's state_dict keys:
`prestack_model.0` is the U-Net (`Unet1_encoder`, `Unet1_decoder`),
`prestack_model.1` torchvision's resnet18 graph with a 1-channel `conv1`
and an 88-way `fc`. `compute_dtype='bfloat16'` runs the convolutions in
bf16; BatchNorm, the pooled features, `fc` and the sigmoid stay fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C
from ..nn.layers import Linear
from ..nn.precision import resolve_compute_dtype
from ..nn.unet import BATCHNORM_EPS, BatchNorm2d, Conv2d, Decoder, Encoder
from ..ops.spectrogram import make_frontend
from .base import FrameSpecModel, resolve_device
from .common import frame_mask
from .losses import binary_cross_entropy

PATCH = 25


class BasicBlock(nn.Module):
    """torchvision's `BasicBlock`, with its submodule names. The 1 x 1
    `downsample` branch is built where `use_downsample` says, and where
    torchvision builds one when it is None: at a stride or a change of
    width."""

    def __init__(self, inp: int, out: int, stride: int = 1,
                 compute_dtype=None, use_downsample: bool | None = None):
        super().__init__()
        cd = dict(bias=False, compute_dtype=compute_dtype)
        self.conv1 = Conv2d(inp, out, 3, stride=stride, padding=1, **cd)
        self.bn1 = BatchNorm2d(out, eps=BATCHNORM_EPS)
        self.relu = nn.ReLU()
        self.conv2 = Conv2d(out, out, 3, padding=1, **cd)
        self.bn2 = BatchNorm2d(out, eps=BATCHNORM_EPS)
        if use_downsample is None:
            use_downsample = stride != 1 or inp != out
        self.downsample = (nn.Sequential(
            Conv2d(inp, out, 1, stride=stride, **cd),
            BatchNorm2d(out, eps=BATCHNORM_EPS)) if use_downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class ResNet18(nn.Module):
    """torchvision's resnet18 graph: conv 7x7/2 -> max-pool 3/2 -> four
    stages of two blocks (64/128/256/512) -> global average pool -> fc."""

    def __init__(self, num_classes: int = C.N_KEYS, compute_dtype=None):
        super().__init__()
        self.conv1 = Conv2d(1, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=compute_dtype)
        self.bn1 = BatchNorm2d(64, eps=BATCHNORM_EPS)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        widths = (64, 64, 128, 256, 512)
        for i in range(1, 5):
            stride = 1 if i == 1 else 2
            setattr(self, f"layer{i}", nn.Sequential(
                BasicBlock(widths[i - 1], widths[i], stride, compute_dtype),
                BasicBlock(widths[i], widths[i], 1, compute_dtype)))
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = Linear(512, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(self.avgpool(x).flatten(1))


class UNetPrestack(nn.Module):
    """The reference's prestack U-Net (`model/Unet_prestack.py:98-109`):
    the port's U-Net blocks with 3x3 stride-1 down- and upsampling."""

    def __init__(self, compute_dtype=None):
        super().__init__()
        kw = dict(ds_ksize=3, ds_stride=1, compute_dtype=compute_dtype)
        self.Unet1_encoder = Encoder(**kw)
        self.Unet1_decoder = Decoder(num_instruments=1, **kw)

    def forward(self, x):
        return self.Unet1_decoder(*self.Unet1_encoder(x))


class PrestackNet(nn.Module):
    """spec (B, T, F) -> logits (B, T, 88): the U-Net and the ResNet-18 on
    each frame's (F, 25) patch of the spectrogram padded by 12 frames each
    side; the sigmoid is applied by the caller."""

    def __init__(self, compute_dtype=None):
        super().__init__()
        cd = resolve_compute_dtype(compute_dtype)
        self.prestack_model = nn.Sequential(UNetPrestack(cd),
                                            ResNet18(C.N_KEYS, cd))

    def forward(self, spec):
        B, T, n_bins = spec.shape
        pad = PATCH // 2
        patches = F.pad(spec, (0, 0, pad, pad)).unfold(1, PATCH, 1)
        logits = self.prestack_model(patches.reshape(B * T, 1, n_bins,
                                                     PATCH))
        return logits.reshape(B, T, C.N_KEYS)


class Prestack(FrameSpecModel, PrestackNet):
    """Prestack with its signal chain (reference `Prestack_Model.
    run_on_batch`, `model/Unet_prestack.py:129-176`): supervised only, loss
    key 'loss/train_frame' in training and evaluation alike. Constructor
    keys as `ReconVAT`'s; `reconstruction` is taken and has no effect."""

    def __init__(self, log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", reconstruction: bool = False,
                 seed: int = 0, device=None, compute_dtype=None):
        device = resolve_device(device)
        frontend, n_bins = make_frontend(spec)
        super().__init__(compute_dtype)
        self._init_chain(frontend, n_bins, log, mode, None, seed, device)

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """batch_l {"audio", "frame"}; batch_ul, generator and vat are taken
        and unused. In training BatchNorm runs on the batch statistics of
        the B x T patches and updates its running statistics. Returns
        (predictions, losses, spec (B, T, F))."""
        self.check_batch_frames(batch_l["frame"].shape[1])
        self.train(train)
        mask = (None if t_true is None
                else frame_mask(t_true, batch_l["frame"].shape[1],
                                self.device))
        spec = self.make_spec(batch_l["audio"], t_true)
        frame = torch.sigmoid(self(spec))
        return ({"onset": frame, "frame": frame, "r_adv": None},
                {"loss/train_frame":
                 binary_cross_entropy(frame, batch_l["frame"], mask)}, spec)

    def _rolls(self, spec):
        frame = torch.sigmoid(self(spec))
        return frame, frame
