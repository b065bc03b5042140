"""The Thickstun translation-invariant baseline in PyTorch (counterpart of
`reconvat_tpu/models/thickstun.py`, reference `Thickstun`,
`model/Thickstun_model.py:9-73`).

The reference unfolds each frame into a 229 x 25 patch and runs a frequency
convolution (128 x (freq 128, time 1), stride 2 in frequency), a time
convolution (4096 x (time 25)) and a linear layer per patch. As the time
convolution covers exactly the 25-frame window, that is one fully
convolutional pass over the spectrogram padded by 12 frames each side, as
the JAX package runs it. The convolutions run on (B, 1, freq, time) with
the reference's weight layout (O, I, freq, time), so its state_dict loads
as it is. `compute_dtype='bfloat16'` runs both convolutions and the linear
layer (most of the FLOPs) in bf16; the sigmoid is fp32. Inside a
sequence-parallel step the 12 frames each side are the neighbouring
ranks' (`parallel.mesh.time_halo`, as many ranks as they span; zeros at
the clip's ends), and a rank's frames need only divide the crop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C
from ..nn.layers import Linear
from ..nn.precision import promote_fp32, resolve_compute_dtype
from ..nn.unet import Conv2d
from ..ops.spectrogram import make_frontend
from ..parallel import mesh as pmesh
from .base import FrameSpecModel, resolve_device
from .common import frame_mask
from .losses import binary_cross_entropy


# the reference's widths (`model/Thickstun_model.py:9-30`)
K_OUT, K2_OUT, FREQ_KERNEL, FREQ_STRIDE, TIME_KERNEL = 128, 4096, 128, 2, 25


class ThickstunNet(nn.Module):
    """spec (B, T, F) -> frame posteriogram (B, T, 88)."""

    def __init__(self, n_bins: int = C.N_BINS, compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=resolve_compute_dtype(compute_dtype))
        self.CNN_freq = Conv2d(1, K_OUT, (FREQ_KERNEL, 1),
                               stride=(FREQ_STRIDE, 1), **cd)
        self.CNN_time = Conv2d(K_OUT, K2_OUT, (1, TIME_KERNEL), **cd)
        n_freq = (n_bins - FREQ_KERNEL) // FREQ_STRIDE + 1
        self.linear = Linear(K2_OUT * n_freq, C.N_KEYS, bias=False, **cd)

    def forward(self, spec):
        pad = TIME_KERNEL // 2
        x = pmesh.time_halo(spec, pad, pad, pmesh.sp_context()).transpose(
            1, 2)[:, None]
        z2 = F.relu(self.CNN_freq(x))           # (B, 128, 51, T + 24)
        z3 = F.relu(self.CNN_time(z2))          # (B, 4096, 51, T)
        # channel-major flatten per frame (`Thickstun_model.py:34`)
        y = self.linear(z3.permute(0, 3, 1, 2).flatten(2))
        return torch.sigmoid(promote_fp32(y))


class Thickstun(FrameSpecModel, ThickstunNet):
    """Thickstun with its signal chain (reference `Thickstun.run_on_batch`,
    `model/Thickstun_model.py:37-73`): supervised only, no VAT. The loss
    key is 'loss/train_frame' in training and evaluation alike, as in the
    reference. Constructor keys as `ReconVAT`'s; `reconstruction` is taken
    and has no effect. Takes sequence parallelism at any frames that
    divide over the ranks (no time stride)."""

    SEQUENCE_PARALLEL = True
    SP_FRAME_MULTIPLE = 1

    def __init__(self, log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", reconstruction: bool = False,
                 seed: int = 0, device=None, compute_dtype=None):
        device = resolve_device(device)
        frontend, n_bins = make_frontend(spec)
        super().__init__(n_bins, compute_dtype)
        self._init_chain(frontend, n_bins, log, mode, None, seed, device)

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """batch_l {"audio", "frame"}; batch_ul, generator and vat are taken
        and unused. Returns (predictions, losses, spec (B, T, F))."""
        self.check_batch_frames(batch_l["frame"].shape[1])
        self.train(train)
        mask = (None if t_true is None
                else frame_mask(t_true, batch_l["frame"].shape[1],
                                self.device))
        spec = self.make_spec(batch_l["audio"], t_true)
        frame = self(spec)
        return ({"onset": frame, "frame": frame, "r_adv": None},
                {"loss/train_frame":
                 binary_cross_entropy(frame, batch_l["frame"], mask)}, spec)

    def _rolls(self, spec):
        frame = self(spec)
        return frame, frame
