"""ReconVAT in PyTorch: U-Net transcriber + reconstruction (counterpart of
`reconvat_tpu/models/reconvat.py:33-203, 396-419`, reference `UNet`,
`model/self_attention_VAT.py:929-1325`).

    spec (B,T,F,1) -> Spec2Roll: U-Net -> window-31 attention over bins
    -> linear -> sigmoid -> pianoroll (B,T,88)
    full forward: Roll2Spec(pianoroll) -> reconstruction (B,T,F,1)
                  Spec2Roll(reconstruction) -> pianoroll2

Submodule names match the reference state_dict, so the keys map one to one
onto the JAX variable tree (`weights.flax_to_torch`). Parameters and compute
are fp32; TF32 is switched off around the serving call.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from .. import constants as C
from ..nn.attention import MultiHeadAttention1D
from ..nn.unet import Decoder, Encoder
from ..ops.normalize import Normalization
from ..ops.spectrogram import make_frontend
from .common import make_log_norm_spec, transcribe_spec


def resolve_device(device=None) -> torch.device:
    """`device` as given, else CUDA; raises when CUDA is asked for (or
    defaulted to) and there is none. Never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@contextlib.contextmanager
def fp32_math():
    """Full-fp32 matmuls and convolutions on CUDA (cuDNN convolutions
    default to TF32), restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


class Spec2Roll(nn.Module):
    """Reference `Spec2Roll` (`model/self_attention_VAT.py:929-945`)."""

    def __init__(self, n_bins: int = C.N_BINS, complexity: int = 4):
        super().__init__()
        self.Unet1_encoder = Encoder()
        self.Unet1_decoder = Decoder(num_instruments=1)
        self.lstm1 = MultiHeadAttention1D(n_bins, n_bins * complexity,
                                          kernel_size=31, groups=complexity)
        self.linear1 = nn.Linear(n_bins * complexity, C.N_KEYS)

    def forward(self, x):
        """x (B, T, F, 1) -> (pianoroll (B, T, 88), attention)."""
        z, s, c = self.Unet1_encoder(x.permute(0, 3, 1, 2))
        y = self.Unet1_decoder(z, s, c)[:, 0]            # (B, T, F)
        h, a = self.lstm1(y)
        return torch.sigmoid(self.linear1(h)), a


class Roll2Spec(nn.Module):
    """Reference `Roll2Spec` (`model/self_attention_VAT.py:947-969`)."""

    def __init__(self, n_bins: int = C.N_BINS, complexity: int = 4):
        super().__init__()
        self.Unet2_encoder = Encoder()
        self.Unet2_decoder = Decoder(num_instruments=1)
        self.lstm2 = MultiHeadAttention1D(C.N_KEYS, n_bins * complexity,
                                          kernel_size=31, groups=4)
        self.linear2 = nn.Linear(n_bins * complexity, n_bins)

    def forward(self, x):
        """x (B, T, 88) -> (reconstruction (B, T, F, 1), attention)."""
        h, a = self.lstm2(x)
        spec = torch.sigmoid(self.linear2(h))            # (B, T, F)
        z, s, c = self.Unet2_encoder(spec[:, None])
        return self.Unet2_decoder(z, s, c).permute(0, 2, 3, 1), a


class UNet(nn.Module):
    """Reference `UNet` forward (`model/self_attention_VAT.py:1061-1086`)."""

    def __init__(self, n_bins: int = C.N_BINS, reconstruction: bool = True):
        super().__init__()
        self.reconstruction = reconstruction
        self.transcriber = Spec2Roll(n_bins)
        if reconstruction:
            self.reconstructor = Roll2Spec(n_bins)

    def forward(self, x):
        pianoroll, a = self.transcriber(x)
        if self.reconstruction:
            reconstruction, _ = self.reconstructor(pianoroll)
            pianoroll2, _ = self.transcriber(reconstruction)
            return reconstruction, pianoroll, pianoroll2, a
        return pianoroll, a


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init mirroring the JAX package's initializers: conv and linear
    weights Uniform(+-1/sqrt(fan_in)) (torch's default), biases zero,
    attention projections N(0, 2/fan_out), `rel` N(0, 1), BatchNorm at
    identity. Draws in `modules()` order from `generator`."""
    attn_linears = set()
    for m in module.modules():
        if isinstance(m, MultiHeadAttention1D):
            for lin in (m.W_k, m.W_q, m.W_v):
                lin.weight.normal_(0.0, float(np.sqrt(2.0 / lin.out_features)),
                                   generator=generator)
                attn_linears.add(lin)
            m.rel.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif (isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))
              and m not in attn_linears):
            # torch's fan_in: dim 1 of the weight times the kernel area
            # (ConvTranspose2d weights are (in, out, kh, kw))
            fan_in = m.weight[0].numel()
            m.weight.uniform_(-1.0 / np.sqrt(fan_in), 1.0 / np.sqrt(fan_in),
                              generator=generator)
            if m.bias is not None:
                m.bias.zero_()


class ReconVAT(UNet):
    """The flagship model with its signal chain (reference constructor,
    `model/self_attention_VAT.py:1015`). Built on CUDA unless `device` says
    otherwise; parameters from `seed` through a `torch.Generator`; eval
    mode (BatchNorm on running statistics)."""

    def __init__(self, log: bool = True, reconstruction: bool = True,
                 mode: str = "imagewise", seed: int = 0, device=None):
        device = resolve_device(device)
        frontend, n_bins = make_frontend("Mel")
        super().__init__(n_bins, reconstruction)
        self.frontend = frontend
        self.n_bins = n_bins
        self.log = log
        self.normalize = Normalization(mode)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.frontend.mel_basis.device

    def use_kernels(self, flag: bool) -> None:
        """Route the mel frontend and the attention cores through the CUDA
        kernels (True, the default) or their plain versions (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = flag

    def make_spec(self, audio, t_true=None):
        """audio (B, N) float in [-1, 1] -> normalized log-spec (B,T,F,1);
        drops the final sample (327680 samples -> 640 frames)."""
        return make_log_norm_spec(self, audio, t_true)[..., None]

    @torch.no_grad()
    def transcribe(self, audio, bucket_frames: int = 0):
        """Serving path (reference `UNet.transcribe`,
        `model/self_attention_VAT.py:1293-1314`): onset roll == frame roll.

        Only the first-pass transcriber runs: the reference computes the
        reconstruction chain and discards it (under jit the JAX package's
        compiler removes it), so its result cannot reach the output.
        bucket_frames > 0 pads the clip to a frame-bucket boundary, masks
        the normalization statistics to the true frames and trims the
        padded tail."""
        with fp32_math():
            spec, t_true = transcribe_spec(self, audio, bucket_frames)
            pianoroll, _ = self.transcriber(spec[..., None])
        if bucket_frames:
            pianoroll = pianoroll[:, :t_true]
        return {"onset": pianoroll, "frame": pianoroll}
