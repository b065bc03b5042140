"""ReconVAT in PyTorch: U-Net transcriber + reconstruction (counterpart of
`reconvat_tpu/models/reconvat.py:33-203, 396-419`, reference `UNet`,
`model/self_attention_VAT.py:929-1325`).

    spec (B,T,F,1) -> Spec2Roll: U-Net -> window-31 attention over bins
    -> linear -> sigmoid -> pianoroll (B,T,88)
    full forward: Roll2Spec(pianoroll) -> reconstruction (B,T,F,1)
                  Spec2Roll(reconstruction) -> pianoroll2

Submodule names match the reference state_dict, so the keys map one to one
onto the JAX variable tree (`weights.flax_to_torch`). Parameters are fp32.
Compute is fp32 by default, with TF32 switched off around the serving call
and the train step; `compute_dtype='bfloat16'` is the JAX package's mixed
precision: U-Net convolutions and attention projections in bf16, the
attention core (forward and backward) on bf16 operands, and the mel
frontend, BatchNorm, heads, posteriogram, losses and packing in fp32.
`run_on_batch` is the training batch contract (supervised losses,
reconstruction and VAT, in either compute dtype); `transcribe` the serving
path.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch import nn

from .. import constants as C
from ..nn.attention import MultiHeadAttention1D
from ..nn.precision import promote_fp32, resolve_compute_dtype
from ..nn.unet import (Decoder, Encoder, frozen_batch_stats, running_stats,
                       use_running_stats)
from ..ops.normalize import Normalization
from ..ops.spectrogram import make_frontend
from ..vat import VATConfig, vat_loss
from .common import (frame_mask, make_log_norm_spec, transcribe_spec,
                     transcribe_streaming)
from .losses import binary_cross_entropy, mse_loss


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
    default to TF32), restored on exit. cuDNN's benchmark and
    deterministic settings stay as the caller set them (`flags` would
    reset them to False)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn = torch.backends.cudnn
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


class Spec2Roll(nn.Module):
    """Reference `Spec2Roll` (`model/self_attention_VAT.py:929-945`)."""

    def __init__(self, n_bins: int = C.N_BINS, complexity: int = 4,
                 compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.Unet1_encoder = Encoder(**cd)
        self.Unet1_decoder = Decoder(num_instruments=1, **cd)
        self.lstm1 = MultiHeadAttention1D(n_bins, n_bins * complexity,
                                          kernel_size=31, groups=complexity,
                                          **cd)
        self.linear1 = nn.Linear(n_bins * complexity, C.N_KEYS)

    def forward(self, x):
        """x (B, T, F, 1) -> (pianoroll (B, T, 88), attention)."""
        z, s, c = self.Unet1_encoder(x.permute(0, 3, 1, 2))
        y = self.Unet1_decoder(z, s, c)[:, 0]            # (B, T, F)
        h, a = self.lstm1(y)
        # the head is fp32 on the attention output in either compute dtype
        return torch.sigmoid(self.linear1(promote_fp32(h))), a


class Roll2Spec(nn.Module):
    """Reference `Roll2Spec` (`model/self_attention_VAT.py:947-969`)."""

    def __init__(self, n_bins: int = C.N_BINS, complexity: int = 4,
                 compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.Unet2_encoder = Encoder(**cd)
        self.Unet2_decoder = Decoder(num_instruments=1, **cd)
        self.lstm2 = MultiHeadAttention1D(C.N_KEYS, n_bins * complexity,
                                          kernel_size=31, groups=4, **cd)
        self.linear2 = nn.Linear(n_bins * complexity, n_bins)

    def forward(self, x):
        """x (B, T, 88) -> (reconstruction (B, T, F, 1), attention); the
        reconstruction is in the compute dtype."""
        h, a = self.lstm2(x)
        spec = torch.sigmoid(self.linear2(promote_fp32(h)))     # (B, T, F)
        z, s, c = self.Unet2_encoder(spec[:, None])
        return self.Unet2_decoder(z, s, c).permute(0, 2, 3, 1), a


class UNet(nn.Module):
    """Reference `UNet` forward (`model/self_attention_VAT.py:1061-1086`).
    compute_dtype is None or 'bfloat16', resolved here once; the modules
    under it take the torch dtype."""

    def __init__(self, n_bins: int = C.N_BINS, reconstruction: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.reconstruction = reconstruction
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.transcriber = Spec2Roll(n_bins,
                                     compute_dtype=self.compute_dtype)
        if reconstruction:
            self.reconstructor = Roll2Spec(n_bins,
                                           compute_dtype=self.compute_dtype)

    def forward(self, x):
        pianoroll, a = self.transcriber(x)
        if self.reconstruction:
            reconstruction, _ = self.reconstructor(pianoroll)
            pianoroll2, _ = self.transcriber(reconstruction)
            return reconstruction, pianoroll, pianoroll2, a
        return pianoroll, a

    def transcribe_frames(self, x):
        """Transcriber-only path that VAT attacks (reference
        `UNet_VAT.forward`, `model/self_attention_VAT.py:162-202`)."""
        return self.transcriber(x)[0]


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
    otherwise; parameters from `seed` through a `torch.Generator`. It
    starts in eval mode (BatchNorm on running statistics); `run_on_batch`
    sets the mode its `train` argument asks for and `transcribe` sets eval
    mode. xi, eps and kl_div configure VAT as in the JAX package.
    vat_chain 'separate' runs the reference's two train-mode VAT chains
    (labeled, unlabeled); 'batched' one chain over [labeled; unlabeled]
    with BatchNorm on its running statistics (the JAX package's
    `ReconVAT.vat_chain`).
    compute_dtype None is fp32, 'bfloat16' the JAX package's mixed
    precision, for serving and training alike; the parameters are fp32 in
    both."""

    def __init__(self, log: bool = True, reconstruction: bool = True,
                 mode: str = "imagewise", xi: float = 1e-6,
                 eps: float = 2.0, kl_div: bool = False, seed: int = 0,
                 device=None, compute_dtype=None,
                 vat_chain: str = "separate"):
        device = resolve_device(device)
        if vat_chain not in ("separate", "batched"):
            raise ValueError(f"unknown vat_chain {vat_chain!r}")
        frontend, n_bins = make_frontend("Mel")
        super().__init__(n_bins, reconstruction, compute_dtype)
        self.vat_chain = vat_chain
        self.frontend = frontend
        self.n_bins = n_bins
        self.log = log
        self.normalize = Normalization(mode)
        # the spec image is (B, T, F, 1): the perturbation's per-vector L2
        # norm runs over the bins axis
        self.vat_cfg = VATConfig(xi=xi, eps=eps, kl_div=kl_div, norm_axis=2)
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

    def _transcriber_fn(self, train: bool, stats=None):
        """The VAT target: the transcriber alone, with BatchNorm in
        `train` mode (batch statistics) or eval mode (running statistics,
        or the `running_stats` copies `stats`) and the running statistics
        left unchanged, the model's mode restored after each call. Each
        call sets this up itself, so a recompute in the outer backward
        (`RECONVAT_VAT_REMAT=1`) runs as the first pass did."""
        def fn(x):
            was = self.training
            self.train(train)
            try:
                with frozen_batch_stats(self), use_running_stats(self,
                                                                 stats):
                    return self.transcribe_frames(x)
            finally:
                self.train(was)
        return fn

    def _supervised_losses(self, out, spec, frame_label, mask, prefix):
        """(predictions without r_adv, losses) of the full forward's
        output against the labels; with a (B, T) mask each loss is the
        (B,) vector of the rows' own means."""
        if self.reconstruction:
            reconstruction, pianoroll, pianoroll2, a = out
            predictions = {
                "onset": pianoroll, "frame": pianoroll,
                "frame2": pianoroll2, "onset2": pianoroll2,
                "attention": a, "reconstruction": reconstruction,
            }
            losses = {
                f"loss/{prefix}_reconstruction":
                    mse_loss(reconstruction[..., 0], spec[..., 0].detach(),
                             mask),
                f"loss/{prefix}_frame":
                    binary_cross_entropy(pianoroll, frame_label, mask),
                f"loss/{prefix}_frame2":
                    binary_cross_entropy(pianoroll2, frame_label, mask),
            }
        else:
            pianoroll, a = out
            predictions = {"onset": pianoroll, "frame": pianoroll,
                           "attention": a}
            losses = {f"loss/{prefix}_frame":
                      binary_cross_entropy(pianoroll, frame_label, mask)}
        return predictions, losses

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """Counterpart of the JAX package's `ReconVAT.run_on_batch`
        (reference `UNet.run_on_batch`,
        `model/self_attention_VAT.py:1090-1203`).

        batch_l {"audio" (B, N), "frame" (B, T, 88)}, batch_ul {"audio"}
        or None, on the model's device. Returns (predictions, losses, spec
        (B, T, F)). `train` selects BatchNorm's mode (batch statistics, with
        the running statistics updated in place by the supervised forward
        only) and the loss names. The VAT directions are drawn from
        `generator` (on the model's device): with `vat_chain='separate'`
        the unlabeled chain's first, then the labeled chain's; with
        'batched' one (2B, ...) draw for the chain over [labeled;
        unlabeled], whose BatchNorm runs on the running statistics of
        before this call and whose unlabeled reference is an eval-mode
        forward. t_true masks
        the spec normalization and the losses to the true frames of a
        padded clip; a (B,) tensor masks each row by its own, and every
        loss is then the (B,) vector of the rows' means. Grad mode must be
        on when `vat` or `batch_ul` is given (the power iteration
        differentiates).

        In bf16 the spec and the VAT direction stay fp32 (the first
        convolution casts the perturbed spec, as the JAX package does), the
        reconstruction is bf16 and enters the MSE against the fp32 spec and
        the second transcriber pass as it is, and every loss is fp32."""
        self.train(train)
        prefix = "train" if train else "test"
        frame_label = batch_l["frame"]
        mask = (None if t_true is None
                else frame_mask(t_true, frame_label.shape[1], self.device))
        zero = torch.zeros((), device=self.device)
        batched = (self.vat_chain == "batched" and vat
                   and batch_ul is not None)
        # the batched chain reads the running statistics of before this
        # step's update, as the JAX package's chain reads the state's
        stats = running_stats(self) if batched else None

        lds_ul, r_norm_ul = zero, zero
        if batch_ul is not None:
            spec_ul = self.make_spec(batch_ul["audio"])
            if not batched:
                lds_ul, _, rn = vat_loss(self._transcriber_fn(train),
                                         spec_ul, generator, self.vat_cfg)
                r_norm_ul = rn.abs().mean()

        spec = self.make_spec(batch_l["audio"], t_true)
        out = self(spec)

        lds_l, r_adv, r_norm_l = zero, None, zero
        if vat:
            # the supervised forward's clean prediction on this spec is the
            # VAT reference (the JAX package's y_ref reuse)
            y_ref = out[1] if self.reconstruction else out[0]
            if batched:
                b = spec.shape[0]
                fn = self._transcriber_fn(False, stats)
                with torch.no_grad():
                    y_ref_ul = fn(spec_ul)
                (lds_l, lds_ul), r_adv, rn = vat_loss(
                    fn, torch.cat([spec, spec_ul]), generator, self.vat_cfg,
                    y_ref=torch.cat([y_ref, y_ref_ul]), split=b)
                r_norm_l, r_norm_ul = rn[:b].abs().mean(), rn[b:].abs().mean()
                r_adv = r_adv[:b, ..., 0]
            else:
                lds_l, r_adv, rn = vat_loss(self._transcriber_fn(train),
                                            spec, generator, self.vat_cfg,
                                            y_ref=y_ref)
                r_adv = r_adv[..., 0]
                r_norm_l = rn.abs().mean()

        predictions, losses = self._supervised_losses(out, spec, frame_label,
                                                      mask, prefix)
        predictions["r_adv"] = r_adv
        losses[f"loss/{prefix}_LDS_l"] = lds_l
        if train:
            losses[f"loss/{prefix}_LDS_ul"] = lds_ul
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
            losses[f"loss/{prefix}_r_norm_ul"] = r_norm_ul
        else:
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
        return predictions, losses, spec[..., 0]

    def run_on_batch_application(self, batch_l, batch_ul=None,
                                 generator=None, vat: bool = False,
                                 train: bool = True):
        """Application-domain semi-supervised fine-tuning (counterpart of
        `reconvat_tpu/models/reconvat.py:328-394`, reference
        `UNet.run_on_batch_application`, `model/self_attention_VAT.py:
        1205-1291`): `run_on_batch` plus the unlabeled consistency term
        `loss/ul_consistency_wrt1` = BCE(frame2_ul, frame_ul detached)
        between the two transcriber passes over the unlabeled audio. That
        full forward leaves the running statistics unchanged, as the JAX
        package discards its batch-stat update. Needs reconstruction."""
        if not self.reconstruction:
            raise ValueError("run_on_batch_application requires "
                             "reconstruction=True")
        self.train(train)
        prefix = "train" if train else "test"
        zero = torch.zeros((), device=self.device)

        lds_ul, r_norm_ul, ul_consistency = zero, zero, zero
        if batch_ul is not None:
            spec_ul = self.make_spec(batch_ul["audio"])
            with frozen_batch_stats(self):
                _, ul_pianoroll, ul_pianoroll2, _ = self(spec_ul)
            lds_ul, _, rn = vat_loss(self._transcriber_fn(train), spec_ul,
                                     generator, self.vat_cfg,
                                     y_ref=ul_pianoroll)
            r_norm_ul = rn.abs().mean()
            ul_consistency = binary_cross_entropy(ul_pianoroll2,
                                                  ul_pianoroll.detach())

        spec = self.make_spec(batch_l["audio"])
        out = self(spec)

        lds_l, r_adv, r_norm_l = zero, None, zero
        if vat:
            lds_l, r_adv, rn = vat_loss(self._transcriber_fn(train), spec,
                                        generator, self.vat_cfg,
                                        y_ref=out[1])
            r_adv = r_adv[..., 0]
            r_norm_l = rn.abs().mean()
        predictions, losses = self._supervised_losses(
            out, spec, batch_l["frame"], None, prefix)
        predictions["r_adv"] = r_adv
        losses[f"loss/{prefix}_LDS_l"] = lds_l
        if train:
            losses["loss/ul_consistency_wrt1"] = ul_consistency
            losses[f"loss/{prefix}_LDS_ul"] = lds_ul
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
            losses[f"loss/{prefix}_r_norm_ul"] = r_norm_ul
        else:
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
        return predictions, losses, spec[..., 0]

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
        self.eval()
        with fp32_math():
            spec, t_true = transcribe_spec(self, audio, bucket_frames)
            pianoroll, _ = self.transcriber(spec[..., None])
        if bucket_frames:
            pianoroll = pianoroll[:, :t_true]
        return {"onset": pianoroll, "frame": pianoroll}

    @torch.no_grad()
    def transcribe_streaming(self, audio, window_frames: int = 640,
                             halo_frames: int = 128,
                             windows_per_batch: int = 1, mesh_ctx=None,
                             pipeline_depth: int = 3):
        """Bounded-memory transcription for hour-scale recordings
        (counterpart of `reconvat_tpu/models/reconvat.py:421-443`): haloed
        fixed-shape windows of the transcriber's first pass with
        song-global normalization statistics; device memory is bounded by
        the window, whatever the song's length
        (`models/common.transcribe_streaming`). Returns onset == frame,
        a (B, t_true, 88) fp32 tensor on the host."""
        self.eval()
        with fp32_math():
            roll = transcribe_streaming(
                self, lambda spec: self.transcriber(spec)[0], audio,
                window_frames, halo_frames, windows_per_batch, mesh_ctx,
                pipeline_depth)
        return {"onset": roll, "frame": roll}

    def load_reference_weights(self, source):
        """Load a torch `.pt` of the reference's `state_dict` names (a
        released checkpoint, or `weights.flax_to_torch` of a JAX tree), or
        such a state_dict itself, onto this model (counterpart of
        `reconvat_tpu/models/reconvat.py:445-456`). The file may hold a
        state_dict or a module. Entries under `spectrogram.` (the
        reference's frontend buffers), `normalize.` and `vat_loss.` have no
        counterpart and are skipped; any other missing or unexpected key
        raises before a weight is changed."""
        if isinstance(source, (str, os.PathLike)):
            obj = torch.load(source, map_location="cpu", weights_only=False)
        else:
            obj, source = source, "the state_dict"
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        own = self.state_dict().keys()
        skipped = ("spectrogram.", "normalize.", "vat_loss.")
        missing = [k for k in own if k not in obj]
        unexpected = [k for k in obj
                      if k not in own and not k.startswith(skipped)]
        if missing or unexpected:
            raise ValueError(f"weights of {source} do not fit the model: "
                             f"missing {missing}, unexpected {unexpected}")
        self.load_state_dict({k: obj[k] for k in own}, strict=True)
