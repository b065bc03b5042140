"""What the port's models share: the device rule, fp32 math, the seeded
init, and `TranscriptionModel`, the signal chain, VAT target, kernel switch
and reference-weight loader of a model built on it (`ReconVAT`,
`UNetOnset`; `FrameSpecModel`, its (B, T, F) spec and serving path, for
the Onsets-and-Frames family, Thickstun and Prestack).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch import nn

from ..nn.attention import MultiHeadAttention1D
from ..nn.layers import new_dropout_masks
from ..nn.unet import frozen_batch_stats, use_running_stats
from ..ops.normalize import Normalization
from ..parallel import mesh as pmesh
from ..vat import VATConfig
from .common import frame_mask, make_log_norm_spec, transcribe_spec


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


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init mirroring the JAX package's initializers: conv and linear
    weights Uniform(+-1/sqrt(fan_in)) (torch's default), biases zero,
    attention projections (1-D and 2-D) N(0, 2/fan_out) with zero biases,
    `rel`, `rel_t` and `rel_f` N(0, 1), BatchNorm and LayerNorm at
    identity, every LSTM weight and bias Uniform(+-1/sqrt(hidden)) (torch's
    default; the sum b_ih + b_hh is the JAX package's fused bias). Draws
    in `modules()` order from `generator`."""
    from .segmentation import MultiHeadAttention2D

    attn_linears = set()
    for m in module.modules():
        if isinstance(m, MultiHeadAttention1D):
            for lin in (m.W_k, m.W_q, m.W_v):
                lin.weight.normal_(0.0, float(np.sqrt(2.0 / lin.out_features)),
                                   generator=generator)
                if lin.bias is not None:
                    lin.bias.zero_()
                attn_linears.add(lin)
            if m.rel is not None:
                m.rel.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, MultiHeadAttention2D):
            for conv in (m.query_conv, m.key_conv, m.value_conv):
                conv.weight.normal_(
                    0.0, float(np.sqrt(2.0 / conv.out_channels)),
                    generator=generator)
                if conv.bias is not None:
                    conv.bias.zero_()
                attn_linears.add(conv)
            m.rel_t.normal_(0.0, 1.0, generator=generator)
            m.rel_f.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / np.sqrt(m.hidden_size)
            for w in m.parameters():
                w.uniform_(-bound, bound, generator=generator)
        elif (isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))
              and m not in attn_linears):
            # torch's fan_in: dim 1 of the weight times the kernel area
            # (ConvTranspose2d weights are (in, out, kh, kw))
            fan_in = m.weight[0].numel()
            m.weight.uniform_(-1.0 / np.sqrt(fan_in), 1.0 / np.sqrt(fan_in),
                              generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def read_state_dict(source):
    """(state_dict, a name for messages) of a torch `.pt` path (holding a
    state_dict or a module) or of a state_dict itself."""
    if isinstance(source, (str, os.PathLike)):
        obj = torch.load(source, map_location="cpu", weights_only=False)
    else:
        obj, source = source, "the state_dict"
    return (obj.state_dict() if hasattr(obj, "state_dict") else obj), source


class TranscriptionModel:
    """Mixin of an `nn.Module` network with its signal chain (the frontend
    of `make_frontend(spec)`, log, normalization). The class
    names its VAT target `vat_target(x)` (the transcriber alone: a roll, or
    a dict of rolls) and the reference state_dict's prefixes that have no
    counterpart here (`REFERENCE_ONLY`)."""

    REFERENCE_ONLY = ("spectrogram.", "normalize.", "vat_loss.")
    # the layers take the neighbouring ranks' frames under sequence
    # parallelism (the flagship, UNetOnset, Segmentation, Thickstun); the
    # families that the JAX package runs data-parallel only refuse it
    # (`_sp_frames`, and their training CLIs before any work,
    # `train.driver.check_settings`)
    SEQUENCE_PARALLEL = False
    # each sp rank's frames must be a multiple of this (the model's total
    # time stride; `parallel.mesh.check_sp_frames`)
    SP_FRAME_MULTIPLE = pmesh.SP_FRAME_MULTIPLE

    def _init_chain(self, frontend, n_bins, log, mode, vat_cfg, seed,
                    device, vat_chain="separate"):
        """Called after the network is built: the signal chain, VAT's
        configuration (its `norm_axis` is the bins axis of the family's
        `make_spec`), the seeded parameters, eval mode, the device."""
        if vat_chain not in ("separate", "batched"):
            raise ValueError(f"unknown vat_chain {vat_chain!r}")
        self.vat_chain = vat_chain
        self.frontend = frontend
        self.n_bins = n_bins
        self.log = log
        self.normalize = Normalization(mode)
        self.vat_cfg = vat_cfg
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def check_batch_frames(self, n_frames: int) -> None:
        """Raise ValueError for a training or evaluation batch whose labels
        have `n_frames` frames, where the frontend cannot label them: CFP
        drops the first and last STFT frame, so its spec has T - 2 frames
        where the labels have T. The JAX package fails there too (at the
        first product of the two); this raises before any work, and
        neither crops nor pads the labels."""
        from ..ops.spectrogram import CFP

        if isinstance(self.frontend, CFP):
            raise ValueError(
                f"spec='CFP' gives T - 2 = {n_frames - 2} spectrogram frames "
                f"for labels of T = {n_frames} frames (it drops the first "
                f"and last STFT frame): CFP serves (`transcribe`) but does "
                f"not train or evaluate, as in the JAX package")

    def _start(self, train: bool, generator, t_true, n_frames):
        """Start a `run_on_batch`: set the mode and, in training, new
        dropout masks from the step's generator (`nn/layers.SharedDropout`);
        returns (loss prefix, frame mask, a zero). Raises first for a batch
        the frontend cannot label (`check_batch_frames`)."""
        self.check_batch_frames(n_frames)
        self.train(train)
        if train:
            new_dropout_masks(self, generator)
        mask = (None if t_true is None
                else frame_mask(t_true, n_frames, self.device))
        return ("train" if train else "test", mask,
                torch.zeros((), device=self.device))

    def use_kernels(self, flag: bool) -> None:
        """Route the mel frontend and the attention cores through the CUDA
        kernels (True, the default) or their plain versions (False). The
        CQT and CFP frontends have no kernel (no `use_kernel`): with them
        the switch moves the attention cores alone. The models build their
        mel frontend at its defaults, which the kernel computes; a
        `MelSpectrogram` at settings it does not compute raises
        ValueError at True."""
        for m in self.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = flag

    @staticmethod
    def image_vat_cfg(xi, eps, kl_div) -> VATConfig:
        """VAT on the (B, T, F, 1) spec image of `make_spec`: the
        perturbation's per-vector L2 norm runs over the bins axis."""
        return VATConfig(xi=xi, eps=eps, kl_div=kl_div, norm_axis=2)

    def _sp_frames(self, spec, t_true):
        """Inside a sequence-parallel step (`parallel.mesh.sp_context`),
        this rank's frames of its rows' normalized spec: each rank
        computes the mel of its whole rows (the audio stays whole per row)
        and normalizes them by their own min/max, so the statistics are
        the whole clip's with no collective, then keeps its frames.
        Raises for a family whose layers take no halo, for frames that do
        not split into multiples of the model's `SP_FRAME_MULTIPLE`, and
        for t_true (the evaluation, which runs whole on every rank)."""
        ctx = pmesh.sp_context()
        if ctx is None:
            return spec
        if not self.SEQUENCE_PARALLEL:
            pmesh.refuse_sp(ctx.sp, type(self).__name__)
        if t_true is not None:
            raise ValueError("a padded clip (t_true) is evaluated whole on "
                             "every rank, not under sequence parallelism")
        pmesh.check_sp_frames(spec.shape[1], ctx.sp, self.SP_FRAME_MULTIPLE)
        return pmesh.sp_frames(spec, ctx, dim=1)

    def make_spec(self, audio, t_true=None):
        """audio (B, N) float in [-1, 1] -> normalized log-spec (B,T,F,1);
        drops the final sample (327680 samples -> 640 frames). Inside a
        sequence-parallel step, this rank's frames of it (`_sp_frames`)."""
        return self._sp_frames(make_log_norm_spec(self, audio, t_true),
                               t_true)[..., None]

    def _transcriber_fn(self, train: bool, stats=None):
        """The VAT target: `vat_target` with BatchNorm in `train` mode
        (batch statistics) or eval mode (running statistics, or the
        `running_stats` copies `stats`) and the running statistics left
        unchanged, the model's mode restored after each call. Each call
        sets this up itself, so a recompute in the outer backward
        (`RECONVAT_VAT_REMAT=1`) runs as the first pass did."""
        def fn(x):
            was = self.training
            self.train(train)
            try:
                with frozen_batch_stats(self), use_running_stats(self,
                                                                 stats):
                    return self.vat_target(x)
            finally:
                self.train(was)
        return fn

    def load_reference_weights(self, source):
        """Load a torch `.pt` of the reference's `state_dict` names (a
        released checkpoint, or `weights.flax_to_torch` of a JAX tree), or
        such a state_dict itself, onto this model. The file may hold a
        state_dict or a module. Entries under `REFERENCE_ONLY` have no
        counterpart and are skipped; any other missing or unexpected key
        raises before a weight is changed."""
        obj, source = read_state_dict(source)
        own = self.state_dict().keys()
        missing = [k for k in own if k not in obj]
        unexpected = [k for k in obj
                      if k not in own and not k.startswith(self.REFERENCE_ONLY)]
        if missing or unexpected:
            raise ValueError(f"weights of {source} do not fit the model: "
                             f"missing {missing}, unexpected {unexpected}")
        self.load_state_dict({k: obj[k] for k in own}, strict=True)


class FrameSpecModel(TranscriptionModel):
    """A `TranscriptionModel` on the (B, T, F) spec (the Onsets-and-Frames
    family, Thickstun, Prestack), with the serving path over `_rolls`."""

    def make_spec(self, audio, t_true=None):
        """audio (B, N) -> normalized log-spec (B, T, F); inside a
        sequence-parallel step, this rank's frames of it (`_sp_frames`)."""
        return self._sp_frames(make_log_norm_spec(self, audio, t_true),
                               t_true)

    def _rolls(self, spec):
        """(onset, frame) rolls of the eval-mode forward; a model with one
        roll returns it twice."""
        raise NotImplementedError

    @torch.no_grad()
    def transcribe(self, audio, bucket_frames: int = 0):
        """Serving path: the eval-mode forward's onset and frame rolls.
        bucket_frames > 0 pads the clip to a frame-bucket boundary, masks
        the normalization statistics to the true frames and trims the
        padded tail."""
        self.eval()
        with fp32_math():
            spec, t_true = transcribe_spec(self, audio, bucket_frames)
            onset, frame = self._rolls(spec)
        if bucket_frames:
            onset, frame = onset[:, :t_true], frame[:, :t_true]
        return {"onset": onset, "frame": frame}
