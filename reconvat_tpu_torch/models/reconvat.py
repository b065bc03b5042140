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

import torch
from torch import nn

from .. import constants as C
from ..nn.attention import MultiHeadAttention1D
from ..nn.precision import promote_fp32, resolve_compute_dtype
from ..nn.unet import Decoder, Encoder, frozen_batch_stats, running_stats
from ..ops.spectrogram import make_frontend
from ..vat import vat_loss
# fp32_math and init_parameters are imported from here by other modules
from .base import (TranscriptionModel, fp32_math, init_parameters,  # noqa: F401
                   resolve_device)
from .common import frame_mask, transcribe_spec, transcribe_streaming
from .losses import binary_cross_entropy, mse_loss


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


class ReconVAT(TranscriptionModel, UNet):
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
    both. `spec` picks the frontend (`make_frontend`: 'Mel' 229 bins, 'CQT'
    176, 'CFP' 386), and every width follows its bins: the attention runs
    4 heads of Dh = n_bins. CFP serves only: `run_on_batch` refuses it
    (`check_batch_frames`)."""

    def __init__(self, log: bool = True, reconstruction: bool = True,
                 mode: str = "imagewise", spec: str = "Mel",
                 xi: float = 1e-6, eps: float = 2.0, kl_div: bool = False,
                 seed: int = 0, device=None, compute_dtype=None,
                 vat_chain: str = "separate"):
        device = resolve_device(device)
        frontend, n_bins = make_frontend(spec)
        super().__init__(n_bins, reconstruction, compute_dtype)
        self._init_chain(frontend, n_bins, log, mode,
                         self.image_vat_cfg(xi, eps, kl_div), seed, device,
                         vat_chain)

    vat_target = UNet.transcribe_frames
    SEQUENCE_PARALLEL = True

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
        the second transcriber pass as it is, and every loss is fp32.

        Inside a sequence-parallel step (`parallel.mesh.sharded_step`, sp
        > 1) the frame labels are this rank's frames, `make_spec` keeps
        this rank's frames of the spec and the layers take their halos.
        VAT's perturbation is normalized per frame over the bins
        (`norm_axis=2`), so it needs no reduction over the ranks. Every
        loss is this rank's mean over equal counts, which the step
        averages over the ranks into the global mean. The power
        iteration's gradient on a rank is that of the sum of the ranks'
        means (each halo returns its rows' gradients to their owner):
        world x the one-process gradient, whose scale the per-frame
        normalization removes."""
        self.check_batch_frames(batch_l["frame"].shape[1])
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
        self.check_batch_frames(batch_l["frame"].shape[1])
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
