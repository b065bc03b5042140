"""UNet_Onset in PyTorch: the ReconVAT skeleton with a 2-channel decoder
driving separate onset and frame heads (counterpart of
`reconvat_tpu/models/unet_onset.py`, reference `model/UNet_onset.py:
270-553`).

    spec (B,T,F,1) -> U-Net -> (B,T,F,2): channel 0 -> linear_onset ->
    sigmoid -> onset (B,T,88); channel 1 -> linear_feature; their concat
    (176) -> Stack (window-31 attention, 6 heads of 128 -> linear) ->
    sigmoid -> pianoroll (B,T,88)
    full forward: Roll2Spec(pianoroll) -> reconstruction (B,T,F,1)
                  OnsetSpec2Roll(reconstruction) -> pianoroll2, onset2

Submodule names match the reference state_dict. The reference also holds
`transcriber.lstm1`/`linear1` weights its forward never uses; this port has
no such modules, and `load_reference_weights` skips those keys. VAT attacks
the transcriber's {frame, onset} pair (`transcribe_heads`). In bf16
(`compute_dtype='bfloat16'`) the U-Net and the attention run as in
`ReconVAT`, and the three dense heads are fp32 on promoted inputs, as the
JAX package's `Dense(dtype=None)` heads are.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from ..nn.attention import MultiHeadAttention1D
from ..nn.precision import promote_fp32, resolve_compute_dtype
from ..nn.unet import Decoder, Encoder, running_stats
from ..ops.spectrogram import make_frontend
from ..vat import vat_loss
from .base import TranscriptionModel, fp32_math, resolve_device
from .common import (frame_mask, transcribe_spec, transcribe_streaming,
                     tree_map)
from .losses import binary_cross_entropy, mse_loss
from .reconvat import Roll2Spec


class Stack(nn.Module):
    """Reference `Stack` (`model/UNet_onset.py:270-282`): attention, a
    dense layer, and dropout in train mode."""

    def __init__(self, input_size: int = 2 * C.N_KEYS,
                 hidden_dim: int = 768, attn_size: int = 31,
                 attn_group: int = 4, output_dim: int = C.N_KEYS,
                 dropout: float = 0.5, compute_dtype=None):
        super().__init__()
        self.attention = MultiHeadAttention1D(
            input_size, hidden_dim, kernel_size=attn_size, groups=attn_group,
            compute_dtype=compute_dtype)
        self.linear = nn.Linear(hidden_dim, output_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        x, a = self.attention(x)
        return self.dropout(self.linear(promote_fp32(x))), a


class OnsetSpec2Roll(nn.Module):
    """Reference onset-variant `Spec2Roll` (`model/UNet_onset.py:284-315`)."""

    def __init__(self, n_bins: int = C.N_BINS, compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.Unet1_encoder = Encoder(**cd)
        self.Unet1_decoder = Decoder(num_instruments=2, **cd)
        self.linear_onset = nn.Linear(n_bins, C.N_KEYS)
        self.linear_feature = nn.Linear(n_bins, C.N_KEYS)
        self.combine_stack = Stack(2 * C.N_KEYS, hidden_dim=768,
                                   attn_size=31, attn_group=6,
                                   output_dim=C.N_KEYS, dropout=0.0, **cd)

    def forward(self, x):
        """x (B, T, F, 1) -> (pianoroll, onset (B, T, 88), attention)."""
        z, s, c = self.Unet1_encoder(x.permute(0, 3, 1, 2))
        y = promote_fp32(self.Unet1_decoder(z, s, c))      # (B, 2, T, F)
        onset = torch.sigmoid(self.linear_onset(y[:, 0]))
        feat = self.linear_feature(y[:, 1])
        h, a = self.combine_stack(torch.cat([onset, feat], dim=-1))
        return torch.sigmoid(h), onset, a


class OnsetUNet(nn.Module):
    """Reference `UNet_Onset` forward (`model/UNet_onset.py:380-405`).
    compute_dtype is None or 'bfloat16', resolved here once."""

    def __init__(self, n_bins: int = C.N_BINS, reconstruction: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.reconstruction = reconstruction
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.transcriber = OnsetSpec2Roll(n_bins,
                                          compute_dtype=self.compute_dtype)
        if reconstruction:
            self.reconstructor = Roll2Spec(n_bins,
                                           compute_dtype=self.compute_dtype)

    def forward(self, x):
        pianoroll, onset, a = self.transcriber(x)
        if self.reconstruction:
            reconstruction, _ = self.reconstructor(pianoroll)
            pianoroll2, onset2, _ = self.transcriber(reconstruction)
            return reconstruction, pianoroll, onset, pianoroll2, onset2, a
        return pianoroll, onset, a

    def transcribe_heads(self, x):
        """The VAT target: the transcriber's {frame, onset} pair
        (reference `model/UNet_onset.py:118,132`)."""
        pianoroll, onset, _ = self.transcriber(x)
        return {"frame": pianoroll, "onset": onset}


class UNetOnset(TranscriptionModel, OnsetUNet):
    """UNet_Onset with its signal chain (reference `model/UNet_onset.py:
    409-542`), with `ReconVAT`'s constructor keys and conventions: built on
    CUDA unless `device` says otherwise, parameters from `seed`, eval mode
    at start, `vat_chain` 'separate' or 'batched', compute_dtype None or
    'bfloat16', `spec` the frontend (CFP refused by `run_on_batch`). VAT
    perturbs the spec against the sum of the frame and onset BCEs (their
    sorted-key order, as the JAX package sums a dict's leaves) and reports
    an LDS loss per head."""

    REFERENCE_ONLY = TranscriptionModel.REFERENCE_ONLY + (
        "transcriber.lstm1.", "transcriber.linear1.")

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

    vat_target = OnsetUNet.transcribe_heads
    SEQUENCE_PARALLEL = True

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """Counterpart of the JAX package's `UNetOnset.run_on_batch`
        (reference `model/UNet_onset.py:409-495`), with the conventions of
        `ReconVAT.run_on_batch`: batch_l {"audio", "frame", "onset"},
        batch_ul {"audio"} or None, on the model's device; returns
        (predictions, losses, spec (B, T, F)). The LDS losses are per head
        (`_LDS_l_frame`, `_LDS_l_onset`, and `_LDS_ul_*` in train mode).
        VAT's perturbation is normalized per frame over the bins
        (`norm_axis=2` of the (B, T, F, 1) spec image, as the flagship's),
        so a sequence-parallel step needs no reduction of it; the rest of
        the sp contract is `ReconVAT.run_on_batch`'s."""
        self.check_batch_frames(batch_l["frame"].shape[1])
        self.train(train)
        prefix = "train" if train else "test"
        frame_label, onset_label = batch_l["frame"], batch_l["onset"]
        mask = (None if t_true is None
                else frame_mask(t_true, frame_label.shape[1], self.device))
        zero = torch.zeros((), device=self.device)
        batched = (self.vat_chain == "batched" and vat
                   and batch_ul is not None)
        # the batched chain reads the running statistics of before this
        # step's update, as the JAX package's chain reads the state's
        stats = running_stats(self) if batched else None

        lds_ul = {"frame": zero, "onset": zero}
        r_norm_ul = zero
        if batch_ul is not None:
            spec_ul = self.make_spec(batch_ul["audio"])
            if not batched:
                lds_ul, _, rn = vat_loss(self._transcriber_fn(train),
                                         spec_ul, generator, self.vat_cfg)
                r_norm_ul = rn.abs().mean()

        spec = self.make_spec(batch_l["audio"], t_true)
        out = self(spec)

        lds_l = {"frame": zero, "onset": zero}
        r_adv, r_norm_l = None, zero
        if vat:
            # the supervised forward's clean {frame, onset} is the VAT
            # reference (the transcriber has no dropout on this path)
            head = out[1:3] if self.reconstruction else out[:2]
            y_ref = {"frame": head[0], "onset": head[1]}
            if batched:
                b = spec.shape[0]
                fn = self._transcriber_fn(False, stats)
                with torch.no_grad():
                    y_ref_ul = fn(spec_ul)
                (lds_l, lds_ul), r_adv, rn = vat_loss(
                    fn, torch.cat([spec, spec_ul]), generator, self.vat_cfg,
                    y_ref=tree_map(lambda a, u: torch.cat([a, u]), y_ref,
                                   y_ref_ul),
                    split=b)
                r_norm_l, r_norm_ul = rn[:b].abs().mean(), rn[b:].abs().mean()
                r_adv = r_adv[:b, ..., 0]
            else:
                lds_l, r_adv, rn = vat_loss(self._transcriber_fn(train),
                                            spec, generator, self.vat_cfg,
                                            y_ref=y_ref)
                r_adv = r_adv[..., 0]
                r_norm_l = rn.abs().mean()

        def bce(pred, label):
            return binary_cross_entropy(pred, label, mask)

        if self.reconstruction:
            reconstruction, pianoroll, onset, pianoroll2, onset2, a = out
            predictions = {
                "frame": pianoroll, "onset": onset,
                "frame2": pianoroll2, "onset2": onset2,
                "attention": a, "r_adv": r_adv,
                "reconstruction": reconstruction,
            }
            losses = {
                f"loss/{prefix}_reconstruction":
                    mse_loss(reconstruction[..., 0], spec[..., 0].detach(),
                             mask),
                f"loss/{prefix}_frame": bce(pianoroll, frame_label),
                f"loss/{prefix}_frame2": bce(pianoroll2, frame_label),
                f"loss/{prefix}_onset": bce(onset, onset_label),
                f"loss/{prefix}_onset2": bce(onset2, onset_label),
            }
        else:
            pianoroll, onset, a = out
            predictions = {"onset": onset, "frame": pianoroll,
                           "r_adv": r_adv, "attention": a}
            losses = {f"loss/{prefix}_frame": bce(pianoroll, frame_label),
                      f"loss/{prefix}_onset": bce(onset, onset_label)}
        losses[f"loss/{prefix}_LDS_l_frame"] = lds_l["frame"]
        losses[f"loss/{prefix}_LDS_l_onset"] = lds_l["onset"]
        if train:
            losses[f"loss/{prefix}_LDS_ul_frame"] = lds_ul["frame"]
            losses[f"loss/{prefix}_LDS_ul_onset"] = lds_ul["onset"]
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
            losses[f"loss/{prefix}_r_norm_ul"] = r_norm_ul
        else:
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
        return predictions, losses, spec[..., 0]

    @torch.no_grad()
    def transcribe(self, audio, bucket_frames: int = 0):
        """Serving path (reference `UNet_Onset.transcribe`): distinct
        onset and frame rolls of the transcriber's first pass (the
        reconstruction chain cannot reach them). bucket_frames > 0 pads
        the clip to a frame-bucket boundary, masks the normalization
        statistics to the true frames and trims the padded tail."""
        self.eval()
        with fp32_math():
            spec, t_true = transcribe_spec(self, audio, bucket_frames)
            pianoroll, onset, _ = self.transcriber(spec[..., None])
        if bucket_frames:
            pianoroll, onset = pianoroll[:, :t_true], onset[:, :t_true]
        return {"onset": onset, "frame": pianoroll}

    @torch.no_grad()
    def transcribe_streaming(self, audio, window_frames: int = 640,
                             halo_frames: int = 128,
                             windows_per_batch: int = 1, mesh_ctx=None,
                             pipeline_depth: int = 3):
        """Bounded-memory transcription in haloed windows
        (`models/common.transcribe_streaming`, counterpart of
        `reconvat_tpu/models/unet_onset.py:315-333`): {"onset", "frame"},
        each a (B, t_true, 88) fp32 tensor on the host."""
        self.eval()
        with fp32_math():
            return transcribe_streaming(
                self, self.transcribe_heads, audio, window_frames,
                halo_frames, windows_per_batch, mesh_ctx, pipeline_depth)
