"""The Onsets-and-Frames family in PyTorch: CNN + BiLSTM, with VAT
(counterpart of `reconvat_tpu/models/onsets_frames.py`, reference
`model/onset_frame_VAT.py`).

    OnsetsAndFrames (`OnsetsAndFrames_VAT_full`, :603-719): onset stack,
        frame stack (conv trunk -> linear -> sigmoid = activation), and a
        combined stack over cat[onset.detach(), activation] -> frame;
        VAT attacks the frame roll.
    FrameStackVAT (`Frame_stack_VAT`, :417-514): frame stack -> combined
        stack; VAT attacks {activation, frame} with the objective that
        `vat_mode` picks.
    OnsetStackVAT (`Onset_stack_VAT`, :516-600): onset stack alone; VAT
        without the clamp.

The spec is (B, T, F) and VAT normalizes its direction over the bins (the
last axis). Submodule names are the reference's (`frame_stack.0` the conv
trunk, `frame_stack.1` its linear head). `compute_dtype='bfloat16'` runs
the conv trunks in bf16; the LSTMs, heads and losses stay fp32. Dropout
draws its masks once per `run_on_batch` from the step's generator
(`nn/layers.SharedDropout`).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from ..nn.layers import CombineStack, ConvStack, Linear, OnsetStack
from ..nn.precision import resolve_compute_dtype
from ..ops.spectrogram import make_frontend
from ..vat import VATConfig, vat_loss
from .base import FrameSpecModel, resolve_device
from .losses import _masked_mean, binary_cross_entropy, mse_loss


class OnsetsAndFramesNet(nn.Module):
    """Reference `OnsetsAndFrames_VAT_full` forward (`model/onset_frame_VAT.
    py:627-635`): spec (B, T, F) -> (onset, activation, frame)."""

    def __init__(self, n_bins: int = C.N_BINS, model_complexity: int = 48,
                 compute_dtype=None, output_features: int = C.N_KEYS):
        super().__init__()
        size, cd = model_complexity * 16, resolve_compute_dtype(compute_dtype)
        keys = output_features
        self.onset_stack = OnsetStack(n_bins, size, keys, compute_dtype=cd)
        self.frame_stack = nn.Sequential(ConvStack(n_bins, size, cd),
                                         Linear(size, keys), nn.Sigmoid())
        self.combined_stack = CombineStack(2 * keys, size, keys)

    def forward(self, spec):
        onset = self.onset_stack(spec)
        activation = self.frame_stack(spec)
        frame = self.combined_stack(torch.cat([onset.detach(), activation],
                                              dim=-1))
        return onset, activation, frame

    def frame_only(self, spec):
        """The VAT target (`model/onset_frame_VAT.py:186-188`)."""
        return self(spec)[2]


class FrameStackNet(nn.Module):
    """Reference `Frame_stack_VAT` forward (`model/onset_frame_VAT.py:
    445-451`): spec -> (activation, frame)."""

    def __init__(self, n_bins: int = C.N_BINS, model_complexity: int = 48,
                 compute_dtype=None, output_features: int = C.N_KEYS):
        super().__init__()
        size, cd = model_complexity * 16, resolve_compute_dtype(compute_dtype)
        keys = output_features
        self.frame_stack = nn.Sequential(ConvStack(n_bins, size, cd),
                                         Linear(size, keys), nn.Sigmoid())
        self.combined_stack = CombineStack(keys, size, keys)

    def forward(self, spec):
        activation = self.frame_stack(spec)
        return activation, self.combined_stack(activation)

    def both(self, spec):
        """The VAT target: {activation, frame}."""
        activation, frame = self(spec)
        return {"activation": activation, "frame": frame}


class OnsetStackNet(nn.Module):
    """Reference `Onset_stack_VAT` forward (`model/onset_frame_VAT.py:
    534-537`): spec -> onset."""

    def __init__(self, n_bins: int = C.N_BINS, model_complexity: int = 48,
                 compute_dtype=None, output_features: int = C.N_KEYS):
        super().__init__()
        size, cd = model_complexity * 16, resolve_compute_dtype(compute_dtype)
        self.onset_stack = OnsetStack(n_bins, size, output_features,
                                      compute_dtype=cd)

    def forward(self, spec):
        return self.onset_stack(spec)


class _Family(FrameSpecModel):
    """What the three models share: the constructor's keys (those of the
    JAX dataclasses, with `ReconVAT`'s seed, device and compute_dtype;
    `reconstruction` is taken and has no effect: the family has no
    reconstruction chain; the ablations take `kl_div` and leave it
    unused, as the JAX package's do, since their VAT objectives are their
    own; `output_features` the keys of every roll, 88 by default; `spec`
    the frontend, whose bins set the conv trunk's FC input width) and
    per-step dropout masks."""

    def _build(self, model_complexity, log, mode, spec, vat_cfg, seed,
               device, compute_dtype, output_features):
        device = resolve_device(device)
        frontend, n_bins = make_frontend(spec)
        # the network's constructor (the mixins have none)
        super(_Family, self).__init__(n_bins, model_complexity,
                                      compute_dtype, output_features)
        self._init_chain(frontend, n_bins, log, mode, vat_cfg, seed, device)

    def _vat(self, spec, generator, train, y_ref=None):
        """(loss, r_adv, mean |d|) of one VAT chain on `spec`."""
        lds, r_adv, rn = vat_loss(self._transcriber_fn(train), spec,
                                  generator, self.vat_cfg, y_ref=y_ref)
        return lds, r_adv, rn.abs().mean()


class OnsetsAndFrames(_Family, OnsetsAndFramesNet):
    """Onsets and Frames with VAT on the frame roll (reference
    `OnsetsAndFrames_VAT_full.run_on_batch`, `model/onset_frame_VAT.py:
    637-706`). xi and eps default to the JAX dataclass's (1e-5, 10); the
    training CLI passes its own (1e-6, 0.1)."""

    def __init__(self, model_complexity: int = 48, log: bool = True,
                 mode: str = "imagewise", spec: str = "Mel",
                 xi: float = 1e-5, eps: float = 10.0, kl_div: bool = False,
                 reconstruction: bool = False, seed: int = 0, device=None,
                 compute_dtype=None, output_features: int = C.N_KEYS):
        self._build(model_complexity, log, mode, spec,
                    VATConfig(xi=xi, eps=eps, kl_div=kl_div, norm_axis=-1),
                    seed, device, compute_dtype, output_features)

    vat_target = OnsetsAndFramesNet.frame_only

    def _rolls(self, spec):
        onset, _, frame = self(spec)
        return onset, frame

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """batch_l {"audio" (B, N), "frame", "onset" (B, T, 88)}, batch_ul
        {"audio"} or None, on the model's device; returns (predictions,
        losses, spec (B, T, F)). The unlabeled VAT chain runs whenever
        batch_ul is given, as in the JAX package; its direction is drawn
        first, then the labeled chain's. A (B,) t_true gives per-song loss
        vectors (`ReconVAT.run_on_batch`)."""
        prefix, mask, zero = self._start(train, generator, t_true,
                                         batch_l["frame"].shape[1])
        lds_ul, r_norm_ul = zero, zero
        if batch_ul is not None:
            lds_ul, _, r_norm_ul = self._vat(
                self.make_spec(batch_ul["audio"]), generator, train)
        spec = self.make_spec(batch_l["audio"], t_true)
        onset, activation, frame = self(spec)
        lds_l, r_adv, r_norm_l = zero, None, zero
        if vat:
            # the supervised forward's frame roll is the VAT reference: the
            # same masks and statistics as the chain's own clean forward
            lds_l, r_adv, r_norm_l = self._vat(spec, generator, train, frame)
        predictions = {"onset": onset, "frame": frame,
                       "activation": activation, "r_adv": r_adv}
        losses = {
            f"loss/{prefix}_frame":
                binary_cross_entropy(frame, batch_l["frame"], mask),
            f"loss/{prefix}_onset":
                binary_cross_entropy(onset, batch_l["onset"], mask),
            f"loss/{prefix}_LDS_l": lds_l,
        }
        if train:
            losses[f"loss/{prefix}_LDS_ul"] = lds_ul
        losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
        if train:
            losses[f"loss/{prefix}_r_norm_ul"] = r_norm_ul
        return predictions, losses, spec


class FrameStackVAT(_Family, FrameStackNet):
    """Frame-stack ablation (reference `Frame_stack_VAT`): VAT on
    {activation, frame} with the objective `vat_mode` picks ('activation':
    the MSE of the activation, 'frame': the BCE of the frame roll, else
    their sum) and the 1e20 rescue (`model/onset_frame_VAT.py:209-269`).
    One LDS loss, `loss/{train,test}_LDS`."""

    def __init__(self, model_complexity: int = 48, log: bool = True,
                 mode: str = "imagewise", spec: str = "Mel",
                 xi: float = 1e-5, eps: float = 10.0, kl_div: bool = False,
                 reconstruction: bool = False, seed: int = 0, device=None,
                 compute_dtype=None, vat_mode: str = "all",
                 output_features: int = C.N_KEYS):
        def objective(y_pred, y_ref):
            act = mse_loss(y_pred["activation"], y_ref["activation"])
            frame = binary_cross_entropy(y_pred["frame"], y_ref["frame"])
            total = {"activation": act, "frame": frame}.get(vat_mode,
                                                            act + frame)
            return total, total

        self._build(model_complexity, log, mode, spec,
                    VATConfig(xi=xi, eps=eps, norm_axis=-1, grad_rescue=1e20,
                              objective=objective),
                    seed, device, compute_dtype, output_features)

    vat_target = FrameStackNet.both

    def _rolls(self, spec):
        frame = self(spec)[1]
        return frame, frame

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """As `OnsetsAndFrames.run_on_batch`, with the reference's keys
        (`model/onset_frame_VAT.py:491-501`): the unlabeled chain runs only
        with `vat`, and in training `loss/train_LDS` is the mean of the two
        chains' losses."""
        prefix, mask, zero = self._start(train, generator, t_true,
                                         batch_l["frame"].shape[1])
        lds_ul = zero
        if batch_ul is not None and vat:
            lds_ul = self._vat(self.make_spec(batch_ul["audio"]), generator,
                               train)[0]
        spec = self.make_spec(batch_l["audio"], t_true)
        activation, frame = self(spec)
        lds_l, r_adv = zero, None
        if vat:
            lds_l, r_adv, _ = self._vat(
                spec, generator, train,
                {"activation": activation, "frame": frame})
        predictions = {"onset": frame, "frame": frame,
                       "activation": activation, "r_adv": r_adv}
        losses = {f"loss/{prefix}_frame":
                  binary_cross_entropy(frame, batch_l["frame"], mask),
                  f"loss/{prefix}_LDS":
                      (lds_ul + lds_l) / 2 if train else lds_l}
        return predictions, losses, spec


class OnsetStackVAT(_Family, OnsetStackNet):
    """Onset-stack ablation (reference `Onset_stack_VAT`): VAT on the onset
    roll without the clamp of the perturbed spec and without the rescue
    (grad_rescue 1); `vat_mode` is taken and unused, as in the JAX
    package. Its keys add `metric/{train,test}_accuracy`, the share of
    onset bins whose thresholded prediction equals the label (summed into
    the total loss like any key; its gradient is zero)."""

    def __init__(self, model_complexity: int = 48, log: bool = True,
                 mode: str = "imagewise", spec: str = "Mel",
                 xi: float = 1e-5, eps: float = 10.0, kl_div: bool = False,
                 reconstruction: bool = False, seed: int = 0, device=None,
                 compute_dtype=None, vat_mode: str = "all",
                 output_features: int = C.N_KEYS):
        self._build(model_complexity, log, mode, spec,
                    VATConfig(xi=xi, eps=eps, norm_axis=-1, grad_rescue=1.0,
                              clamp=False),
                    seed, device, compute_dtype, output_features)

    vat_target = OnsetStackNet.forward

    def _rolls(self, spec):
        onset = self(spec)
        return onset, onset

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """As `FrameStackVAT.run_on_batch`, on the onset labels."""
        onset_label = batch_l["onset"]
        prefix, mask, zero = self._start(train, generator, t_true,
                                         onset_label.shape[1])
        lds_ul = zero
        if batch_ul is not None and vat:
            lds_ul = self._vat(self.make_spec(batch_ul["audio"]), generator,
                               train)[0]
        spec = self.make_spec(batch_l["audio"], t_true)
        onset = self(spec)
        lds_l, r_adv = zero, None
        if vat:
            lds_l, r_adv, _ = self._vat(spec, generator, train, onset)
        hits = onset_label == (onset > 0.5).to(onset_label.dtype)
        predictions = {"onset": onset, "frame": onset, "r_adv": r_adv}
        losses = {f"loss/{prefix}_onset":
                  binary_cross_entropy(onset, onset_label, mask),
                  f"metric/{prefix}_accuracy":
                      _masked_mean(hits.float(), mask),
                  f"loss/{prefix}_LDS":
                      (lds_ul + lds_l) / 2 if train else lds_l}
        return predictions, losses, spec
