"""The attention models in PyTorch (counterpart of
`reconvat_tpu/models/attention_models.py`; reference `model/
self_attention_VAT.py` and `model/self_attenttion_model.py`).

    VATSelfAttention1D (`VAT_self_attention_1D`): window attention over the
        spec -> LayerNorm -> linear -> sigmoid, VAT on the roll.
    VATCNNAttention1D (`VAT_CNN_attention_1D`): an O&F conv trunk (version
        'a') or a Timbral CNN ('b') under the same head; a hard-wired
        (1e-2, 10, 50) triangular eps cycle.
    VATCNNAttentionOnsetFrame (`VAT_CNN_attention_onset_frame`): two Timbral
        CNNs, onset and final attention stacks; VAT attacks the frame roll.
    OnsetsAndFramesSelfAttention (`OnsetsAndFrames_self_attention`): O&F
        with window attention in place of the LSTMs, 8 heads of 96.
    SimpleOnsetFrame (`simple_onset_frame`), StandaloneSelfAttention1D and
        StandaloneSelfAttention2D (`standalone_self_attention_1D/_2D`): the
        attention alone; their `run_on_batch` runs the eval-mode forward.
    Reconstructor: `Roll2Spec` trained alone, frame labels -> spec.

The spec is (B, T, F); VAT normalizes its direction over the bins with no
underflow rescue. At the default width (model_complexity 48, 8 heads) the
attention runs the kernels at 8 heads of Dh = 6. The models have no
compute dtype (fp32), as in the JAX package. The triangular eps schedule
is a host-side generator (`triangular_cycle`); `run_on_batch(...,
eps=...)` takes the scheduled value. Submodule names are the JAX package's
(the reference's flat head names `sequence_model`, `layer_norm`,
`linear`; the O&F conv trunk's reference names `cnn.N`, `fc.0`).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
from torch import nn

from .. import constants as C
from ..nn.attention import MultiHeadAttention1D
from ..nn.layers import ConvStack, Linear
from ..nn.unet import BATCHNORM_EPS, BatchNorm2d
from ..ops.spectrogram import make_frontend
from ..vat import VATConfig, vat_loss
from .base import FrameSpecModel, resolve_device
from .losses import binary_cross_entropy
from .reconvat import Roll2Spec
from .segmentation import MultiHeadAttention2D

N_KEYS = C.N_KEYS


def create_triangular_cycle(start, end, period):
    """Host-side triangular eps schedule (reference
    `model/self_attention_VAT.py:15-20`)."""
    tri_a = np.linspace(start, end, period)
    tri_b = np.linspace(end, start, period)[1:-1]
    return itertools.cycle(np.concatenate([tri_a, tri_b]))


def _ln(features: int) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=1e-5)    # torch's default eps


class TimbralCNN(nn.Module):
    """Reference `Timbral_CNN` ('new' branch, `model/self_attention_VAT.py:
    472-489`): three 3 x 3 convolutions with BatchNorm and ReLU, two (1, 2)
    frequency max-pools, a channel-major flatten and a linear layer.
    (B, T, F) -> (B, T, output_features)."""

    def __init__(self, start_channel: int, final_channel: int,
                 output_features: int, n_bins: int = C.N_BINS):
        super().__init__()

        def bn(c):
            return BatchNorm2d(c, eps=BATCHNORM_EPS)

        self.conv0 = nn.Conv2d(1, start_channel, 3, padding=1)
        self.bn0 = bn(start_channel)
        self.conv1 = nn.Conv2d(start_channel, start_channel, 3, padding=1)
        self.bn1 = bn(start_channel)
        self.conv2 = nn.Conv2d(start_channel, final_channel, 3, padding=1)
        self.bn2 = bn(final_channel)
        self.fc = Linear(final_channel * (n_bins // 4), output_features)

    def forward(self, spec):
        relu, pool = torch.relu, nn.functional.max_pool2d
        x = relu(self.bn0(self.conv0(spec[:, None])))
        x = pool(relu(self.bn1(self.conv1(x))), (1, 2))
        x = pool(relu(self.bn2(self.conv2(x))), (1, 2))
        return self.fc(x.transpose(1, 2).flatten(-2))   # (B, T, C * F / 4)


def _attn_head_setup(mod, in_features, model_complexity, output_features,
                     w_size, n_heads, position=True):
    """The attention -> LayerNorm -> linear head under the reference's flat
    names (`sequence_model`, `layer_norm`, `linear`,
    `model/self_attention_VAT.py:269-276`)."""
    mod.sequence_model = MultiHeadAttention1D(
        in_features, model_complexity, w_size, n_heads, position=position)
    mod.layer_norm = _ln(model_complexity)
    mod.linear = Linear(model_complexity, output_features)


def _attn_head_apply(mod, x):
    x, a = mod.sequence_model(x)
    return torch.sigmoid(mod.linear(mod.layer_norm(x))), a


class _AttnModel(FrameSpecModel):
    """What the models share: the signal chain of `spec` on (B, T, F),
    whose bins set the networks' input widths, the seeded
    parameters and device. Their `run_on_batch` also takes the frame mask
    of a padded clip (`t_true`, as the other models take it: the
    evaluation runner pads songs)."""

    def _build(self, net_args, spec, log, mode, vat_cfg, seed, device):
        device = resolve_device(device)
        frontend, n_bins = make_frontend(spec)
        # the network's constructor (the mixins have none)
        super(_AttnModel, self).__init__(n_bins, *net_args)
        self._init_chain(frontend, n_bins, log, mode, vat_cfg, seed, device)


class _VATAttnModel(_AttnModel):
    """The VAT models' keys (the JAX package's `_AttnModelBase`) and batch
    contract: VAT on the frame roll with the direction's norm over the
    bins, no rescue, `eps` overridable per call."""

    def _build_vat(self, net_args, spec, log, mode, xi, eps, kl_div,
                   eps_period, eps_max, seed, device):
        self._build(net_args, spec, log, mode,
                    VATConfig(xi=xi, eps=eps, kl_div=kl_div, norm_axis=-1,
                              grad_rescue=1.0), seed, device)
        self.triangular_cycle = (create_triangular_cycle(eps, eps_max,
                                                         eps_period)
                                 if eps_period else None)

    def vat_target(self, x):
        return self(x)[0]

    def _rolls(self, spec):
        # the first output as both rolls (the JAX package's `transcribe`)
        frame = self(spec)[0]
        return frame, frame

    def _vat(self, spec, generator, train, cfg, y_ref=None):
        lds, r_adv, rn = vat_loss(self._transcriber_fn(train), spec,
                                  generator, cfg, y_ref=y_ref)
        return lds, r_adv, rn.abs().mean()

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, eps=None,
                     t_true=None):
        """The JAX package's `_AttnModelBase.run_on_batch`: batch_l
        {"audio" (B, N), "frame"}, batch_ul {"audio"} or None, on the
        model's device; returns (predictions, losses, spec (B, T, F)). The
        unlabeled chain runs whenever batch_ul is given, its direction
        drawn first; `eps` replaces the configured eps for this call."""
        cfg = (self.vat_cfg if eps is None
               else dataclasses.replace(self.vat_cfg, eps=eps))
        prefix, mask, zero = self._start(train, generator, t_true,
                                         batch_l["frame"].shape[1])
        lds_ul, r_norm_ul = zero, zero
        if batch_ul is not None:
            lds_ul, _, r_norm_ul = self._vat(
                self.make_spec(batch_ul["audio"]), generator, train, cfg)
        spec = self.make_spec(batch_l["audio"], t_true)
        out = self(spec)
        lds_l, r_adv, r_norm_l = zero, None, zero
        if vat:
            # the supervised forward is the chain's clean prediction: the
            # same masks and batch statistics
            lds_l, r_adv, r_norm_l = self._vat(spec, generator, train, cfg,
                                               out[0])
        predictions, losses = self._outputs(
            out, batch_l, mask, prefix, r_adv,
            {"LDS_l": lds_l, "LDS_ul": lds_ul, "r_norm_l": r_norm_l,
             "r_norm_ul": r_norm_ul}, train)
        return predictions, losses, spec

    def _outputs(self, out, batch_l, mask, prefix, r_adv, vat, train):
        frame_pred, a = out
        predictions = {"onset": frame_pred, "frame": frame_pred,
                       "attention": a, "r_adv": r_adv}
        losses = {
            f"loss/{prefix}_frame":
                binary_cross_entropy(frame_pred, batch_l["frame"], mask),
            f"loss/{prefix}_LDS_l": vat["LDS_l"],
        }
        if train:
            losses[f"loss/{prefix}_LDS_ul"] = vat["LDS_ul"]
            losses[f"loss/{prefix}_r_norm_l"] = vat["r_norm_l"]
            losses[f"loss/{prefix}_r_norm_ul"] = vat["r_norm_ul"]
        else:
            losses[f"loss/{prefix}_r_norm_l"] = vat["r_norm_l"]
        return predictions, losses


class SelfAttention1DNet(nn.Module):
    """The JAX package's `_SA1DModule`: spec -> (roll, attention)."""

    def __init__(self, n_bins, model_complexity, output_features, w_size,
                 n_heads, position=True):
        super().__init__()
        _attn_head_setup(self, n_bins, model_complexity, output_features,
                         w_size, n_heads, position)

    def forward(self, x):
        return _attn_head_apply(self, x)


class VATSelfAttention1D(_VATAttnModel, SelfAttention1DNet):
    """Reference `VAT_self_attention_1D`: one attention layer, LayerNorm,
    linear and sigmoid on the spec; VAT without the rescue."""

    def __init__(self, input_features: int = C.N_BINS,
                 output_features: int = N_KEYS, model_complexity: int = 48,
                 w_size: int = 31, log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", n_heads: int = 8, position: bool = True,
                 xi: float = 1e-5, eps: float = 1e-2, kl_div: bool = False,
                 eps_period: int = 0, eps_max: float = 1.0,
                 reconstruction: bool = False, seed: int = 0, device=None):
        self._build_vat((model_complexity, output_features, w_size, n_heads,
                         position), spec, log, mode, xi, eps, kl_div,
                        eps_period, eps_max, seed, device)


class CNNAttention1DNet(nn.Module):
    """The JAX package's `_CNNAttn1DModule`: an O&F conv trunk (version
    'a') or a Timbral CNN (32, 8; 'b') to output_features, then the
    attention head."""

    def __init__(self, n_bins, input_features, output_features,
                 model_complexity, w_size, n_heads, version="a"):
        super().__init__()
        # the trunk's FC takes the spec's bins, as the JAX package's Dense
        # infers its input width; input_features is taken and unused there
        self.cnn = (ConvStack(n_bins, output_features)
                    if version == "a"
                    else TimbralCNN(32, 8, output_features, n_bins))
        _attn_head_setup(self, output_features, model_complexity,
                         output_features, w_size, n_heads)

    def forward(self, x):
        return _attn_head_apply(self, self.cnn(x))


class VATCNNAttention1D(_VATAttnModel, CNNAttention1DNet):
    """Reference `VAT_CNN_attention_1D`: conv trunk + attention head; the
    reference hard-wires a (1e-2, 10, 50) triangular eps cycle."""

    def __init__(self, input_features: int = C.N_BINS,
                 output_features: int = N_KEYS, model_complexity: int = 48,
                 w_size: int = 31, log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", n_heads: int = 8, position: bool = True,
                 xi: float = 1e-5, eps: float = 1e-2, kl_div: bool = False,
                 eps_period: int = 0, eps_max: float = 1.0,
                 reconstruction: bool = False, version: str = "a",
                 seed: int = 0, device=None):
        self.version = version
        self._build_vat((input_features, output_features, model_complexity,
                         w_size, n_heads, version), spec, log, mode, xi, eps,
                        kl_div, eps_period, eps_max, seed, device)
        self.triangular_cycle = create_triangular_cycle(1e-2, 10, 50)


class CNNAttentionOnsetFrameNet(nn.Module):
    """The JAX package's `_CNNAttnOnsetFrameModule`: an onset Timbral CNN
    and attention stack, and a final attention stack over [onset roll,
    the frame Timbral CNN's features] -> (frame, onset, attention)."""

    def __init__(self, n_bins, output_features, model_complexity, w_size,
                 n_heads):
        super().__init__()
        of, mc = output_features, model_complexity
        self.cnn = TimbralCNN(48, 96, of, n_bins)
        self.onset_timbral_cnn = TimbralCNN(48, 96, of, n_bins)
        self.onset_attention = MultiHeadAttention1D(of, mc, w_size, n_heads)
        self.layer_norm_onset = _ln(mc)
        self.onset_classifier = Linear(mc, of)
        self.final_attention = MultiHeadAttention1D(2 * of, mc, w_size,
                                                    n_heads)
        self.layer_norm_final = _ln(mc)
        self.final_classifier = Linear(mc, of)

    def forward(self, x):
        onset, _ = self.onset_attention(self.onset_timbral_cnn(x))
        onset = torch.sigmoid(self.onset_classifier(
            self.layer_norm_onset(onset)))
        h, a = self.final_attention(torch.cat([onset, self.cnn(x)], dim=-1))
        frame = torch.sigmoid(self.final_classifier(self.layer_norm_final(h)))
        return frame, onset, a


class VATCNNAttentionOnsetFrame(_VATAttnModel, CNNAttentionOnsetFrameNet):
    """Reference `VAT_CNN_attention_onset_frame`: VAT attacks the frame
    roll (`model/self_attention_VAT.py:204-238`); its keys add the onset
    loss and drop the r_norm terms."""

    def __init__(self, input_features: int = C.N_BINS,
                 output_features: int = N_KEYS, model_complexity: int = 48,
                 w_size: int = 31, log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", n_heads: int = 8, position: bool = True,
                 xi: float = 1e-5, eps: float = 1e-2, kl_div: bool = False,
                 eps_period: int = 0, eps_max: float = 1.0,
                 reconstruction: bool = False, seed: int = 0, device=None):
        self._build_vat((output_features, model_complexity, w_size, n_heads),
                        spec, log, mode, xi, eps, kl_div, eps_period, eps_max,
                        seed, device)

    def _outputs(self, out, batch_l, mask, prefix, r_adv, vat, train):
        frame_pred, onset_pred, a = out
        predictions = {"onset": onset_pred, "frame": frame_pred,
                       "attention": a, "r_adv": r_adv}
        losses = {
            f"loss/{prefix}_frame":
                binary_cross_entropy(frame_pred, batch_l["frame"], mask),
            f"loss/{prefix}_onset":
                binary_cross_entropy(onset_pred, batch_l["onset"], mask),
            f"loss/{prefix}_LDS_l": vat["LDS_l"],
        }
        if train:
            losses[f"loss/{prefix}_LDS_ul"] = vat["LDS_ul"]
        return predictions, losses


class OFSelfAttentionNet(nn.Module):
    """Reference `OnsetsAndFrames_self_attention` forward (`model/
    self_attenttion_model.py:271-282`): O&F conv trunks of model_complexity
    x 16 features, window attention in place of the LSTMs; the onset roll
    enters the combined stack detached. spec -> (onset, activation,
    frame, attention)."""

    def __init__(self, n_bins, input_features, output_features,
                 model_complexity, w_size, n_heads):
        super().__init__()
        size, of = model_complexity * 16, output_features
        # the spec's bins set the FC widths (the JAX package's Dense infers
        # them; input_features is taken and unused there)
        self.onset_conv = ConvStack(n_bins, size)
        self.onset_attn = MultiHeadAttention1D(size, size, w_size, n_heads)
        self.onset_linear = Linear(size, of)
        self.frame_conv = ConvStack(n_bins, size)
        self.frame_linear = Linear(size, of)
        self.combined_attn = MultiHeadAttention1D(2 * of, size, w_size,
                                                  n_heads)
        self.combined_linear = Linear(size, of)

    def forward(self, spec):
        x, _ = self.onset_attn(self.onset_conv(spec))
        onset = torch.sigmoid(self.onset_linear(x))
        activation = torch.sigmoid(self.frame_linear(self.frame_conv(spec)))
        h, a = self.combined_attn(torch.cat([onset.detach(), activation],
                                            dim=-1))
        return onset, activation, torch.sigmoid(self.combined_linear(h)), a


class OnsetsAndFramesSelfAttention(_AttnModel, OFSelfAttentionNet):
    """Reference `OnsetsAndFrames_self_attention` batch contract (`model/
    self_attenttion_model.py:286-331`): supervised, the plain `loss/onset`
    and `loss/frame` keys (only `loss/frame` without `onset_stack`). The
    JAX package's default window 31 (the reference's 30 trips its own
    odd-window assert)."""

    def __init__(self, input_features: int = C.N_BINS,
                 output_features: int = N_KEYS, model_complexity: int = 48,
                 w_size: int = 31, n_heads: int = 8, log: bool = True,
                 mode: str = "imagewise", spec: str = "Mel",
                 onset_stack: bool = True, reconstruction: bool = False,
                 seed: int = 0, device=None):
        self.onset_stack = onset_stack
        self._build((input_features, output_features, model_complexity,
                     w_size, n_heads), spec, log, mode, None, seed, device)

    def _rolls(self, spec):
        onset, _, frame, _ = self(spec)
        return onset, frame

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """batch_l {"audio", "frame", "onset"}; batch_ul and vat are taken
        and unused. Returns (predictions, losses, spec)."""
        _, mask, _ = self._start(train, generator, t_true,
                                 batch_l["frame"].shape[1])
        spec = self.make_spec(batch_l["audio"], t_true)
        onset, activation, frame, a = self(spec)
        predictions = {"onset": onset if self.onset_stack else frame,
                       "activation": activation, "frame": frame,
                       "attention": a, "r_adv": None}
        losses = {"loss/frame": binary_cross_entropy(frame, batch_l["frame"],
                                                     mask)}
        if self.onset_stack:
            losses = {"loss/onset": binary_cross_entropy(
                onset, batch_l["onset"], mask), **losses}
        return predictions, losses, spec


class SimpleOnsetFrameNet(nn.Module):
    """Reference `simple_onset_frame` forward (`model/self_attenttion_model.
    py:402-414`): an onset attention stack on the spec, a frame stack on
    [onset roll, onset features] -> (frame, onset, attention)."""

    def __init__(self, n_bins, output_features, model_complexity, w_size,
                 n_heads, position=True):
        super().__init__()
        mc, of = model_complexity, output_features
        self.sequence_model_onset = MultiHeadAttention1D(
            n_bins, mc, w_size, n_heads, position=position)
        self.layer_norm_onset = _ln(mc)
        self.linear_onset = Linear(mc, of)
        self.sequence_model_frame = MultiHeadAttention1D(
            of + mc, mc, w_size, n_heads, position=position)
        self.layer_norm_frame = _ln(mc)
        self.linear_frame = Linear(mc, of)

    def forward(self, spec):
        x, a = self.sequence_model_onset(spec)
        x = self.layer_norm_onset(x)
        onset = torch.sigmoid(self.linear_onset(x))
        h, _ = self.sequence_model_frame(torch.cat([onset, x], dim=-1))
        frame = torch.sigmoid(self.linear_frame(self.layer_norm_frame(h)))
        return frame, onset, a


class _EvalForwardModel(_AttnModel):
    """The attention-only models: `run_on_batch` applies the network in
    eval mode even when training (`model/self_attenttion_model.py:
    418-451`); the frame loss is `loss/{train,test}_frame`."""

    def _eval_forward(self, batch_l, t_true):
        _, mask, _ = self._start(False, None, t_true,
                                 batch_l["frame"].shape[1])
        spec = self.make_spec(batch_l["audio"], t_true)
        return spec, mask, self(spec)


class SimpleOnsetFrame(_EvalForwardModel, SimpleOnsetFrameNet):
    """Reference `simple_onset_frame` batch contract: `loss/onset` always,
    `loss/{train,test}_frame` by mode."""

    def __init__(self, input_features: int = C.N_BINS,
                 output_features: int = N_KEYS, model_complexity: int = 48,
                 w_size: int = 31, n_heads: int = 8, position: bool = True,
                 log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", reconstruction: bool = False,
                 seed: int = 0, device=None):
        self._build((output_features, model_complexity, w_size, n_heads,
                     position), spec, log, mode, None, seed, device)

    def _rolls(self, spec):
        frame, onset, _ = self(spec)
        return onset, frame

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        spec, mask, (frame, onset, a) = self._eval_forward(batch_l, t_true)
        predictions = {"onset": onset, "frame": frame, "attention": a,
                       "r_adv": None}
        losses = {
            "loss/onset": binary_cross_entropy(onset, batch_l["onset"], mask),
            f"loss/{'train' if train else 'test'}_frame":
                binary_cross_entropy(frame, batch_l["frame"], mask),
        }
        return predictions, losses, spec


class Standalone1DNet(nn.Module):
    """Reference `standalone_self_attention_1D` forward (`model/
    self_attenttion_model.py:512-524`): attention -> linear -> sigmoid, a
    LayerNorm before the linear ('Before') or after it ('After')."""

    def __init__(self, n_bins, model_complexity, output_features, w_size,
                 n_heads, position=True, layernorm_pos=None):
        super().__init__()
        self.layernorm_pos = layernorm_pos
        self.sequence_model = MultiHeadAttention1D(
            n_bins, model_complexity, w_size, n_heads, position=position)
        if layernorm_pos in ("Before", "After"):
            self.layer_norm = _ln(model_complexity if layernorm_pos
                                  == "Before" else output_features)
        self.linear = Linear(model_complexity, output_features)

    def forward(self, spec):
        x, a = self.sequence_model(spec)
        if self.layernorm_pos == "Before":
            x = self.layer_norm(x)
        x = self.linear(x)
        if self.layernorm_pos == "After":
            x = self.layer_norm(x)
        return torch.sigmoid(x), a


class _StandaloneModel(_EvalForwardModel):
    """The standalone models' batch contract: one frame loss."""

    def _rolls(self, spec):
        frame, _ = self(spec)
        return frame, frame

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        spec, mask, (frame, a) = self._eval_forward(batch_l, t_true)
        predictions = {"onset": frame, "frame": frame, "attention": a,
                       "r_adv": None}
        losses = {f"loss/{'train' if train else 'test'}_frame":
                  binary_cross_entropy(frame, batch_l["frame"], mask)}
        return predictions, losses, spec


class StandaloneSelfAttention1D(_StandaloneModel, Standalone1DNet):
    """The minimal attention-only frame model."""

    def __init__(self, input_features: int = C.N_BINS,
                 output_features: int = N_KEYS, model_complexity: int = 48,
                 w_size: int = 31, n_heads: int = 8, position: bool = True,
                 log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", reconstruction: bool = False,
                 layernorm_pos=None, seed: int = 0, device=None):
        self._build((model_complexity, output_features, w_size, n_heads,
                     position, layernorm_pos), spec, log, mode, None, seed,
                    device)


class Standalone2DNet(nn.Module):
    """Reference `standalone_self_attention_2D` forward (`model/
    self_attenttion_model.py:620-626`): `MultiHeadAttention2D` over the
    full-resolution spec image, a channel-major flatten (the reference's
    transpose(1, 2).flatten(2)), linear, sigmoid."""

    def __init__(self, n_bins, model_complexity, output_features,
                 w_size=(3, 3)):
        super().__init__()
        self.sequence_model = MultiHeadAttention2D(1, model_complexity,
                                                   tuple(w_size))
        self.linear = Linear(model_complexity * n_bins, output_features)

    def forward(self, spec):
        x, a = self.sequence_model(spec[:, None])       # (B, C, T, F)
        return torch.sigmoid(self.linear(x.transpose(1, 2).flatten(-2))), a


class StandaloneSelfAttention2D(_StandaloneModel, Standalone2DNet):
    """2-D local attention over (time, freq) patches; `n_heads` and
    `position` are taken and unused, as in the JAX package."""

    def __init__(self, input_features: int = C.N_BINS,
                 output_features: int = N_KEYS, model_complexity: int = 16,
                 w_size=(3, 3), n_heads: int = 8, position: bool = True,
                 log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", reconstruction: bool = False,
                 layernorm_pos=None, seed: int = 0, device=None):
        self._build((model_complexity, output_features, w_size), spec, log,
                    mode, None, seed, device)


class Reconstructor(_AttnModel, Roll2Spec):
    """`Roll2Spec` trained alone (reference `Reconstructor`, `model/
    self_attention_VAT.py:971-1011`): frame labels -> spec, against the
    log, imagewise-normalized spec (whatever `log` and `mode` say, as in
    the JAX package). The reference BCEs the unbounded decoder output,
    which torch's BCE rejects outside [0, 1]; the JAX package clamps it
    into [0, 1], and so does this port. `n_heads` is taken and unused."""

    def __init__(self, log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", n_heads: int = 4,
                 reconstruction: bool = False, seed: int = 0, device=None):
        self._build((), spec, True, "imagewise", None, seed, device)

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """batch_l {"audio", "frame"}: the loss is always
        `loss/train_reconstruction`, as in the JAX package."""
        _, mask, _ = self._start(train, generator, t_true,
                                 batch_l["frame"].shape[1])
        spec = self.make_spec(batch_l["audio"], t_true)
        reconstruction, a = self(batch_l["frame"])
        rec = reconstruction[..., 0].clamp(0.0, 1.0)
        predictions = {"attention": a, "reconstruction": reconstruction,
                       "r_adv": None}
        losses = {"loss/train_reconstruction":
                  binary_cross_entropy(rec, spec.detach(), mask)}
        return predictions, losses, spec
