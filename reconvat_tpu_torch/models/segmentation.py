"""The semantic-segmentation transcriber ("baseline_Multi_Inst") in PyTorch
(counterpart of the NHWC path of `reconvat_tpu/models/segmentation.py`,
reference `Semantic_Segmentation`, `model/Segmentation.py:136-642`).

A DeepLab-like net on the (time, freq) spec image: pre-activation residual
blocks (ReLU -> BatchNorm -> dropout -> convolution) with TF-SAME padding
computed by hand, two 17 x 17 local 2-D attention layers at the 256-channel
bottleneck (time and frequency / 16), a transposed-convolution decoder
with Keras-SAME trimming, and a Linear(N_BINS -> 88) head per output
class. Activations are NCHW with time on H and frequency on W; padding and
trims are pixel-exact on odd sizes (frequency 229 -> 115 -> 58 -> 29 -> 15;
time any length). The JAX package's frequency-folded layout is a TPU
lane-tiling device equal to this one and is not ported.

Inside a sequence-parallel step (`parallel.mesh.sp_context`: this rank's
frames of the time axis, H) every time padding is the neighbouring
ranks' frames (`parallel.mesh.time_halo`, zeros at the clip's ends): the
TF-SAME pads of the convolutions, the stride-2 transposed convolution's
front frame and the attention's 8-frame windows; the frequency padding
stays. A rank's frames are a multiple of 16, the net's total time
stride, so its strided grids and trims are the whole clip's.

Submodule names are the reference's, so its state_dict loads by name (its
stride-1 blocks' unused `conv_skip` weights are dropped). Dropout draws
its masks once per `run_on_batch` (`nn/layers.SharedDropout`), as the JAX
package's one dropout key per step does. `compute_dtype='bfloat16'` runs
the convolutions and the attention's projections and products in bf16;
BatchNorm, the softmax, `conv_last`, the head, posteriogram and losses in
fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C
from ..nn.layers import Linear, SharedDropout
from ..nn.precision import promote_fp32, resolve_compute_dtype
from ..nn.unet import BatchNorm2d, Conv2d, ConvTranspose2d
from ..ops.spectrogram import make_frontend
from ..parallel import mesh as pmesh
from ..vat import VATConfig, vat_loss
from .base import (TranscriptionModel, fp32_math, read_state_dict,
                   resolve_device)
from .common import transcribe_spec, transcribe_streaming
from .losses import binary_cross_entropy


def _pad_amount(size: int, k: int, s: int) -> int:
    if size % s == 0:
        return max(k - s, 0)
    return max(k - (size % s), 0)


# the time axis of the NCHW activations (the dropout masks' too)
TIME_DIM = 2


def tf_same_pad(x, ksize, stride):
    """TF 'SAME' padding of an NCHW tensor, the extra pixel at the end
    (reference `calculate_padding` + `SAME_padding`, `model/Segmentation.
    py:76-133`). Inside a sequence-parallel step the time padding is a
    halo: an interior rank's extra frame at the end of a stride-2
    convolution is the next rank's first frame."""
    ph = _pad_amount(x.shape[2], ksize[0], stride[0])
    pw = _pad_amount(x.shape[3], ksize[1], stride[1])
    ctx = pmesh.sp_context()
    if ctx is not None and ph:
        x = pmesh.time_halo(x, ph // 2, ph - ph // 2, ctx, dim=TIME_DIM)
        ph = 0
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def transpose_padding_same(x, input_hw, stride):
    """Crop a transposed convolution's NCHW output to input x stride, the
    extra pixel off the end (reference `transpose_padding_same`,
    `model/Segmentation.py:112-129`)."""
    th, tw = input_hw[0] * stride[0], input_hw[1] * stride[1]
    rh, rw = x.shape[2] - th, x.shape[3] - tw
    if rh > 0:
        x = x[:, :, rh // 2:x.shape[2] - (rh // 2 + rh % 2)]
    if rw > 0:
        x = x[..., rw // 2:x.shape[3] - (rw // 2 + rw % 2)]
    return x


def _pre_act(bn, dropout, x):
    """ReLU -> BatchNorm -> dropout, the blocks' pre-activation."""
    return dropout(bn(F.relu(x)))


class ConvBlockSeg(nn.Module):
    """Reference `Conv_Block` (`model/Segmentation.py:136-182`): two
    pre-activated convolutions, the first strided; a strided block adds a
    1 x 1 strided skip, a stride-(1, 1) block the input (and has no
    `conv_skip`: the reference defines one it never calls)."""

    def __init__(self, inp: int, out: int, ksize=(3, 3), stride=(2, 2),
                 dropout_rate: float = 0.4, compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.ksize, self.stride = tuple(ksize), tuple(stride)
        self.conv1 = Conv2d(inp, out, ksize, stride, **cd)
        self.bn1 = BatchNorm2d(inp)
        self.dropout1 = SharedDropout(dropout_rate, TIME_DIM)
        self.conv2 = Conv2d(out, out, ksize, 1, **cd)
        self.bn2 = BatchNorm2d(out)
        self.dropout2 = SharedDropout(dropout_rate, TIME_DIM)
        if self.stride != (1, 1):
            self.conv_skip = Conv2d(inp, out, 1, stride, **cd)

    def forward(self, x):
        skip = x
        x = _pre_act(self.bn1, self.dropout1, x)
        x = self.conv1(tf_same_pad(x, self.ksize, self.stride))
        x = _pre_act(self.bn2, self.dropout2, x)
        x = self.conv2(tf_same_pad(x, self.ksize, (1, 1)))
        if self.stride != (1, 1):
            skip = self.conv_skip(tf_same_pad(skip, (1, 1), self.stride))
        return x + skip


class TransposeConvBlock(nn.Module):
    """Reference `transpose_conv_block` (`model/Segmentation.py:185-237`):
    a pre-activated convolution, then a pre-activated strided transposed
    convolution cropped to input x stride and trimmed to the encoder's
    size; the skip is a 1 x 1 strided transposed convolution driven to
    that size (`output_size`). Inside a sequence-parallel step the
    transposed convolution's first output frames take the previous
    rank's last input frames ((k - 1) // stride of them, one here): it
    runs on them and this rank's, and its output's first frames past this
    rank's grid are cropped."""

    def __init__(self, inp: int, out: int, ksize=(3, 3), stride=(2, 2),
                 dropout_rate: float = 0.4, compute_dtype=None):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.ksize, self.stride = tuple(ksize), tuple(stride)
        self.conv1 = Conv2d(inp, out, ksize, 1, **cd)
        self.bn1 = BatchNorm2d(inp)
        self.dropout1 = SharedDropout(dropout_rate, TIME_DIM)
        self.conv2 = ConvTranspose2d(out, out, ksize, stride, **cd)
        self.bn2 = BatchNorm2d(out)
        self.dropout2 = SharedDropout(dropout_rate, TIME_DIM)
        self.conv_skip = ConvTranspose2d(inp, out, 1, stride, **cd)

    def forward(self, x, target_hw):
        skip = x
        x = _pre_act(self.bn1, self.dropout1, x)
        x = self.conv1(tf_same_pad(x, self.ksize, (1, 1)))
        x = _pre_act(self.bn2, self.dropout2, x)
        input_hw = x.shape[2:]
        ctx = pmesh.sp_context()
        if ctx is None:
            x = self.conv2(x)
        else:
            h = (self.ksize[0] - 1) // self.stride[0]
            x = self.conv2(pmesh.time_halo(x, h, 0, ctx, dim=TIME_DIM))[
                :, :, h * self.stride[0]:]
        x = transpose_padding_same(x, input_hw, self.stride)
        # the extra-pixel trim to the encoder's size (`model/Segmentation.
        # py:223-226`)
        if x.shape[2] > target_hw[0]:
            x = x[:, :, :-1]
        if x.shape[3] > target_hw[1]:
            x = x[..., :-1]
        return x + self.conv_skip(skip, output_size=x.shape[2:])


class MultiHeadAttention2D(nn.Module):
    """Reference `MutliHeadAttention2D` (`model/Segmentation.py:277-354`):
    local 2-D attention over a kh x kw window. q from 1 x 1 convolutions
    of the input, k and v of the zero-padded input, bias-free unless
    `use_bias` (a bias then lands on the padding's keys and values too,
    as in the JAX package, which also convolves the padded input); the
    relative embeddings `rel_t` (C/2, 1, 1, kh, 1) and `rel_f` (C/2, 1,
    1, 1, kw), the reference's shapes, broadcast over the window and
    stacked over the channel halves, are added to the key windows.
    Energies unscaled, the softmax and the output in fp32 (or float64).
    (B, in, H, W) -> (out (B, C, H, W), probabilities (B, H, W, groups,
    kh * kw)). Inside a sequence-parallel step the windows' time padding
    is the neighbouring ranks' frames (`parallel.mesh.time_halo`, as many
    ranks as (kh - 1) / 2 frames span). The windows are
    materialised (`Tensor.unfold`), as the JAX package's are: it runs on
    the bottleneck, or on a few channels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3), groups: int = 1, use_bias: bool = False,
                 compute_dtype=None):
        super().__init__()
        kh, kw = kernel_size
        self.out_channels, self.groups = out_channels, groups
        self.kernel_size = (kh, kw)
        for name in ("query_conv", "key_conv", "value_conv"):
            setattr(self, name, Conv2d(in_channels, out_channels, 1,
                                       bias=use_bias,
                                       compute_dtype=compute_dtype))
        self.rel_t = nn.Parameter(torch.empty(out_channels // 2, 1, 1, kh, 1))
        self.rel_f = nn.Parameter(torch.empty(out_channels // 2, 1, 1, 1, kw))

    def forward(self, x):
        B, _, H, W = x.shape
        kh, kw = self.kernel_size
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        Co, G = self.out_channels, self.groups
        q = self.query_conv(x)
        xpad = F.pad(pmesh.time_halo(x, ph, ph, pmesh.sp_context(),
                                     dim=TIME_DIM), (pw, pw))
        # (B, C, H, W, kh, kw) windows
        k = self.key_conv(xpad).unfold(2, kh, 1).unfold(3, kw, 1)
        v = self.value_conv(xpad).unfold(2, kh, 1).unfold(3, kw, 1)
        rel = torch.cat([self.rel_t[:, 0, 0].expand(Co // 2, kh, kw),
                         self.rel_f[:, 0, 0].expand(Co // 2, kh, kw)])
        k = k + rel.to(k.dtype)[:, None, None]
        qg = q.reshape(B, G, Co // G, H, W)
        kg = k.reshape(B, G, Co // G, H, W, kh * kw)
        vg = v.reshape(B, G, Co // G, H, W, kh * kw)
        energy = torch.einsum("bgchw,bgchwk->bghwk", qg, kg)
        attn = torch.softmax(promote_fp32(energy), dim=-1)
        out = torch.einsum("bghwk,bgchwk->bgchw", attn.to(vg.dtype), vg)
        return (promote_fp32(out.reshape(B, Co, H, W)),
                attn.permute(0, 2, 3, 1, 4))


class SegEncoder(nn.Module):
    """Reference Segmentation `Encoder` (`model/Segmentation.py:356-431`):
    a 7 x 7 convolution to 32 channels, then 2, 3, 4 and 5 residual blocks
    at 32, 64, 128 and 256 channels, each level's first block strided."""

    LEVELS = (("layer1", 32, 2), ("layer2", 64, 3), ("layer3", 128, 4),
              ("layer4", 256, 5))

    def __init__(self, dropout_rate: float = 0.4, compute_dtype=None):
        super().__init__()
        self.encoding_layer = Conv2d(1, 32, 7, compute_dtype=compute_dtype)
        inp = 32
        for name, out, n in self.LEVELS:
            for i in range(n):
                setattr(self, f"{name}{'abcde'[i]}", ConvBlockSeg(
                    inp if i == 0 else out, out, (3, 3),
                    (2, 2) if i == 0 else (1, 1), dropout_rate,
                    compute_dtype))
            inp = out

    def forward(self, x):
        """x (B, 1, T, F) -> (bottleneck, (en_l1, en_l2, en_l3), the sizes
        (input, en_l1, en_l2, en_l3))."""
        sizes, outs = [tuple(x.shape[2:])], []
        x = self.encoding_layer(tf_same_pad(x, (7, 7), (1, 1)))
        for name, _, n in self.LEVELS:
            for i in range(n):
                x = getattr(self, f"{name}{'abcde'[i]}")(x)
            if name != "layer4":
                outs.append(x)
                sizes.append(tuple(x.shape[2:]))
        return x, outs, sizes


class DecoderBlockSeg(nn.Module):
    """Reference `Decoder_Block` (`model/Segmentation.py:239-275`): the
    pre-activated input and encoder output concatenated, a 1 x 1
    convolution plus the input, then a `TransposeConvBlock` up to the
    encoder's size."""

    def __init__(self, input_channels: int, encoder_channels: int,
                 hidden_channels: int, output_channels: int,
                 dropout_rate: float = 0.4, compute_dtype=None):
        super().__init__()
        self.layer1a = Conv2d(input_channels + encoder_channels,
                              hidden_channels, 1,
                              compute_dtype=compute_dtype)
        self.bn = BatchNorm2d(input_channels)
        self.bn_en = BatchNorm2d(encoder_channels)
        self.dropout1 = SharedDropout(dropout_rate, TIME_DIM)
        self.layer1b = TransposeConvBlock(input_channels, output_channels,
                                          (3, 3), (2, 2), dropout_rate,
                                          compute_dtype)

    def forward(self, x, encoder_output, encoder_hw):
        skip = x
        x = torch.cat([self.bn(F.relu(x)),
                       self.bn_en(F.relu(encoder_output))], dim=1)
        x = self.layer1a(self.dropout1(x)) + skip
        return self.layer1b(x, encoder_hw)


class SegDecoder(nn.Module):
    def __init__(self, dropout_rate: float = 0.4, compute_dtype=None):
        super().__init__()
        kw = dict(dropout_rate=dropout_rate, compute_dtype=compute_dtype)
        self.de_layer1 = DecoderBlockSeg(128, 128, 128, 64, **kw)
        self.de_layer2 = DecoderBlockSeg(64, 64, 64, 64, **kw)
        self.de_layer3 = DecoderBlockSeg(64, 32, 64, 64, **kw)

    def forward(self, x, encoder_outputs, encoder_hws):
        x = self.de_layer1(x, encoder_outputs[-1], encoder_hws[-2])
        x = self.de_layer2(x, encoder_outputs[-2], encoder_hws[-3])
        return self.de_layer3(x, encoder_outputs[-3], encoder_hws[-4])


class SegmentationModule(nn.Module):
    """Reference `Semantic_Segmentation` forward (`model/Segmentation.py:
    504-537`): spec image (B, T, F, 1) -> posteriogram (B, T, 88), or
    (B, out_class, T, 88) for out_class > 1 (the reference's squeeze is a
    no-op then and its Linear maps each class's (T, F) map). `conv_last`
    and `inference_model` stay fp32 in bf16."""

    def __init__(self, n_bins: int = C.N_BINS, out_class: int = 2,
                 dropout_rate: float = 0.4, compute_dtype=None):
        super().__init__()
        self.out_class = out_class
        kw = dict(compute_dtype=compute_dtype)
        self.encoder = SegEncoder(dropout_rate, **kw)
        self.attention_layer1 = MultiHeadAttention2D(256, 64, (17, 17), **kw)
        self.bn1 = BatchNorm2d(64)
        self.attention_layer2 = MultiHeadAttention2D(64, 128, (17, 17), **kw)
        self.bn2 = BatchNorm2d(128)
        self.layer0a = Conv2d(256 + 128, 256, 1, **kw)
        self.layer0b = TransposeConvBlock(256, 128, (3, 3), (2, 2),
                                          dropout_rate, **kw)
        self.decoder = SegDecoder(dropout_rate, **kw)
        self.bn_last = BatchNorm2d(64)
        self.dropout_last = SharedDropout(dropout_rate, TIME_DIM)
        self.conv_last = Conv2d(64, out_class, 1)
        self.inference_model = Linear(n_bins, C.N_KEYS)

    def forward(self, x):
        x, encoder_outputs, encoder_hws = self.encoder(x.permute(0, 3, 1, 2))
        en_l4 = x
        x = self.bn1(F.relu(self.attention_layer1(en_l4)[0]))
        x = self.bn2(F.relu(self.attention_layer2(x)[0]))
        x = self.layer0a(torch.cat([en_l4, x], dim=1)) + en_l4
        x = self.layer0b(x, encoder_hws[-1])
        x = self.decoder(x, encoder_outputs, encoder_hws)
        x = self.conv_last(_pre_act(self.bn_last, self.dropout_last, x))
        return torch.sigmoid(self.inference_model(
            x[:, 0] if self.out_class == 1 else x))


class SemanticSegmentation(TranscriptionModel, SegmentationModule):
    """The segmentation transcriber with its signal chain (the JAX
    package's `SemanticSegmentation`, reference `model/Segmentation.py:
    539-631`), the JAX dataclass's keys with `ReconVAT`'s seed and device.
    `spec` picks the frontend (its bins set the `Linear(n_bins, 88)`);
    `conv_layout` 'auto' is the NHWC-equivalent layout, 'folded' (the JAX
    package's TPU layout) raises; `n_heads` and `reconstruction` are taken
    and unused, as in the JAX package. VAT perturbs the (B, T, F, 1) spec
    image with its norm over the bins, one power iteration. Takes
    sequence parallelism (the layers' halos above)."""

    SEQUENCE_PARALLEL = True

    def __init__(self, out_class: int = 1, dropout_rate: float = 0.4,
                 log: bool = True, mode: str = "imagewise",
                 spec: str = "Mel", xi: float = 1e-6, eps: float = 1e-2,
                 kl_div: bool = False, n_heads: int = 1,
                 reconstruction: bool = False, compute_dtype=None,
                 conv_layout: str = "auto", seed: int = 0, device=None):
        if conv_layout == "folded":
            raise NotImplementedError(
                "conv_layout='folded' is the JAX package's TPU lane-tiling "
                "layout, equal to NHWC; the port runs the NHWC-equivalent "
                "layout only ('auto' or 'nhwc')")
        if conv_layout not in ("auto", "nhwc"):
            raise ValueError(f"unknown conv_layout {conv_layout!r}")
        device = resolve_device(device)
        frontend, n_bins = make_frontend(spec)
        super().__init__(n_bins, out_class, dropout_rate,
                         resolve_compute_dtype(compute_dtype))
        self._init_chain(frontend, n_bins, log, mode,
                         VATConfig(xi=xi, eps=eps, kl_div=kl_div,
                                   norm_axis=2),
                         seed, device)

    vat_target = SegmentationModule.forward

    def run_on_batch(self, batch_l, batch_ul=None, generator=None,
                     vat: bool = False, train: bool = True, t_true=None):
        """The JAX package's `SemanticSegmentation.run_on_batch`:
        batch_l {"audio" (B, N), "frame"}, batch_ul {"audio"} or None, on
        the model's device; returns (predictions, losses, spec (B, T, F)).
        The unlabeled VAT chain runs whenever batch_ul is given, its
        direction drawn first. In training the dropout masks are drawn
        anew from `generator`, once for the step: the VAT chains and the
        supervised forward share them, as the JAX package's forwards
        share one dropout key. t_true masks the spec normalization and
        the frame loss to the true frames (a (B,) tensor: per-row loss
        vectors)."""
        frame_label = batch_l["frame"]
        prefix, mask, zero = self._start(train, generator, t_true,
                                         frame_label.shape[1])

        lds_ul, r_norm_ul = zero, zero
        if batch_ul is not None:
            lds_ul, _, rn = vat_loss(self._transcriber_fn(train),
                                     self.make_spec(batch_ul["audio"]),
                                     generator, self.vat_cfg)
            r_norm_ul = rn.abs().mean()

        spec = self.make_spec(batch_l["audio"], t_true)
        frame_pred = self(spec)
        lds_l, r_adv, r_norm_l = zero, None, zero
        if vat:
            # the supervised forward is the chain's clean prediction: the
            # same masks and batch statistics
            lds_l, r_adv, rn = vat_loss(self._transcriber_fn(train), spec,
                                        generator, self.vat_cfg,
                                        y_ref=frame_pred)
            r_adv = r_adv[..., 0]
            r_norm_l = rn.abs().mean()

        predictions = {"onset": frame_pred, "frame": frame_pred,
                       "r_adv": r_adv}
        losses = {
            f"loss/{prefix}_frame":
                binary_cross_entropy(frame_pred, frame_label, mask),
            f"loss/{prefix}_LDS_l": lds_l,
        }
        if train:
            losses[f"loss/{prefix}_LDS_ul"] = lds_ul
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
            losses[f"loss/{prefix}_r_norm_ul"] = r_norm_ul
        else:
            losses[f"loss/{prefix}_r_norm_l"] = r_norm_l
        return predictions, losses, spec[..., 0]

    @torch.no_grad()
    def transcribe(self, audio, bucket_frames: int = 0):
        """Serving path: onset roll == frame roll, (B, T, 88) or (B,
        out_class, T, 88). bucket_frames > 0 pads the clip to a
        frame-bucket boundary, masks the normalization statistics to the
        true frames and trims the padded tail (on axis 2 for out_class >
        1, where time sits behind the class axis)."""
        self.eval()
        with fp32_math():
            spec, t_true = transcribe_spec(self, audio, bucket_frames)
            roll = self(spec[..., None])
        if bucket_frames:
            roll = roll[..., :t_true, :]
        return {"onset": roll, "frame": roll}

    @torch.no_grad()
    def transcribe_streaming(self, audio, window_frames: int = 640,
                             halo_frames: int = 256,
                             windows_per_batch: int = 1, mesh_ctx=None,
                             pipeline_depth: int = 3):
        """Bounded-memory transcription in haloed windows
        (`models/common.transcribe_streaming`). The receptive field
        exceeds any practical halo (the 17 x 17 attention pair at time / 16
        alone sees +-256 frames), so near window seams the output is an
        approximation of `transcribe`'s; halo 256 covers the attention.
        Returns (B, t_true, 88) fp32 rolls on the host, or (B, out_class,
        t_true, 88)."""
        multi = self.out_class > 1
        self.eval()
        with fp32_math():
            roll = transcribe_streaming(
                self, lambda spec: self(spec).movedim(1, 2) if multi
                else self(spec), audio, window_frames, halo_frames,
                windows_per_batch, mesh_ctx, pipeline_depth)
        if multi:
            roll = roll.movedim(2, 1)
        return {"onset": roll, "frame": roll}

    def load_reference_weights(self, source):
        """`TranscriptionModel.load_reference_weights`, after dropping the
        reference's `conv_skip` of each stride-(1, 1) block, which it
        defines and never calls (`model/Segmentation.py:175-179`); `rel_t`
        and `rel_f` load as they are."""
        sd, _ = read_state_dict(source)
        unused = tuple(f"{name}.conv_skip." for name, m in
                       self.named_modules() if isinstance(m, ConvBlockSeg)
                       and m.stride == (1, 1))
        super().load_reference_weights(
            {k: v for k, v in sd.items() if not k.startswith(unused)})
