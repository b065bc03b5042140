"""Shared signal-chain and bucketing helpers (PyTorch counterpart of
`reconvat_tpu/models/common.py:25-147`).

The bucketed path pads a clip to a frame-bucket boundary; the spectrogram
normalization statistics are masked to the true frames, and the caller
trims predictions to them. Outputs then differ from the exact path only
inside the network's receptive-field halo at the clip end.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import constants as C

# Doubling ladder of frame counts for full songs; longer songs extend it by
# further doubling.
BUCKET_LADDER = (640, 1280, 2560, 5120, 10240, 20480)


def next_bucket(t_true: int, ladder=BUCKET_LADDER) -> int:
    for b in ladder:
        if t_true <= b:
            return b
    b = ladder[-1]
    while b < t_true:
        b *= 2
    return b


def frames_in(n_samples: int) -> int:
    """Frame count of the signal chain for an n-sample clip (the chain drops
    the final sample: 327680 samples -> 640 frames, reference
    `model/self_attention_VAT.py:1112`)."""
    return (n_samples - 1) // C.HOP_LENGTH + 1


def frame_mask(t_true: int, n_frames: int, device=None) -> torch.Tensor:
    """Boolean (n_frames,) mask of the true (unpadded) frames."""
    return torch.arange(n_frames, device=device) < t_true


def make_log_spec(model, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, N) float in [-1, 1] -> un-normalized log-spec (B, T, F):
    frontend on audio[:, :-1] (the chain drops the final sample) ->
    log(x + 1e-5)."""
    spec = model.frontend(audio[:, :-1])
    if model.log:
        spec = torch.log(spec + 1e-5)
    return spec


def make_log_norm_spec(model, audio, t_true=None) -> torch.Tensor:
    """audio (B, N) -> normalized log-spec (B, T, F); with t_true the
    normalization statistics cover only the true frames."""
    spec = make_log_spec(model, audio)
    mask = (None if t_true is None
            else frame_mask(t_true, spec.shape[1], spec.device))
    return model.normalize(spec, mask)


def pad_audio_to_frames(audio: torch.Tensor, t_pad: int) -> torch.Tensor:
    """Right-pad (B, N) audio so the signal chain yields exactly t_pad
    frames. The pad starts with a reflection of audio[:, :-1] (what the
    frontend's centre padding synthesizes there on the exact path, so frames
    below t_true match it), then zeros, then one trailing sample for the
    chain to drop."""
    n_pad = t_pad * C.HOP_LENGTH
    n = audio.shape[1]
    if n > n_pad:
        raise ValueError(f"{n} samples exceed {t_pad} frames")
    if n == n_pad:
        return audio
    x = audio[:, :-1]
    pad = (n_pad - 1) - x.shape[1]
    r = min(pad, x.shape[1] - 1)
    out = F.pad(x[:, None], (0, r), mode="reflect")[:, 0]
    return F.pad(out, (0, pad - r + 1))


def pack_roll_device(probs: torch.Tensor, threshold: float = 0.5):
    """Threshold a (B, T, P) posteriogram (strict > threshold) and bit-pack
    it on the device: bit j of byte k = pitch k*8+j (little bit order).
    Returns (B, T, ceil(P/8)) uint8."""
    B, T, P = probs.shape
    K = -(-P // 8)
    bits = (probs > threshold).to(torch.uint8)
    bits = F.pad(bits, (0, K * 8 - P)).reshape(B, T, K, 8)
    # shifts made on the device: a tensor built from a host list would be a
    # pageable copy, which waits for the stream and stalls the pipeline
    shifts = torch.arange(8, dtype=torch.uint8, device=probs.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.uint8)


def transcribe_spec(model, audio, bucket_frames: int = 0):
    """Serving-path spec preparation: returns (spec (B, T, F), t_true or
    None). bucket_frames > 0 pads the clip to a frame-bucket boundary; the
    caller trims the returned rolls to t_true."""
    if not bucket_frames:
        return make_log_norm_spec(model, audio), None
    t_true = frames_in(audio.shape[1])
    t_pad = -(-t_true // bucket_frames) * bucket_frames
    audio = pad_audio_to_frames(audio, t_pad)
    return make_log_norm_spec(model, audio, t_true), t_true
