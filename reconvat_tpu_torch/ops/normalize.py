"""Batchwise min-max spectrogram normalization (PyTorch counterpart of
`reconvat_tpu/ops/normalize.py`, reference `model/utils.py:82-106`).

'framewise' normalizes each time frame across bins (NaN -> 0 when a frame
is constant); 'imagewise' normalizes each spectrogram by its global min/max,
optionally over the true frames of a padded clip only. Time-major (B, T, F).
"""
from __future__ import annotations

import torch


def normalize_framewise(x: torch.Tensor, frame_mask=None) -> torch.Tensor:
    # per-frame statistics: padded frames cannot perturb true frames, so
    # frame_mask is accepted for interface parity only
    del frame_mask
    x_max = x.amax(dim=-1, keepdim=True)
    x_min = x.amin(dim=-1, keepdim=True)
    return torch.nan_to_num((x - x_min) / (x_max - x_min), nan=0.0)


def normalize_imagewise(x: torch.Tensor, frame_mask=None) -> torch.Tensor:
    """frame_mask (bool, (frames,), or (batch, frames) for a mask per row)
    restricts the min/max statistics to the true frames of a padded
    spectrogram."""
    dims = tuple(range(1, x.dim()))
    if frame_mask is None:
        x_max = x.amax(dim=dims, keepdim=True)
        x_min = x.amin(dim=dims, keepdim=True)
    else:
        m = frame_mask if frame_mask.dim() == 2 else frame_mask[None]
        m = m.reshape(m.shape + (1,) * (x.dim() - 2))
        x_max = torch.where(m, x, -torch.inf).amax(dim=dims, keepdim=True)
        x_min = torch.where(m, x, torch.inf).amin(dim=dims, keepdim=True)
    return (x - x_min) / (x_max - x_min)


class Normalization:
    def __init__(self, mode: str = "framewise"):
        if mode == "framewise":
            self.normalize = normalize_framewise
        elif mode == "imagewise":
            self.normalize = normalize_imagewise
        else:
            raise ValueError(f"unknown normalization mode: {mode}")
        self.mode = mode

    def __call__(self, x: torch.Tensor, frame_mask=None) -> torch.Tensor:
        return self.normalize(x, frame_mask)
