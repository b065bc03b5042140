"""Host utilities: piano-roll PNGs and parameter counts (the port's
counterpart of `reconvat_tpu/utils.py`; its `cycle` is
`data.loader.cycle`).

PNGs are written by hand (`zlib` + `struct`), as neither Pillow nor
matplotlib is a dependency of the port. `save_pianoroll` reproduces the
JAX package's Pillow output pixel for pixel: its vertical x`zoom` resize
is Pillow's default filter (bicubic, a = -0.5), in Pillow's own
fixed-point arithmetic (`_pil_bicubic_rows`).
"""
from __future__ import annotations

import struct
import sys
import zlib

import numpy as np


def png_bytes(image) -> bytes:
    """uint8 (H, W) grayscale or (H, W, 3) RGB -> PNG file bytes
    (8 bits per sample, no filtering, no interlace)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim not in (2, 3) or (image.ndim == 3
                                    and image.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3), got {image.shape}")
    h, w = image.shape[:2]
    color_type = 0 if image.ndim == 2 else 2

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, -1)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


_PRECISION_BITS = 32 - 8 - 2      # Pillow's 8-bit resampling precision


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _pil_bicubic_rows(image, out_h: int):
    """uint8 (H, W, C) resized to out_h rows as Pillow's `Image.resize`
    does it with its default (bicubic) filter when the width is unchanged:
    Pillow's `precompute_coeffs`, its coefficients rounded to 22-bit fixed
    point, and its rounding and clipping of each sum."""
    in_h = image.shape[0]
    scale = in_h / out_h
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    out = np.empty((out_h,) + image.shape[1:], np.uint8)
    src = image.astype(np.int64)
    for yy in range(out_h):
        center = (yy + 0.5) * scale
        ymin = max(int(center - support + 0.5), 0)
        ymax = min(int(center + support + 0.5), in_h) - ymin
        k = [_bicubic((y + ymin - center + 0.5) / filterscale)
             for y in range(ymax)]
        ww = sum(k)
        k = [v / ww if ww != 0.0 else v for v in k]
        k = [int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0
             else int(0.5 + v * (1 << _PRECISION_BITS)) for v in k]
        ss = np.full(image.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
        for y, c in enumerate(k):
            ss += src[ymin + y] * c
        out[yy] = np.clip(ss >> _PRECISION_BITS, 0, 255)
    return out


def save_pianoroll(path, onsets, frames, onset_threshold=0.5,
                   frame_threshold=0.5, zoom=4):
    """Piano-roll PNG as the reference's `save_pianoroll`
    (`model/utils.py:61-80`) and the JAX package's: inverted onset/frame/
    both RGB, flipped vertically, x`zoom` vertical resize."""
    onsets = np.asarray(onsets)
    frames = np.asarray(frames)
    onsets = (1 - (onsets.T > onset_threshold).astype(np.uint8))
    frames = (1 - (frames.T > frame_threshold).astype(np.uint8))
    both = 1 - (1 - onsets) * (1 - frames)
    image = (np.stack([onsets, frames, both], axis=2)[::-1] * 255).astype(
        np.uint8)
    if zoom != 1:
        image = _pil_bicubic_rows(image, image.shape[0] * zoom)
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())


def summary(name, model, file=None):
    """Print a parameter-count summary (reference `summary`,
    `model/utils.py:15-58`, without the per-module recursion)."""
    total = param_count(model)
    print(f"{name}: {total:,} params", file=file or sys.stdout)
    return total
