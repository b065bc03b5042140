"""Stage audio corpora as the 16 kHz mono wav files the datasets read (the
port's counterpart of `tools/preprocess_audio.py`, reference
`Preprocessing.ipynb`): decode (scipy wav, the native FLAC decoder),
polyphase resampling to 16 kHz (scipy), 16-bit wav out; no ffmpeg.

    python -m reconvat_tpu_torch.preprocess_audio --out-dir data16k \\
        src/*.flac src/*.wav

`--dummy-tsv` also writes the notebook's placeholder labels (five
(60, 60, 60, 60) rows) beside each output: how the unlabeled corpora
(`ApplicationWind`, the `_ul` splits) are staged for the semi-supervised
loaders, which never read those labels as supervision.
"""
from __future__ import annotations

import argparse
import os
from math import gcd

import numpy as np

from . import constants as C
from .data.audio_io import read_audio, write_wav


def resample_to_16k(pcm: np.ndarray, sr: int) -> np.ndarray:
    """int16 pcm at `sr` Hz -> int16 pcm at 16 kHz (itself when `sr` is
    16 kHz already)."""
    from scipy.signal import resample_poly

    if sr == C.SAMPLE_RATE:
        return pcm
    g = gcd(C.SAMPLE_RATE, sr)
    out = resample_poly(pcm.astype(np.float64), C.SAMPLE_RATE // g, sr // g)
    return np.clip(out, -32768, 32767).astype(np.int16)


def write_dummy_tsv(path: str) -> None:
    """Placeholder labels for unlabeled VAT data (the notebook's last
    cell): five identical (onset=60, offset=60, note=60, velocity=60)
    rows."""
    np.savetxt(path, np.full((5, 4), 60.0), "%.6f", "\t",
               header="onset\toffset\tnote\tvelocity")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m reconvat_tpu_torch.preprocess_audio")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--dummy-tsv", action="store_true",
                    help="also write a placeholder .tsv per file "
                         "(unlabeled-VAT staging, Preprocessing.ipynb)")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.inputs:
        pcm, sr = read_audio(path)
        pcm = resample_to_16k(pcm, sr)
        base = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out_dir, base + ".wav")
        write_wav(out, pcm, C.SAMPLE_RATE)
        if args.dummy_tsv:
            write_dummy_tsv(os.path.join(args.out_dir, base + ".tsv"))
        print(f"{path} ({sr} Hz) -> {out} (16000 Hz, "
              f"{len(pcm) / 16000:.1f} s)")


if __name__ == "__main__":
    main()
