"""The fused STFT power and mel projection (`mel_power`, one call per
(B, N) batch): the least work these inputs need, as `chip_smoke.py`
phase 2 counts it: a real FFT per frame (about 1.25 n log2 n operations)
and a multiply-add per nonzero of the mel basis; audio, window and basis
read once, the output written once, 4 bytes an element."""
from __future__ import annotations

import math


def mel(batch: int, samples: int, n_fft: int = 2048, hop: int = 512,
        n_mels: int = 229, basis_nonzeros: int = 2025):
    """(flops, bytes) of one call on (batch, samples) audio; the chain
    drops the final sample, so `samples - 1` are read."""
    n = samples - 1
    frames = n // hop + 1
    flops = batch * frames * (1.25 * n_fft * math.log2(n_fft)
                              + 2 * basis_nonzeros)
    nbytes = 4 * (batch * n + n_fft + (n_fft // 2 + 1) * n_mels
                  + batch * frames * n_mels)
    return flops, nbytes
