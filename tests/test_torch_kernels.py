"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py

The kernel tests carry the `cuda` marker and skip without a CUDA device;
the wrapper-argument checks run anywhere.

Tolerances: mel power rtol 1e-4 (atol 1e-6), attention out and probs
atol 1e-5 (rtol 1e-4): fp32 on both sides, different summation orders.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reconvat_tpu_torch.kernels import _build
from reconvat_tpu_torch.ops import banded_attention_kernel as bak
from reconvat_tpu_torch.ops import mel_kernel
from reconvat_tpu_torch.ops.spectrogram import make_frontend

MEL_TOL = dict(rtol=1e-4, atol=1e-6)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attn_inputs(L, window, Dh, B=2, H=4, seed=4):
    g = torch.Generator().manual_seed(seed)
    hw = (window - 1) // 2
    q = torch.randn((B, L, H, Dh), generator=g) * Dh ** -0.25
    k = torch.randn((B, L, H, Dh), generator=g) * Dh ** -0.25
    v = torch.randn((B, L, H, Dh), generator=g)
    rel = torch.randn((H, Dh, window), generator=g) * 0.1
    pad = (0, 0, 0, 0, hw, hw)
    return q, F.pad(k, pad), F.pad(v, pad), rel


@pytest.mark.parametrize("name,shape,bad", [
    ("dtype", (2, 3), torch.zeros((2, 3), dtype=torch.float64)),
    ("shape", (2, 3), torch.zeros((3, 2))),
    ("contiguous", (2, 3), torch.zeros((3, 2)).t()),
])
def test_check_tensor_rejects(name, shape, bad):
    with pytest.raises((TypeError, ValueError)):
        _build.check_tensor(name, bad, shape, torch.device("cpu"))
    _build.check_tensor(name, torch.zeros(shape), shape, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64 * 512 - 1, 10000])   # 64 frames, ragged 20
def test_mel_kernel_matches_plain(cuda_device, n):
    fe, _ = make_frontend("Mel")
    fe = fe.to(cuda_device)
    x = torch.from_numpy((np.random.RandomState(6).randn(3, n)
                          * 0.1).astype(np.float32)).to(cuda_device)
    args = (fe.stft.wcos, fe.stft.wsin, fe.mel_basis, 512)
    before = mel_kernel.mel_power.launches
    got = mel_kernel.mel_power(x, *args)
    torch.cuda.synchronize()
    assert mel_kernel.mel_power.launches == before + 1
    ref = mel_kernel.mel_power_plain(x, *args)
    torch.testing.assert_close(got, ref, **MEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L,window,Dh,with_rel", [(100, 31, 229, True),
                                                  (33, 7, 57, True),
                                                  (40, 15, 64, False)])
def test_attention_kernel_matches_plain(cuda_device, L, window, Dh,
                                        with_rel):
    q, kpad, vpad, rel = (t.to(cuda_device)
                          for t in _attn_inputs(L, window, Dh))
    rel = rel if with_rel else None
    before = bak.banded_attention_fwd.launches
    out, probs = bak.banded_attention_fwd(q, kpad, vpad, rel, window)
    torch.cuda.synchronize()
    assert bak.banded_attention_fwd.launches == before + 1
    ref_out, ref_probs = bak.banded_attention(q, kpad, vpad, rel, window)
    torch.testing.assert_close(out, ref_out, **ATTN_TOL)
    torch.testing.assert_close(probs, ref_probs, **ATTN_TOL)
