"""Port's mel frontend and signal chain vs the JAX package, on the CPU.

Tolerances:
- mel power: rtol 1e-4 (atol 1e-7), the bound the JAX package holds its own
  Pallas kernel to against XLA (tests/test_pallas_mel.py); both sides are
  fp32 but sum the 2048-term DFT and the 1025-term mel projection in a
  different order.
- normalized log-spec: atol 1e-4; log(x+1e-5) of near-zero bins amplifies
  the relative mel error, and min-max scaling maps it into [0, 1].
The kernel-against-plain test is in tests/test_torch_kernels.py.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reconvat_tpu.models import common as jcommon
from reconvat_tpu.ops import normalize as jnorm
from reconvat_tpu.ops.pallas_mel import PallasMelSpectrogram
from reconvat_tpu.ops.spectrogram import make_frontend as jax_make_frontend
from reconvat_tpu_torch.models import common as tcommon
from reconvat_tpu_torch.ops import mel_kernel
from reconvat_tpu_torch.ops import normalize as tnorm
from reconvat_tpu_torch.ops.spectrogram import make_frontend

MEL_RTOL, MEL_ATOL = 1e-4, 1e-7
SPEC_ATOL = 1e-4


def _audio(B, n, seed=0):
    return (np.random.RandomState(seed).randn(B, n) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n", [64 * 512 - 1, 10000])
def test_mel_matches_jax(n):
    x = _audio(2, n)
    ref = np.asarray(jax_make_frontend("Mel")[0](jnp.asarray(x)))
    fe, n_bins = make_frontend("Mel")
    got = fe(torch.from_numpy(x)).numpy()
    assert n_bins == 229 and got.shape == ref.shape == (2, n // 512 + 1, 229)
    np.testing.assert_allclose(got, ref, rtol=MEL_RTOL, atol=MEL_ATOL)


def test_mel_matches_jax_pallas_interpret():
    x = _audio(1, 10000, seed=3)
    pallas = PallasMelSpectrogram(sr=16000, n_fft=2048, win_length=2048,
                                  n_mels=229, hop_length=512, fmin=30,
                                  fmax=8000)
    ref = np.asarray(pallas(jnp.asarray(x)))
    fe, _ = make_frontend("Mel")
    got = fe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=MEL_RTOL, atol=MEL_ATOL)


def test_mel_plain_and_wrapper_agree_on_cpu():
    """On a CPU tensor the wrapper is its plain version, bit for bit, and
    launches nothing."""
    fe, _ = make_frontend("Mel")
    x = torch.from_numpy(_audio(2, 6000, seed=1))
    before = mel_kernel.mel_power.launches
    a = mel_kernel.mel_power(x, fe.stft.wcos, fe.stft.wsin, fe.mel_basis, 512,
                             fe.stft.window, fe.twiddle, fe.band)
    b = mel_kernel.mel_power_plain(x, fe.stft.wcos, fe.stft.wsin,
                                   fe.mel_basis, 512)
    assert torch.equal(a, b)
    assert mel_kernel.mel_power.launches == before
    # STFT.power + mel matmul is the same function
    c = fe.stft.power(x) @ fe.mel_basis
    np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6)


def _jax_chain_model():
    return types.SimpleNamespace(frontend=jax_make_frontend("Mel")[0],
                                 log=True,
                                 normalize=jnorm.Normalization("imagewise"))


def _torch_chain_model():
    return types.SimpleNamespace(frontend=make_frontend("Mel")[0], log=True,
                                 normalize=tnorm.Normalization("imagewise"))


@pytest.mark.parametrize("n,bucket", [(64 * 512, 0), (512 * 41 + 77, 32)])
def test_normalized_log_spec_matches_jax(n, bucket):
    x = _audio(2, n, seed=2)
    ref, t_ref = jcommon.transcribe_spec(_jax_chain_model(), jnp.asarray(x),
                                         bucket)
    got, t_got = tcommon.transcribe_spec(_torch_chain_model(),
                                         torch.from_numpy(x), bucket)
    assert t_got == t_ref
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SPEC_ATOL)


def test_chain_helpers_match_jax():
    for t in (1, 639, 640, 641, 20480, 20481, 50000):
        assert tcommon.next_bucket(t) == jcommon.next_bucket(t)
    for n in (512, 327679, 327680, 327681):
        assert tcommon.frames_in(n) == jcommon.frames_in(n)
    x = _audio(2, 512 * 20 + 3, seed=4)
    ref = jcommon.pad_audio_to_frames(x, 32)
    got = tcommon.pad_audio_to_frames(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(got.numpy(), ref)
    mask = tcommon.frame_mask(5, 8)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jcommon.frame_mask(5, 8)))


@pytest.mark.parametrize("mode", ["framewise", "imagewise"])
def test_normalization_matches_jax(mode):
    x = np.random.RandomState(5).randn(2, 12, 9).astype(np.float32)
    x[0, 3] = 1.5                      # a constant frame: framewise NaN -> 0
    mask = np.arange(12) < 9
    for m in (None, mask):
        ref = jnorm.Normalization(mode)(
            jnp.asarray(x), None if m is None else jnp.asarray(m))
        got = tnorm.Normalization(mode)(
            torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)

