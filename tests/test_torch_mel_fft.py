"""The FFT route of the port's mel frontend, on the CPU.

`mel_power_fft_plain` is the step-by-step PyTorch model of the CUDA kernel
`csrc/mel.cu` (frames, window, Stockham passes with the kernel's twiddle
table, power, mel sum over each column's nonzero rows). Here its parts are
held against `torch.fft`, and the whole against `mel_power_plain` and the
JAX package. Inputs come from numpy seeds.

Tolerances:
- Stockham passes against `torch.fft.fft`: 1e-4 of the row's largest
  |value| in float32 (measured ~2e-7), 1e-10 in float64 (measured ~1e-15).
- mel power: rtol 1e-4 (atol 1e-7), the bound tests/test_torch_frontend.py
  holds the port's DFT-matmul version to; both sides are fp32 and sum in
  different orders.
The kernel-against-model test is in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reconvat_tpu.ops.pallas_mel import PallasMelSpectrogram
from reconvat_tpu.ops.spectrogram import make_frontend as jax_make_frontend
from reconvat_tpu_torch.ops import mel_kernel as mk
from reconvat_tpu_torch.ops.spectrogram import make_frontend

MEL_RTOL, MEL_ATOL = 1e-4, 1e-7


def _audio(B, n, seed=0):
    return (np.random.RandomState(seed).randn(B, n) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def frontend():
    return make_frontend("Mel")[0]


@pytest.mark.parametrize("rows", ["noise", "impulses", "tones"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_stockham_passes_match_torch_fft(dtype, tol, rows):
    rng = np.random.RandomState(7)
    if rows == "noise":
        z = rng.randn(6, 2048) + 1j * rng.randn(6, 2048)
    elif rows == "impulses":     # one nonzero input: every output bin is hit
        z = np.zeros((6, 2048), dtype=np.complex128)
        z[np.arange(6), [0, 1, 511, 1024, 1365, 2047]] = 1 + 0.5j
    else:                        # one nonzero output bin each
        bins = np.array([0, 1, 3, 1024, 1025, 2047])[:, None]
        z = np.exp(2j * np.pi * bins * np.arange(2048) / 2048)
    z = torch.from_numpy(z)
    z = z.to(torch.complex64 if dtype == torch.float32 else torch.complex128)
    got = mk.stockham_fft(z, mk.fft_twiddles(2048, dtype))
    ref = torch.fft.fft(z)
    err = (got - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)
    assert err.max().item() < tol


def test_stockham_rejects_radices_of_another_length():
    """The passes are the kernel's, for rows of 2048 only."""
    assert mk.KERNEL_N_FFT == 2048
    z = torch.zeros((1, 1024), dtype=torch.complex64)
    with pytest.raises(ValueError, match="rows of 2048"):
        mk.stockham_fft(z, mk.fft_twiddles(1024))


def test_twiddle_table_is_float64_rounded_once():
    tw = mk.fft_twiddles(2048)
    k = np.arange(1024) * (2 * np.pi / 2048)
    ref = np.stack([np.cos(k), -np.sin(k)], axis=1).astype(np.float32)
    assert tw.dtype == torch.float32 and tuple(tw.shape) == (1024, 2)
    np.testing.assert_array_equal(tw.numpy(), ref)


def test_window_buffer_is_bin_zero_of_cos_basis(frontend):
    stft = frontend.stft
    assert torch.equal(stft.window, stft.wcos[:, 0])
    assert "stft.window" not in frontend.state_dict()


def test_band_covers_every_nonzero_of_slaney_basis(frontend):
    basis = frontend.mel_basis
    band = mk.mel_band(basis)
    assert band.dtype == torch.int32 and tuple(band.shape) == (229, 2)
    rows = torch.arange(basis.shape[0])[:, None]
    inside = (rows >= band[:, 0]) & (rows < band[:, 1])
    assert not (basis != 0)[~inside].any()
    # the filters are triangles: the band holds no interior zero, so the
    # range-limited sum does 2,025 of the dense 1025 x 229 multiplications
    assert int((band[:, 1] - band[:, 0]).sum()) == int((basis != 0).sum())
    assert int((band[:, 1] - band[:, 0]).max()) < 32


def test_band_of_dense_and_empty_columns():
    basis = torch.from_numpy(np.random.RandomState(8).rand(33, 5) + 0.1)
    basis[:, 2] = 0
    basis[:4, 3] = 0
    basis[30:, 3] = 0
    assert mk.mel_band(basis).tolist() == [[0, 33], [0, 33], [0, 0],
                                           [4, 30], [0, 33]]


@pytest.mark.parametrize("kind", ["slaney", "dense"])
def test_banded_mel_sum_equals_dense_product(frontend, kind):
    rng = np.random.RandomState(9)
    power = torch.from_numpy(rng.rand(2, 7, 1025).astype(np.float32))
    basis = (frontend.mel_basis if kind == "slaney" else
             torch.from_numpy(rng.rand(1025, 12).astype(np.float32)))
    got = mk.banded_mel_sum(power, basis, mk.mel_band(basis))
    np.testing.assert_allclose(got.numpy(), (power @ basis).numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_frames", [6, 7])
def test_two_frames_per_fft_match_one(frontend, n_frames):
    """Packing frames 2i, 2i+1 as real and imaginary part of one FFT gives
    the power spectrum of each frame alone (`torch.fft.rfft`), odd frame
    counts included."""
    frames = torch.from_numpy(np.random.RandomState(10).randn(
        2, n_frames, 2048).astype(np.float32)) * frontend.stft.window
    one = torch.fft.rfft(frames.double()).abs().square()
    two = mk.fft_power(frames, mk.fft_twiddles(2048))
    assert one.shape == two.shape == (2, n_frames, 1025)
    assert ((one - two).abs().max() / one.abs().max()).item() < 1e-5


@pytest.mark.parametrize("n", [64 * 512 - 1, 10000])
def test_mel_fft_plain_matches_plain(frontend, n):
    x = torch.from_numpy(_audio(2, n, seed=11))
    stft = frontend.stft
    ref = mk.mel_power_plain(x, stft.wcos, stft.wsin, frontend.mel_basis, 512)
    got = mk.mel_power_fft_plain(x, stft.window, frontend.mel_basis, 512)
    assert got.shape == ref.shape == (2, n // 512 + 1, 229)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=MEL_RTOL,
                               atol=MEL_ATOL)


def test_mel_fft_plain_in_float64_matches_plain(frontend):
    """In float64 the FFT route and the DFT matmuls agree to 1e-6 of the
    largest value: what is left is the float32 rounding of the constants
    (each entry of the cos/sin bases on one side, the window on the other),
    not the arithmetic."""
    x = torch.from_numpy(_audio(1, 10000, seed=12)).double()
    stft = frontend.stft
    ref = mk.mel_power_plain(x, stft.wcos.double(), stft.wsin.double(),
                             frontend.mel_basis.double(), 512)
    got = mk.mel_power_fft_plain(x, stft.window.double(),
                                 frontend.mel_basis.double(), 512)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-6


@pytest.mark.parametrize("n", [64 * 512 - 1, 10000])
def test_mel_fft_plain_matches_jax(frontend, n):
    x = _audio(2, n)
    ref = np.asarray(jax_make_frontend("Mel")[0](jnp.asarray(x)))
    got = mk.mel_power_fft_plain(torch.from_numpy(x), frontend.stft.window,
                                 frontend.mel_basis, 512).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=MEL_RTOL, atol=MEL_ATOL)


def test_mel_fft_plain_matches_jax_pallas_interpret(frontend):
    x = _audio(1, 10000, seed=3)
    pallas = PallasMelSpectrogram(sr=16000, n_fft=2048, win_length=2048,
                                  n_mels=229, hop_length=512, fmin=30,
                                  fmax=8000)
    ref = np.asarray(pallas(jnp.asarray(x)))
    got = mk.mel_power_fft_plain(torch.from_numpy(x), frontend.stft.window,
                                 frontend.mel_basis, 512).numpy()
    np.testing.assert_allclose(got, ref, rtol=MEL_RTOL, atol=MEL_ATOL)


def test_kernel_tables_are_made_once_per_basis(frontend):
    """What the kernel reads in place of the bases is derived when the
    frontend is built, follows the module and stays out of its state."""
    assert torch.equal(frontend.twiddle, mk.fft_twiddles(2048))
    assert torch.equal(frontend.band, mk.mel_band(frontend.mel_basis))
    assert frontend.band.dtype == torch.int32
    buffers = dict(frontend.named_buffers())
    assert {"twiddle", "band", "stft.window"} <= set(buffers)
    assert not {"twiddle", "band"} & set(frontend.state_dict())
    twiddle, band = frontend.twiddle, frontend.band
    frontend(torch.from_numpy(_audio(1, 4096)))
    assert frontend.twiddle is twiddle and frontend.band is band
