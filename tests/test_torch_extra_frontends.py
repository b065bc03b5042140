"""The port's library frontends (`reconvat_tpu_torch/ops/extra_frontends.py`
and the gammatone helpers of `ops/filterbanks.py`) against the JAX
package's (`reconvat_tpu/ops/extra_frontends.py`), on the CPU.

Criterion (`held`), for each output of each class on the same seeded
input: the port's fp32 output and the JAX package's are each held against
a float64 evaluation, the port's module under `.double()` (complex bases
become complex128, `test_double_reaches_complex128`). The port's largest
error is at most TRUTH_FACTOR (2) x the JAX package's + TRUTH_FLOOR (1e-6)
x max |truth|: both routes compute the same FFTs, products and
convolutions in fp32 in other orders, so neither rounds closer by more
than a small factor (measured ratios 0.4-2.1; MFCC at 22.05 kHz read 2.13,
where the floor decides). The JAX package's own error is at most
JAX_TRUTH_SHARE (1e-5) x max |truth| (measured 1e-7 to 2e-6): the float64
reference is the port's module, so this is what fails a fault the port's
fp32 and float64 routes share (a basis off by a bin, a frame off by a
hop), which moves outputs by a share of their size.

Griffin-Lim is compared elementwise at 4 iterations, with the JAX
package's initial phase draw substituted for the port's
(`GriffinLim.initial_phase`): each momentum step amplifies the rounding
(at 32 iterations the packages' errors against float64 reach 2e-5 of the
output), and the draws differ by design (a JAX PRNG key against a
`torch.Generator`). At 32 iterations the port meets the JAX package's tone
criterion on its own draw (tests/test_extra_frontends.py:77-86).

The settings of `ops/spectrogram.py`'s frontends that the JAX classes
take (`STFT`'s magnitude and `freq_bins`, `MelSpectrogram`'s `center`,
`pad_mode`, `power`, `htk` and `norm`, `CQT1992v2`'s `center` and
`pad_mode`, and `MFCC`'s through its `MelSpectrogram`) are held by the
same criterion, and each `MelSpectrogram`'s route, fixed when it is
built, is checked: the kernel's where `csrc/mel.cu` computes the settings,
else the plain version, where `use_kernel = True` raises. `CQT1992v2`'s
`F.conv1d` route is held by tests/test_torch_cqt_cfp.py's frontend
tolerance instead (`test_cqt1992v2_conv1d_route_padding_matches_jax`).

Clips are 1 s or less and the torch work runs on one thread
(`tests/torch_threads.py`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.ops import extra_frontends as jxf
from reconvat_tpu.ops import filterbanks as jfb
from reconvat_tpu.ops import spectrogram as jspec
from reconvat_tpu_torch.ops import extra_frontends as xf
from reconvat_tpu_torch.ops import filterbanks as fb
from reconvat_tpu_torch.ops import spectrogram as spec
from reconvat_tpu_torch.ops.mel_kernel import mel_power
from reconvat_tpu_torch.ops.mel_kernel import frame_audio

from .torch_threads import torch_one_thread  # noqa: F401

TRUTH_FACTOR, TRUTH_FLOOR, JAX_TRUTH_SHARE = 2.0, 1e-6, 1e-5


def _noise(b=2, n=16384, seed=0):
    return (np.random.RandomState(seed).randn(b, n) * 0.1).astype(np.float32)


def _tone(freq=440.0, n=16384, sr=16000, amp=0.5):
    t = np.arange(n) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None]


def held(name, port, ref, truth):
    """The module docstring's criterion on one output."""
    port, ref, truth = (np.asarray(a, np.float64) for a in (port, ref, truth))
    assert port.shape == ref.shape == truth.shape, (name, port.shape,
                                                    ref.shape, truth.shape)
    assert np.isfinite(port).all(), name
    top = np.abs(truth).max()
    port_err, jax_err = np.abs(port - truth).max(), np.abs(ref - truth).max()
    assert jax_err <= JAX_TRUTH_SHARE * top, (name, jax_err, top)
    assert port_err <= TRUTH_FACTOR * jax_err + TRUTH_FLOOR * top, \
        (name, port_err, jax_err, top)


def _compare(name, jax_mod, port_mod, *inputs, call=None, weight=None):
    """`held` on every output of port_mod against jax_mod on `inputs`
    (numpy), the float64 truth from port_mod.double(); where `weight` is
    given, on the outputs multiplied by it."""
    call = call or (lambda m, *a: m(*a))
    ref = call(jax_mod, *(jnp.asarray(a) for a in inputs))
    got = call(port_mod, *(torch.from_numpy(a) for a in inputs))
    truth = call(port_mod.double(),
                 *(torch.from_numpy(a).double() for a in inputs))
    if not isinstance(got, tuple):
        got, ref, truth = (got,), (ref,), (truth,)
    for i, (a, b, t) in enumerate(zip(got, ref, truth)):
        a, b, t = a.numpy(), np.asarray(b), t.numpy()
        if weight is not None:
            a, b, t = (v * weight for v in (a, b, t))
        held(f"{name}[{i}]", a, b, t)


def test_gammatone_filterbank_matches_jax():
    for args in ((16000, 2048, 64, 20.0, 8000.0), (44100, 1024, 32, 50.0,
                                                   None)):
        np.testing.assert_array_equal(fb.gammatone_filterbank(*args),
                                      jfb.gammatone_filterbank(*args))
    np.testing.assert_array_equal(fb.erb_centre_freqs(20.0, 8000.0, 64),
                                  jfb.erb_centre_freqs(20.0, 8000.0, 64))


@pytest.mark.parametrize("kw", [{}, {"sr": 16000, "n_mels": 64,
                                     "n_mfcc": 30, "top_db": None},
                                {"htk": True}, {"power": 1.0}])
def test_mfcc_matches_jax(kw):
    _compare("MFCC", jxf.MFCC(**kw), xf.MFCC(**kw), _noise())


@pytest.mark.parametrize("kw", [{}, {"freq_bins": 300, "hop_length": 256},
                                {"n_fft": 1024, "center": False},
                                {"pad_mode": "constant"}])
def test_stft_matches_jax(kw):
    """`STFT(...)(x)`, the magnitude, and `.power`; `freq_bins` keeps the
    first bins, and `window` stays the basis' bin 0."""
    port = spec.STFT(**kw)
    _compare("STFT", jspec.STFT(**kw), port, _noise(),
             call=lambda m, a: (m(a), m.power(a)))
    assert port.wcos.shape[1] == kw.get("freq_bins",
                                        kw.get("n_fft", 2048) // 2 + 1)
    assert torch.equal(port.window, port.wcos[:, 0])


# (settings, whether the mel_power kernel computes them)
MEL_SETTINGS = [({"center": False}, False), ({"pad_mode": "constant"}, False),
                ({"power": 1.0}, False), ({"htk": True}, True),
                ({"norm": None}, True)]


@pytest.mark.parametrize("kw,kernel", MEL_SETTINGS)
def test_melspectrogram_settings_match_jax(kw, kernel):
    """Each `MelSpectrogram` setting against the JAX class, and its route,
    fixed when the module is built: the kernel's where the kernel computes
    the settings (`htk` and `norm` change the basis alone), the plain
    version otherwise, where `use_kernel = True` raises ValueError. On a
    CPU tensor either route launches nothing."""
    port = spec.MelSpectrogram(**kw)
    assert port.kernel_computes is kernel and port.use_kernel is kernel
    before = mel_power.launches
    _compare(f"MelSpectrogram {kw}", jspec.MelSpectrogram(**kw), port,
             _noise())
    assert mel_power.launches == before
    port.use_kernel = False
    if kernel:
        port.use_kernel = True
        assert port.use_kernel
    else:
        with pytest.raises(ValueError, match="mel_power kernel computes"):
            port.use_kernel = True
        assert not port.use_kernel


def test_mel_routes_fixed_at_build():
    """n_fft off the kernel's 2048 takes the plain route and refuses the
    kernel's; a model's `use_kernels` switch moves its default frontend
    both ways; an MFCC takes its `MelSpectrogram`'s route."""
    assert spec.MelSpectrogram().use_kernel
    short = spec.MelSpectrogram(n_fft=1024)
    assert not short.kernel_computes and not short.use_kernel
    with pytest.raises(ValueError, match="n_fft=1024"):
        short.use_kernel = True
    frontend, _ = spec.make_frontend("Mel")
    assert frontend.use_kernel
    assert xf.MFCC(htk=True).melspec.use_kernel
    assert not xf.MFCC(power=1.0).melspec.use_kernel


@pytest.mark.parametrize("kw", [{"center": False}, {"pad_mode": "constant"}])
def test_cqt1992v2_padding_matches_jax(kw):
    """`CQT1992v2` without centre padding, and with zeros for it, on its
    chunked route (hop 512 divides the kernel width)."""
    port = spec.CQT1992v2(**kw)
    assert port.chunks is not None
    _compare(f"CQT1992v2 {kw}", jspec.CQT1992v2(**kw), port,
             _noise(n=32768))


@pytest.mark.parametrize("kw", [{"center": False}, {"pad_mode": "constant"}])
def test_cqt1992v2_conv1d_route_padding_matches_jax(kw):
    """The same settings on the `F.conv1d` route (hop 500), held by
    tests/test_torch_cqt_cfp.py's frontend tolerance (rtol 1e-4, atol 1e-5
    x the largest output): the CPU's fp32 `F.conv1d` over 16,384 taps
    rounds further from float64 than XLA's convolution (1.1e-6 of a 0.40
    peak, 8.6x the JAX package's error), past this file's factor of 2."""
    kw = dict(kw, hop_length=500)
    port = spec.CQT1992v2(**kw)
    assert port.chunks is None
    x = _noise(n=32768)
    got = port(torch.from_numpy(x)).numpy()
    ref = np.asarray(jspec.CQT1992v2(**kw)(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_mfcc_route_is_fixed_when_built():
    """The kernel route where `csrc/mel.cu` computes the DFT length (2048
    points), the plain route at any other; on a CPU tensor both run the
    plain version and launch nothing."""
    mfcc, short = xf.MFCC(), xf.MFCC(n_fft=1024)
    assert mfcc.melspec.use_kernel and not short.melspec.use_kernel
    before = mel_power.launches
    x = _noise(1, 8192)
    _compare("MFCC n_fft=1024", jxf.MFCC(n_fft=1024), short, x)
    mfcc(torch.from_numpy(x))
    assert mel_power.launches == before


@pytest.mark.parametrize("kw", [{}, {"sr": 16000, "center": False},
                                {"sr": 16000, "pad_mode": "constant",
                                 "power": 1.0}])
def test_gammatonegram_matches_jax(kw):
    _compare("Gammatonegram", jxf.Gammatonegram(**kw),
             xf.Gammatonegram(**kw), _noise())


@pytest.mark.parametrize("kw", [{}, {"n_fft": 1024, "hop_length": 256,
                                     "pad_mode": "constant"}])
def test_dft_and_inverse_match_jax(kw):
    x = _noise()
    _compare("DFT", jxf.DFT(**kw), xf.DFT(**kw), x)
    _compare("DFT.inverse", jxf.DFT(**kw), xf.DFT(**kw), x,
             call=lambda m, a: m.inverse(*m(a), length=a.shape[1]))
    rec = xf.DFT(**kw).inverse(*xf.DFT(**kw)(torch.from_numpy(x)),
                               length=x.shape[1])
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("hop,center,length", [(512, True, None),
                                               (300, True, 9000),
                                               (256, False, 5000)])
def test_overlap_add_matches_jax(hop, center, length):
    """`overlap_add` (F.fold) against the JAX function (its strided-row
    branch where hop divides N, its loop over frames otherwise)."""
    rng = np.random.RandomState(1)
    frames = rng.randn(2, 21, 1024).astype(np.float32)
    win = fb.pad_center(fb.get_window("hann", 1024), 1024).astype(np.float32)
    got = xf.overlap_add(torch.from_numpy(frames), hop, torch.from_numpy(win),
                         1024, center, length)
    ref = jxf.overlap_add(jnp.asarray(frames), hop, jnp.asarray(win), 1024,
                          center, length)
    truth = xf.overlap_add(torch.from_numpy(frames).double(), hop,
                           torch.from_numpy(win).double(), 1024, center,
                           length)
    held("overlap_add", got.numpy(), ref, truth.numpy())


@pytest.mark.parametrize("onesided", [True, False])
def test_istft_matches_jax(onesided):
    x = torch.from_numpy(_noise())
    port = xf.ISTFT()
    frames = frame_audio(x, 2048, 512) * port.window
    spec = (torch.fft.rfft(frames, dim=-1) if onesided
            else torch.fft.fft(frames, dim=-1))
    parts = (spec.real.numpy(), spec.imag.numpy())
    _compare("ISTFT", jxf.ISTFT(), port, *parts,
             call=lambda m, re, im: m(re, im, onesided=onesided,
                                      length=x.shape[1]))
    rec = xf.ISTFT()(*(torch.from_numpy(p) for p in parts),
                     onesided=onesided, length=x.shape[1])
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-5)


def _griffin_lim_input(n_iter):
    x = _tone(n=8192, freq=523.25)
    gl = jxf.GriffinLim(n_fft=1024, hop_length=256, n_iter=n_iter)
    mag = np.abs(np.asarray(gl._stft_complex(jnp.asarray(x))))
    return x, gl, mag.astype(np.float32)


def test_griffin_lim_matches_jax_on_its_draw():
    x, jgl, mag = _griffin_lim_input(4)
    draw = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                         minval=-np.pi, maxval=np.pi))
    port = xf.GriffinLim(n_fft=1024, hop_length=256, n_iter=4)
    port.initial_phase = lambda shape, generator, like: \
        torch.tensor(draw).to(like.device, like.dtype)
    _compare("GriffinLim", jgl, port, mag,
             call=lambda m, a: m(a, length=x.shape[1]))


def test_griffin_lim_reconstructs_tone():
    """The JAX package's criterion on the port's own draw: the rebuilt
    signal's spectrum magnitude within 15 % (relative norm)."""
    x, _, mag = _griffin_lim_input(32)
    gl = xf.GriffinLim(n_fft=1024, hop_length=256, n_iter=32)
    rec = gl(torch.from_numpy(mag), torch.Generator().manual_seed(3),
             length=x.shape[1])
    mag_rec = gl._stft_complex(rec).abs().numpy()
    err = np.linalg.norm(mag_rec - mag) / np.linalg.norm(mag)
    assert err < 0.15, err


@pytest.mark.parametrize("output_format", ["Magnitude", "Complex", "Phase"])
def test_cqt1992_matches_jax(output_format):
    """At the JAX defaults but n_bins=60: 84 bins from 220 Hz pass the
    Nyquist frequency of 22.05 kHz, and both packages refuse it."""
    with pytest.raises(ValueError, match="Nyquist"):
        xf.CQT1992()
    x = _noise()
    _compare("CQT1992", jxf.CQT1992(n_bins=60), xf.CQT1992(n_bins=60), x,
             call=lambda m, a: m(a, output_format=output_format),
             weight=_cqt_magnitude_share(x) if output_format == "Phase"
             else None)


def _cqt_magnitude_share(x):
    """CQT1992's float64 magnitude over its largest, per bin: rounding
    moves a bin's complex value by about the same amount whatever its
    size, so its phase by that over its magnitude, and the Phase output is
    held weighted by this share."""
    mag = xf.CQT1992(n_bins=60).double()(torch.from_numpy(x).double())
    return (mag / mag.max()).numpy()[..., None]


@pytest.mark.parametrize("output_format", ["Magnitude", "Complex"])
def test_cqt2010_matches_jax(output_format):
    _compare("CQT2010", jxf.CQT2010(), xf.CQT2010(), _noise(),
             call=lambda m, a: m(a, output_format=output_format))


def test_cqt2010_early_downsampling_matches_jax():
    """A top octave far below Nyquist: the early x2^k downsampling (a
    firwin2 lowpass at stride 2^k) runs first."""
    kw = dict(sr=16000, hop_length=512, fmin=32.7, n_bins=36)
    port = xf.CQT2010(**kw)
    assert port.early_factor > 1 and port.early_filter is not None
    _compare("CQT2010 early", jxf.CQT2010(**kw), port, _noise())


def test_cqt2010v2_matches_jax():
    _compare("CQT2010v2", jxf.CQT2010v2(), xf.CQT2010v2(), _noise(n=32768))


def test_double_reaches_complex128():
    """`.double()` casts the complex bases' real and imaginary buffers, so
    the float64 truth multiplies in complex128; fp32 stays complex64."""
    x = torch.from_numpy(_noise(1, 8192))
    cqt = xf.CQT1992(n_bins=60)
    assert cqt._complex(x).dtype == torch.complex64
    assert cqt.double()._complex(x.double()).dtype == torch.complex128
    v1 = xf.CQT2010().double()
    assert v1._octave(x.double(), v1.hop_length).dtype == torch.complex128
    assert all(b.dtype == torch.float64 for b in v1.buffers())
    re, im = xf.DFT().double()(x.double())
    assert re.dtype == im.dtype == torch.float64
