"""The CQT and CFP frontends (`reconvat_tpu_torch/ops/spectrogram.py`) and
ReconVAT on them against the JAX package, on the CPU.

Audio from numpy seeds: CQT at 40 frames (its reflect pad is 16,384
samples, so a clip needs more), CFP at 8 frames. Tolerances:
- frontends against the JAX package's on the same fp32 audio: rtol 1e-4,
  atol 1e-5 x the largest output. Both are fp32; CQT sums 64 chunked
  products (cuBLAS or oneDNN against XLA) and CFP takes three real FFTs
  in another order (read: 5e-7 and 2e-6 of the largest output).
- the size of that fp32 error: each package's fp32 frontend against the
  port's frontend in float64, the port's error at most 2x the JAX
  package's plus 1e-6 of the largest output (the JAX package's own
  float64 CFP oracle holds its CFP at rtol 2e-3,
  tests/test_extra_frontends.py).
- the CQT's two routes, chunked products and `F.conv1d`: rtol 1e-4, atol
  1e-5 x the largest output.
- ReconVAT with CQT (176 bins, 4 heads of 176) and CFP (386 bins, heads of
  386): the eval full forward and `transcribe` at atol 1e-4, rtol 1e-4, as
  tests/test_torch_reconvat.py holds the Mel model; VAT `run_on_batch`
  losses with CQT in float64 on both sides, 1 labeled + 1 unlabeled clip,
  xi 0.1, directions pinned to the port's draws: rtol 1e-6, as
  tests/test_torch_vat_jax.py.
The JAX sides are jitted; the weights are the port's seeded init carried
into the JAX tree (`torch_to_flax`), perturbed, and carried back.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reconvat_tpu.models.reconvat as jreconvat_mod
from reconvat_tpu import vat as jvat
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu.ops import spectrogram as jspec
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import weights
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.ops import spectrogram as tspec
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_reconvat import _perturb
from .torch_threads import torch_one_thread  # noqa: F401

FE_RTOL, FE_ATOL = 1e-4, 1e-5
ATOL = RTOL = 1e-4
VAT_RTOL = 1e-6
FRAMES = {"CQT": 40, "CFP": 8}
XI, SEED = 0.1, 5
# case -> (frontend builder in the JAX package, in the port, frames)
FRONTENDS = {
    "cqt": (lambda: jspec.make_frontend("CQT")[0],
            lambda: tspec.make_frontend("CQT")[0], 40),
    "cfp": (lambda: jspec.make_frontend("CFP")[0],
            lambda: tspec.make_frontend("CFP")[0], 8),
    "cfp_reference_default": (jspec.CFP, tspec.CFP, 8),
}


def _audio(B, frames, seed, hop=512):
    return (np.random.RandomState(seed).randn(B, frames * hop) * 0.1
            ).astype(np.float32)


def _close(name, got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    assert np.shape(got) == np.shape(ref), name
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("case", list(FRONTENDS))
def test_frontend_matches_jax(case):
    jax_fe, port_fe, frames = FRONTENDS[case]
    jfe, tfe = jax_fe(), port_fe()
    hop = tfe.hop_length
    audio = _audio(2, frames, 1, hop)[:, :-1]
    ref = np.asarray(jax.jit(jfe.__call__)(jnp.asarray(audio)))
    got = tfe(torch.from_numpy(audio))
    drop = 2 if isinstance(tfe, tspec.CFP) else 0
    assert ref.shape == (2, frames - drop, tfe.n_bins)
    _close(case, got, ref, FE_RTOL, FE_ATOL * np.abs(ref).max())


@pytest.mark.parametrize("spec", ["CQT", "CFP"])
def test_frontend_fp32_error_against_float64(spec):
    """Both packages' fp32 frontends against the port's in float64: the
    port's error within 2x the JAX package's + 1e-6 of the largest
    output."""
    audio = _audio(2, FRAMES[spec], 2)[:, :-1]
    jfe, tfe = jspec.make_frontend(spec)[0], tspec.make_frontend(spec)[0]
    truth = tfe.double()(torch.from_numpy(audio).double()).numpy()
    tfe = tfe.float()
    port = tfe(torch.from_numpy(audio)).double().numpy()
    ref = np.asarray(jax.jit(jfe.__call__)(jnp.asarray(audio)), np.float64)
    top = np.abs(truth).max()
    port_err, jax_err = (np.abs(x - truth).max() for x in (port, ref))
    assert port_err <= 2 * jax_err + 1e-6 * top, (port_err, jax_err)
    assert port_err <= 1e-4 * top


def test_cqt_routes_agree():
    """The chunked products (the frontend's route) and `F.conv1d` on the
    same kernels."""
    fe = tspec.make_frontend("CQT")[0]
    assert fe.chunks is not None and fe.chunks.shape == (64, 512, 352)
    x = torch.from_numpy(_audio(2, 40, 3)[:, :-1])
    got = fe(x)
    ref = fe.magnitude(fe.conv1d(tspec.reflect_pad(x, fe.kernel_width // 2)))
    _close("conv1d", got, ref.numpy(), FE_RTOL,
           FE_ATOL * ref.abs().max().item())


def test_frontend_shapes_and_refusals():
    """176 CQT bins, 386 CFP bins on T - 2 frames; CQT refuses a clip no
    longer than its reflect pad, and an unknown name raises, in both
    packages."""
    assert tspec.make_frontend("CQT")[1] == jspec.make_frontend("CQT")[1] \
        == 176
    assert tspec.make_frontend("CFP")[1] == jspec.make_frontend("CFP")[1] \
        == 386
    short = _audio(1, 32, 4)[:, :-1]          # 16,383 samples
    with pytest.raises(ValueError, match="reflect padding"):
        tspec.make_frontend("CQT")[0](torch.from_numpy(short))
    with pytest.raises(ValueError, match="reflect padding"):
        jspec.make_frontend("CQT")[0](jnp.asarray(short))
    for make in (tspec.make_frontend, jspec.make_frontend):
        with pytest.raises(ValueError, match="unknown spectrogram"):
            make("STFT")
    # the bases are buffers that follow the device but are not saved
    assert tspec.make_frontend("CQT")[0].state_dict() == {}
    assert tspec.make_frontend("CFP")[0].state_dict() == {}


def _template(jmodel):
    """The JAX variable tree's shapes (they do not depend on the frames)."""
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=32)))


@pytest.fixture(scope="module", params=["CQT", "CFP"])
def pair(request):
    """(spec, JAX model, its variables, the port with the same weights)."""
    spec = request.param
    port = ReconVAT(device="cpu", spec=spec)
    jmodel = JaxReconVAT(conv_layout="nhwc", spec=spec)
    variables, report = torch_to_flax(port.state_dict(),
                                      _template(jmodel))
    assert report["skipped"] == []
    variables = _perturb(variables, 0)
    port.load_state_dict(flax_to_torch(variables), strict=True)
    return spec, jmodel, variables, port


def test_widths_follow_the_bins(pair):
    """Every width comes from the frontend's bins: the attention runs 4
    heads of Dh = n_bins, Roll2Spec's head maps back to n_bins."""
    spec, _, _, port = pair
    n = {"CQT": 176, "CFP": 386}[spec]
    assert port.n_bins == n
    assert port.transcriber.lstm1.W_q.weight.shape == (4 * n, n)
    assert port.reconstructor.linear2.weight.shape == (n, 4 * n)


def test_full_forward_matches_jax(pair):
    """Every output of the eval-mode full forward (every parameter used)
    on one normalized spec image."""
    spec, jmodel, variables, port = pair
    x = np.random.RandomState(2).rand(1, 32, port.n_bins, 1).astype(
        np.float32)
    ref = jax.jit(jmodel.module.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for name, a, b in zip(("reconstruction", "pianoroll", "pianoroll2",
                           "attention"), got, ref):
        _close(name, a, b)


@pytest.mark.parametrize("bucket", [0, 16])
def test_transcribe_matches_jax(pair, bucket):
    """Exact and bucketed `transcribe`: CQT gives T frames, CFP T - 2 on
    the exact path; the bucketed path masks the statistics over the spec's
    own frames and trims to t_true in both packages."""
    spec, jmodel, variables, port = pair
    audio = _audio(1, 40, 3)
    if bucket:
        audio = audio[:, :-300]                 # 40 frames, a ragged end
    ref = jax.jit(lambda v, a: jmodel.transcribe(v, a, bucket)["frame"])(
        variables, jnp.asarray(audio))
    got = port.transcribe(torch.from_numpy(audio), bucket)["frame"]
    frames = 40 if bucket or spec == "CQT" else 38
    assert tuple(got.shape) == (1, frames, 88)
    _close(f"{spec} bucket={bucket}", got, ref)


def _batches(frames, seed=0):
    rng = np.random.RandomState(seed)
    n = frames * 512
    return ({"audio": (rng.randn(1, n) * 0.1),
             "frame": (rng.rand(1, frames, 88) < 0.05).astype(np.float64)},
            {"audio": (rng.randn(1, n) * 0.1)})


def _f64_state(variables):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "_tensor",
                   lambda w: torch.tensor(np.asarray(w, np.float64)))
        return weights.flax_to_torch(variables)


def test_cqt_vat_losses_match_jax():
    """Every loss of ReconVAT(spec='CQT').run_on_batch with VAT and
    reconstruction (the separate chains: the unlabeled direction drawn
    first) against the JAX package's, in float64, same weights and
    directions."""
    frames = FRAMES["CQT"]
    port = ReconVAT(device="cpu", spec="CQT", xi=XI)
    jmodel = JaxReconVAT(conv_layout="nhwc", spec="CQT", xi=XI)
    variables, report = torch_to_flax(port.state_dict(),
                                      _template(jmodel))
    assert report["skipped"] == []
    variables = _perturb(variables, 1)
    g = torch.Generator().manual_seed(SEED)
    dirs = [torch.randn((1, frames, 176, 1), dtype=torch.float64,
                        generator=g) for _ in range(2)]
    pinned_dirs = [jnp.asarray(d.numpy()) for d in dirs]
    batch_l, batch_ul = _batches(frames)

    def pinned(apply_fn, x, key, cfg, init_d=None, y_ref=None, split=None):
        return jvat.vat_loss(apply_fn, x, key, cfg,
                             init_d=pinned_dirs.pop(0), y_ref=y_ref,
                             split=split)

    def run(v, b_l, b_ul):
        return jmodel.run_on_batch(v, b_l, b_ul, jax.random.PRNGKey(1),
                                   vat=True, train=True)[1]

    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jreconvat_mod, "vat_loss", pinned)
            v64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), variables)
            expect = jax.tree_util.tree_map(
                np.asarray, jax.jit(run)(v64, batch_l, batch_ul))
    finally:
        jax.config.update("jax_enable_x64", False)

    port = port.double()
    port.load_state_dict(_f64_state(variables), strict=True)
    _, losses, spec = port.run_on_batch(
        {k: torch.from_numpy(v) for k, v in batch_l.items()},
        {"audio": torch.from_numpy(batch_ul["audio"])},
        torch.Generator().manual_seed(SEED), vat=True, train=True)
    assert tuple(spec.shape) == (1, frames, 176)
    assert set(losses) == set(expect)
    for k, v in expect.items():
        _close(k, losses[k], v, VAT_RTOL, 1e-12)


def test_cfp_run_on_batch_refused_in_both_packages(monkeypatch):
    """CFP's spec has T - 2 frames for labels of T: the JAX package fails
    at the first product of the two (traced, not run), the port raises
    ValueError before its frontend runs."""
    frames = 40
    jmodel = JaxReconVAT(conv_layout="nhwc", spec="CFP")
    template = _template(jmodel)
    batch_l, batch_ul = _batches(frames)
    batch_l = {k: v.astype(np.float32) for k, v in batch_l.items()}
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda v: jmodel.run_on_batch(
            v, batch_l, None, jax.random.PRNGKey(0), vat=False,
            train=True), template)

    port = ReconVAT(device="cpu", spec="CFP")
    monkeypatch.setattr(port.frontend, "forward", lambda x: pytest.fail(
        "the frontend ran before the refusal"))
    batch = {k: torch.from_numpy(v) for k, v in batch_l.items()}
    with pytest.raises(ValueError, match=r"T - 2 = 38 .* T = 40"):
        port.run_on_batch(batch, None, torch.Generator(), vat=False)
    with pytest.raises(ValueError, match="CFP"):
        port.run_on_batch_application(batch, None, torch.Generator())


@pytest.mark.parametrize("spec", ["CQT", "CFP"])
def test_streaming_refuses_other_frontends(spec):
    """Streaming reads the Mel window's 4-frame edge halo in pass 1: with
    another frontend it raises, naming the ROADMAP item."""
    model = ReconVAT(device="cpu", spec=spec)
    audio = torch.from_numpy(_audio(1, 2000, 5))
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 1\\)"):
        model.transcribe_streaming(audio, window_frames=256)
