"""The port's UNet_Onset (`reconvat_tpu_torch/models/unet_onset.py`) against
the JAX package's, on the CPU, at full width over 32-frame clips, with the
same weights: the port's seeded init carried into the JAX tree
(`torch_to_flax`), perturbed (`_perturb`: random biases and BatchNorm
statistics), and carried back (`flax_to_torch`). The JAX sides are jitted.

Tolerances:
- eval forward (every output, both `reconstruction` settings) and
  `transcribe` (onset and frame, bucketed and exact): atol 1e-4 (rtol
  1e-4), the bound of tests/test_torch_reconvat.py: fp32 on both sides,
  other convolution and BatchNorm summation orders.
- train-mode `run_on_batch` without VAT: losses rtol 1e-4; BatchNorm
  running statistics after it rtol 1e-4, atol 1e-5 (fp32 batch moments of
  O(1) activations, the same reductions in another order).
- VAT losses: both packages in float64, B = 1 labeled + 1 unlabeled, xi
  0.1, the directions pinned to the port's draws: rtol 1e-6, the bound of
  tests/test_torch_vat_jax.py (JAX's attention takes its softmax in
  float32 even in x64 mode).
- bf16: each output within 2x JAX's own bf16-vs-fp32 gap of JAX's bf16
  output (tests/test_torch_bf16.py's rule), onset and frame included.
- streaming against the bucketed `transcribe`: interior atol 1e-5, the last
  64 frames 1e-3 (tests/test_torch_streaming.py's bounds).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reconvat_tpu.models.unet_onset as junet_onset_mod
from reconvat_tpu.models.unet_onset import UNetOnset as JaxUNetOnset
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import weights
from reconvat_tpu_torch.models import get_model
from reconvat_tpu_torch.models.common import transcribe_streaming
from reconvat_tpu_torch.models.reconvat import fp32_math, init_parameters
from reconvat_tpu_torch.models.unet_onset import UNetOnset
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_bf16 import assert_within_jax_gap
from .test_torch_reconvat import _audio, _perturb
from .test_torch_streaming import _song
from .torch_threads import torch_one_thread  # noqa: F401

ATOL = RTOL = 1e-4
FRAMES, XI, SEED = 32, 0.1, 5
VAT_RTOL = 1e-6


def _template(jmodel):
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=FRAMES)))


def _without_reconstructor(variables):
    return {k: {m: v for m, v in tree.items() if m != "reconstructor"}
            for k, tree in variables.items()}


@pytest.fixture(scope="module")
def weights_tree():
    """The JAX tree (reconstruction=True) of the port's seeded init,
    perturbed."""
    port = UNetOnset(device="cpu", seed=0)
    variables, report = torch_to_flax(
        port.state_dict(), _template(JaxUNetOnset(conv_layout="nhwc")))
    assert report["skipped"] == []
    return _perturb(variables, 0)


def _pair(variables, reconstruction, **kw):
    """(JAX model, its variables, port model with the same weights)."""
    if not reconstruction:
        variables = _without_reconstructor(variables)
    jmodel = JaxUNetOnset(conv_layout="nhwc", reconstruction=reconstruction,
                          **kw)
    port = UNetOnset(device="cpu", reconstruction=reconstruction,
                     compute_dtype=kw.get("compute_dtype"),
                     xi=kw.get("xi", 1e-6))
    port.load_state_dict(flax_to_torch(variables), strict=True)
    return jmodel, variables, port


def _batch(b, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    n = FRAMES * 512
    return ({"audio": (rng.randn(b, n) * 0.1).astype(dtype),
             "frame": (rng.rand(b, FRAMES, 88) < 0.05).astype(dtype),
             "onset": (rng.rand(b, FRAMES, 88) < 0.02).astype(dtype)},
            {"audio": (rng.randn(b, n) * 0.1).astype(dtype)})


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(name, got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == np.shape(ref), name
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("reconstruction", [True, False])
def test_eval_forward_matches_jax(weights_tree, reconstruction):
    jmodel, variables, port = _pair(weights_tree, reconstruction)
    x = np.random.RandomState(2).rand(1, FRAMES, 229, 1).astype(np.float32)
    ref = jax.jit(lambda v, x: jmodel.module.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    names = (("reconstruction", "pianoroll", "onset", "pianoroll2",
              "onset2", "attention") if reconstruction
             else ("pianoroll", "onset", "attention"))
    assert len(got) == len(ref) == len(names)
    for name, a, b in zip(names, got, ref):
        _close(name, a, b)


@pytest.mark.parametrize("n,bucket", [(FRAMES * 512, 0),
                                      (512 * 40 + 7, 16)])
def test_transcribe_matches_jax(weights_tree, n, bucket):
    jmodel, variables, port = _pair(weights_tree, False)
    audio = _audio(2, n, seed=3)
    ref = jax.jit(lambda v, a: jmodel.transcribe(v, a, bucket))(
        variables, jnp.asarray(audio))
    got = port.transcribe(torch.from_numpy(audio), bucket)
    assert not torch.equal(got["onset"], got["frame"])
    for k in ("onset", "frame"):
        _close(k, got[k], ref[k])


def test_train_losses_and_running_stats_match_jax(weights_tree):
    """Train-mode run_on_batch without VAT (reconstruction on, B = 2):
    every loss, and the running statistics after it."""
    jmodel, variables, port = _pair(weights_tree, True)
    batch_l, _ = _batch(2)

    def run(v, b):
        _, losses, _, stats = jmodel.run_on_batch(
            v, b, None, jax.random.PRNGKey(0), vat=False, train=True)
        return losses, stats

    losses, stats = jax.jit(run)(variables, batch_l)
    _, got, _ = port.run_on_batch(_torch(batch_l), None, None, vat=False,
                                  train=True)
    assert set(got) == set(losses)      # a jit returns a dict sorted
    for k, v in losses.items():
        _close(k, got[k], v, atol=1e-7)
    ref = {k: v for k, v in flax_to_torch(
        {"params": {}, "batch_stats": stats}).items() if "running" in k}
    sd = port.state_dict()
    assert set(ref) == {k for k in sd if "running" in k}
    for k, v in ref.items():
        _close(k, sd[k], v.numpy(), atol=1e-5)


def test_vat_losses_match_jax(weights_tree):
    """Separate VAT chains in float64 (reconstruction off), directions
    pinned: the per-head LDS losses and every other loss."""
    variables = _without_reconstructor(weights_tree)
    jmodel = JaxUNetOnset(conv_layout="nhwc", reconstruction=False, xi=XI)
    g = torch.Generator().manual_seed(SEED)
    dirs = [jnp.asarray(torch.randn((1, FRAMES, 229, 1), dtype=torch.float64,
                                    generator=g).numpy()) for _ in range(2)]
    batch_l, batch_ul = _batch(1, seed=1, dtype=np.float64)

    real = junet_onset_mod.vat_loss

    def pinned(apply_fn, x, key, cfg, init_d=None, y_ref=None, split=None):
        return real(apply_fn, x, key, cfg, init_d=dirs.pop(0), y_ref=y_ref,
                    split=split)

    def run(v, b_l, b_ul):
        return jmodel.run_on_batch(v, b_l, b_ul, jax.random.PRNGKey(1),
                                   vat=True, train=True)[1]

    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(junet_onset_mod, "vat_loss", pinned)
            v64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), variables)
            ref = jax.tree_util.tree_map(
                np.asarray, jax.jit(run)(v64, batch_l, batch_ul))
    finally:
        jax.config.update("jax_enable_x64", False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "_tensor",
                   lambda w: torch.tensor(np.asarray(w, np.float64)))
        sd = weights.flax_to_torch(variables)
    port = UNetOnset(device="cpu", reconstruction=False, xi=XI).double()
    port.load_state_dict(sd, strict=True)
    gen = torch.Generator().manual_seed(SEED)
    _, got, _ = port.run_on_batch(_torch(batch_l), _torch(batch_ul), gen,
                                  vat=True, train=True)
    assert set(got) == set(ref)
    for k in ("loss/train_LDS_l_frame", "loss/train_LDS_l_onset",
              "loss/train_LDS_ul_frame", "loss/train_LDS_ul_onset"):
        assert ref[k] > 0, k
    for k, v in ref.items():
        _close(k, got[k].double(), v, rtol=VAT_RTOL, atol=1e-12)


def test_batched_chain_runs_both_heads(weights_tree):
    """vat_chain='batched' (one chain over [labeled; unlabeled] on the
    running statistics of before the step) gives the separate chain's keys,
    finite, with LDS losses per head, and leaves the running statistics
    as the supervised forward alone does."""
    _, variables, port = _pair(weights_tree, False)
    batched = UNetOnset(device="cpu", reconstruction=False, xi=XI,
                        vat_chain="batched")
    batched.load_state_dict(port.state_dict(), strict=True)
    batch_l, batch_ul = (_torch(b) for b in _batch(1, seed=2))
    gen = torch.Generator().manual_seed(SEED)
    _, sep, _ = port.run_on_batch(batch_l, batch_ul, gen, vat=True)
    _, got, _ = batched.run_on_batch(batch_l, batch_ul, gen, vat=True)
    assert list(got) == list(sep)
    assert all(torch.isfinite(v).all() for v in got.values())
    assert got["loss/train_LDS_ul_onset"] > 0
    for k, v in port.state_dict().items():
        if "running" in k:
            assert torch.equal(batched.state_dict()[k], v), k


def test_bf16_forward_within_jax_gap(weights_tree):
    """Eval forward in bf16, reconstruction on: every output of the port's
    bf16 model within 2x JAX's bf16-vs-fp32 gap of JAX's bf16 output."""
    x = jnp.asarray(np.random.RandomState(4).rand(1, FRAMES, 229, 1)
                    .astype(np.float32))
    outs = {}
    for dtype in (None, "bfloat16"):
        jmodel, variables, port = _pair(weights_tree, True,
                                        compute_dtype=dtype)
        jax_out = jax.jit(lambda v, x: jmodel.module.apply(
            v, x, train=False))(variables, x)
        with torch.no_grad():
            outs[dtype] = (jax_out, port(torch.from_numpy(np.array(x))))
    (j32, p32), (j16, p16) = outs[None], outs["bfloat16"]
    names = ("reconstruction", "pianoroll", "onset", "pianoroll2",
             "onset2", "attention")
    for name, a, b, c, d in zip(names, p16, j16, j32, p32):
        assert_within_jax_gap(name, a, b, c, d)
    # the heads run in fp32 on promoted inputs, as JAX's Dense(dtype=None)
    assert p16[2].dtype == p16[1].dtype == torch.float32


@pytest.mark.parametrize("reconstruction", [True, False])
def test_weights_round_trip(reconstruction):
    """flax_to_torch of a JAX UNet_Onset tree loads with strict=True, and
    torch_to_flax sends the port's state_dict back with nothing skipped."""
    jmodel = JaxUNetOnset(conv_layout="nhwc", reconstruction=reconstruction)
    template = _template(jmodel)
    variables = _perturb(jax.tree_util.tree_map(
        lambda a: np.random.RandomState(a.size % 97).randn(*a.shape)
        .astype(np.float32), template), 1)
    port = UNetOnset(device="cpu", reconstruction=reconstruction)
    port.load_state_dict(flax_to_torch(variables), strict=True)
    back, report = torch_to_flax(port.state_dict(), template)
    assert report["skipped"] == []
    flat = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def test_reference_state_dict_with_unused_keys_loads(weights_tree, tmp_path):
    """A reference-style state_dict (the unused transcriber.lstm1.* and
    linear1.*, frontend buffers) loads in both packages to the same
    weights; an unknown key raises."""
    _, variables, port = _pair(weights_tree, False)
    sd = dict(port.state_dict())
    extra = {"transcriber.lstm1.W_q.weight": torch.zeros(8, 176),
             "transcriber.linear1.weight": torch.zeros(88, 8),
             "transcriber.linear1.bias": torch.zeros(88),
             "spectrogram.mel_basis": torch.zeros(4)}
    path = str(tmp_path / "weight.pt")
    torch.save({**sd, **extra}, path)
    fresh = UNetOnset(device="cpu", reconstruction=False, seed=1)
    fresh.load_reference_weights(path)
    for k, v in sd.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    jmodel = JaxUNetOnset(conv_layout="nhwc", reconstruction=False)
    loaded = jmodel.load_reference_weights(path, _template(jmodel))
    back = flax_to_torch(loaded)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="unexpected"):
        fresh.load_reference_weights({**sd, "transcriber.other": sd[k]})


def test_streaming_matches_bucketed_for_both_rolls(weights_tree):
    """Both rolls of transcribe_streaming (W = 64, H = 16 over 300 frames)
    against the bucketed transcribe; the tensor path of
    models/common.transcribe_streaming gives the dict path's frame roll
    bit for bit."""
    _, _, port = _pair(weights_tree, True)
    audio = torch.from_numpy(_song(300 * 512 / 16000, seed=2))
    full = port.transcribe(audio, bucket_frames=512)
    streamed = port.transcribe_streaming(audio, window_frames=64,
                                         halo_frames=32)
    for k in ("onset", "frame"):
        s, f = streamed[k].numpy(), full[k].numpy()
        assert s.shape == f.shape == (1, 300, 88), k
        np.testing.assert_allclose(s[:, :-64], f[:, :-64], atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(s[:, -64:], f[:, -64:], atol=1e-3,
                                   err_msg=k)
    with torch.no_grad(), fp32_math():
        frame = transcribe_streaming(
            port, lambda s: port.transcribe_heads(s)["frame"], audio, 64, 32)
    assert torch.is_tensor(frame)
    assert torch.equal(frame, streamed["frame"])


def test_model_registry_and_refusals(monkeypatch, tmp_path):
    """get_model builds the ported models, every name of the JAX
    package's registry, and raises KeyError for any other name; without a
    card the model and the training CLI raise, and the CLI writes
    nothing."""
    from reconvat_tpu_torch import train_UNet_Onset_VAT as cli

    model = get_model("UNet_Onset", device="cpu", reconstruction=False)
    assert isinstance(model, UNetOnset)
    assert type(get_model("ReconVAT", device="cpu")).__name__ == "ReconVAT"
    assert type(get_model("Segmentation", device="cpu")).__name__ == \
        "SemanticSegmentation"
    with pytest.raises(KeyError):
        get_model("NoSuchModel")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNetOnset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.ex.run(cli.train, {"root": str(tmp_path), "train_on": "nowhere"})
    for override, error, match in (({"mesh_sp": 2}, NotImplementedError,
                                     "item 3.3"),
                                    ({"attn_impl": "xla"}, ValueError,
                                     "plain attention")):
        with pytest.raises(error, match=match):
            cli.ex.run(cli.train, {"root": str(tmp_path), "device": "cpu",
                                   **override})
    assert os.listdir(tmp_path) == []


def test_seeded_init_is_deterministic():
    a = UNetOnset(device="cpu", seed=3, reconstruction=False)
    b = UNetOnset(device="cpu", reconstruction=False)
    init_parameters(b, torch.Generator().manual_seed(3))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
