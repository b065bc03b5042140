"""The port's Segmentation ("baseline_Multi_Inst",
`reconvat_tpu_torch/models/segmentation.py`) against the JAX package's, on
the CPU, at full width (8.0 M parameters: 32-256 channels, two 17 x 17
attention layers at the bottleneck) over 37-frame clips.

Weights: the port's seeded init carried into the JAX tree (`torch_to_flax`
on a `jax.eval_shape` template), perturbed (`_perturb`: random biases and
BatchNorm statistics), and carried back (`flax_to_torch`): a JAX `init`
run op by op costs tens of seconds. The JAX sides are jitted (with fewer LLVM backend passes, `_jit`): one eval
forward, and one `jax.value_and_grad` of the train-mode frame BCE that
also returns the posteriogram and the updated statistics. No JAX VAT step
runs (an eager one takes minutes): VAT with `norm_axis=2` is held on a
cheap stand-in network instead. Dropout is 0 on both sides.

Tolerances:
- posteriograms and losses: atol 1e-4 (rtol 1e-4): other summation
  orders; running statistics rtol 1e-4, atol 1e-5; gradients: atol 1e-4
  of the largest gradient magnitude. The train step runs in float64 on
  both sides (`test_train_step_matches_jax`).
- the padding helpers, the weight round trip: exact.
- `MultiHeadAttention2D` alone: the posteriograms' tolerance (its
  unscaled energies at a N(0, 1) input are large, the softmax peaked).
- VAT on the stand-in, float64 on both sides, the direction pinned:
  1e-6 of each output's largest magnitude.
- bf16: within 2x JAX's own bf16-vs-fp32 gap plus the two packages' fp32
  gap (tests/test_torch_bf16.py's rule, with the fp32 gap).
- streaming against the port's bucketed transcription: the JAX package's
  bounds (tests/test_streaming_transcribe.py:118-119), atol 1e-4 inside
  and 1e-3 over the last 64 frames.
- streaming on sharpened weights against the JAX package's stream on the
  same weights: atol 1e-5 (`STREAM_PAIR_ATOL`; the packages' rolls sit
  2e-7 apart), also between the packages' stream-vs-bucketed gaps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reconvat_tpu.models.segmentation as jseg
from reconvat_tpu.models.losses import binary_cross_entropy as jax_bce
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu.vat import VATConfig as JaxVATConfig
from reconvat_tpu.vat import vat_loss as jax_vat_loss
from reconvat_tpu_torch.models import get_model
from reconvat_tpu_torch.models.base import init_parameters
from reconvat_tpu_torch.models.segmentation import (MultiHeadAttention2D,
                                                    SemanticSegmentation,
                                                    tf_same_pad,
                                                    transpose_padding_same)
from reconvat_tpu_torch.nn.layers import SharedDropout
from reconvat_tpu_torch.vat import VATConfig, vat_loss
from reconvat_tpu_torch.weights import flax_to_torch

from . import torch_dp_worker as worker
from .test_torch_bf16 import _jax_variables
from .torch_threads import torch_one_thread  # noqa: F401

ATOL = RTOL = 1e-4
B, FRAMES, F = 2, 37, 229


def _jit(fn, level=0):
    """`jax.jit` at LLVM backend optimization level `level`: at 0 the
    forward of this 8 M-parameter network compiles in half the time and
    runs in a few tenths of a second; its gradient runs slowly there and
    compiles fastest at 2."""
    return jax.jit(fn, compiler_options={
        "xla_backend_optimization_level": level})


def _np(x):
    return x.detach().double().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float64)


def _close(name, got, ref, rtol=RTOL, atol=ATOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def _spec(b=B, t=FRAMES, seed=0):
    """A (B, T, F, 1) spec image in [0, 1], as make_spec's."""
    return np.random.RandomState(seed).rand(b, t, F, 1).astype(np.float32)


def _pair(out_class=1, seed=0, **kw):
    """(JAX model, its variables, the port with the same weights), dropout
    0 on both sides."""
    port = SemanticSegmentation(device="cpu", out_class=out_class,
                                dropout_rate=0.0, seed=seed, **kw)
    jmodel = jseg.SemanticSegmentation(out_class=out_class, dropout_rate=0.0,
                                       **kw)
    variables = _jax_variables(
        port, lambda: jmodel.init(jax.random.PRNGKey(0), seq_frames=FRAMES),
        seed)
    port.load_state_dict(flax_to_torch(variables), strict=True)
    return jmodel, variables, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def jax_eval(pair):
    """The JAX eval forward of `_spec()`, fp32."""
    jmodel, variables, _ = pair
    return np.asarray(_jit(lambda v, x: jmodel.module.apply(
        v, x, train=False))(variables, jnp.asarray(_spec())))


@pytest.mark.parametrize("size", [37, 45, 229, 115, 58, 29, 15, 16])
def test_padding_helpers_match_jax(size):
    """TF-SAME padding (stride 1 and 2, 7 x 7, 3 x 3, 1 x 1) and the
    transposed convolution's crop, pixel for pixel on odd and even sizes,
    the port's NCHW against the JAX package's NHWC."""
    x = np.random.RandomState(size).randn(1, size, size + 3, 2).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for ksize, stride in (((7, 7), (1, 1)), ((3, 3), (2, 2)),
                          ((3, 3), (1, 1)), ((1, 1), (2, 2))):
        ref = np.asarray(jseg.tf_same_pad(jnp.asarray(x), ksize, stride))
        got = tf_same_pad(xt, ksize, stride).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=str((ksize, stride)))
    for in_hw in ((size // 2, (size + 3) // 2), ((size - 1) // 2, 1)):
        ref = np.asarray(jseg.transpose_padding_same(jnp.asarray(x), in_hw,
                                                     (2, 2)))
        got = transpose_padding_same(xt, in_hw, (2, 2)).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(in_hw))


def _attention_2d_case(use_bias=False):
    """`MultiHeadAttention2D` alone at a 24 x 24 map (full 17 x 17 windows
    inside it), 64 -> 32 channels, 2 groups: the output and the
    probabilities. Returns the port module and its JAX variables."""
    mod = MultiHeadAttention2D(64, 32, (17, 17), groups=2, use_bias=use_bias)
    jmod = jseg.MultiHeadAttention2D(32, (17, 17), groups=2,
                                     use_bias=use_bias)
    x = np.random.RandomState(1).randn(2, 24, 24, 64).astype(np.float32)
    variables = _jax_variables(mod, lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    mod.load_state_dict(flax_to_torch(variables), strict=True)
    ref_out, ref_attn = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out, attn = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close("out", out.permute(0, 2, 3, 1), ref_out)
    _close("probs", attn, ref_attn)
    assert out.dtype == torch.float32
    return mod, variables


def test_attention_2d_matches_jax():
    _attention_2d_case()


def test_attention_2d_with_biases_matches_jax():
    """`use_bias=True`: the three 1 x 1 projections carry biases (drawn,
    `_perturb`), which the bridge carries both ways; a bias also lands on
    the zero padding's keys and values, as in the JAX package. The port's
    init zeroes them, as flax's does."""
    mod, variables = _attention_2d_case(use_bias=True)
    for name in ("query_conv", "key_conv", "value_conv"):
        bias = getattr(mod, name).bias
        assert bias is not None and bias.abs().max() > 0, name
    back, report = torch_to_flax(mod.state_dict(), variables)
    assert report["skipped"] == []
    for p, leaf in jax.tree_util.tree_leaves_with_path(variables):
        got = dict(jax.tree_util.tree_leaves_with_path(back))[p]
        np.testing.assert_array_equal(np.asarray(got), leaf, err_msg=str(p))
    fresh = MultiHeadAttention2D(4, 8, (3, 3), use_bias=True)
    init_parameters(fresh, torch.Generator().manual_seed(0))
    assert all(getattr(fresh, n).bias.abs().max() == 0
               for n in ("query_conv", "key_conv", "value_conv"))


def test_eval_forward_matches_jax(pair, jax_eval):
    """The eval-mode forward (running statistics) at 2 x 37 x 229."""
    _, _, port = pair
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(_spec()))
    assert got.shape == (B, FRAMES, 88)
    _close("posteriogram", got, jax_eval)


@pytest.fixture(scope="module")
def train_step(pair):
    """The port's train-mode `run_on_batch` on a float64 batch, its frame
    BCE's backward, and one jitted `jax.value_and_grad` of the JAX
    module's BCE on the port's spec: the port's model, preds, losses and
    spec, the batch, and JAX's loss, posteriogram, new statistics and
    gradients (as the port's state-dict names)."""
    jmodel, variables, _ = pair
    rng = np.random.RandomState(2)
    audio = rng.randn(B, FRAMES * 512) * 0.1
    label = (rng.rand(B, FRAMES, 88) < 0.05).astype(np.float64)
    port = SemanticSegmentation(device="cpu", dropout_rate=0.0).double()
    port.load_state_dict(flax_to_torch(variables), strict=True)
    batch = {"audio": torch.from_numpy(audio),
             "frame": torch.from_numpy(label)}
    preds, losses, spec = port.run_on_batch(batch, train=True)
    losses["loss/train_frame"].backward()

    def loss_fn(params, x, y):
        pred, upd = jmodel.module.apply(
            {"params": params, "batch_stats": stats64}, x, train=True,
            mutable=["batch_stats"])
        return jax_bce(pred, y), (pred, upd["batch_stats"])

    with jax.enable_x64():
        params64, stats64 = (jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables[k])
            for k in ("params", "batch_stats"))
        (loss, (pred, stats)), grads = _jit(jax.value_and_grad(
            loss_fn, has_aux=True), level=2)(params64,
                                    jnp.asarray(spec.detach().numpy()[
                                        ..., None]), jnp.asarray(label))
        loss, pred, stats, grads = jax.tree_util.tree_map(
            np.asarray, (loss, pred, stats, grads))
    return {"port": port, "preds": preds, "losses": losses, "batch": batch,
            "loss": loss, "pred": pred,
            "stats": flax_to_torch({"params": variables["params"],
                                    "batch_stats": stats}),
            "grads": flax_to_torch({"params": grads})}


def _assert_step_matches_jax(step, loss, grads: dict, buffers: dict):
    """A frame BCE, its gradients and the new running statistics against
    the JAX step's, by the tolerances above."""
    _close("loss/train_frame", loss, step["loss"])
    for name in step["stats"]:
        if name.endswith(("running_mean", "running_var")):
            _close(name, buffers[name], step["stats"][name], atol=1e-5)
    ref_grads = step["grads"]
    top = max(g.abs().max().item() for g in ref_grads.values())
    assert sorted(grads) == sorted(ref_grads)
    for name, g in ref_grads.items():
        _close(f"grad {name}", grads[name] / top, g / top, rtol=0)


def test_train_step_matches_jax(train_step):
    """The train-mode forward, its frame BCE, the updated running
    statistics and every gradient, against one jitted `jax.value_and_grad`
    of the JAX module's BCE, both packages in float64: train-mode
    BatchNorm over the 2 x 3 x 15 bottleneck amplifies fp32 rounding
    (two fp32 runs of the port itself, on one thread and on several,
    differ by up to 7e-3). The JAX package's attention keeps its softmax
    in fp32 in x64 mode, so the sides agree to ~1e-6, not to float64's
    precision. The port goes through `run_on_batch` (its spec is the JAX
    side's input; the loss keys are the JAX package's)."""
    preds, losses = train_step["preds"], train_step["losses"]
    assert sorted(losses) == sorted(
        ["loss/train_frame", "loss/train_LDS_l", "loss/train_LDS_ul",
         "loss/train_r_norm_l", "loss/train_r_norm_ul"])
    assert preds["onset"] is preds["frame"] and preds["r_adv"] is None
    _close("posteriogram", preds["frame"], train_step["pred"])
    port = train_step["port"]
    _assert_step_matches_jax(
        train_step, losses["loss/train_frame"],
        {n: p.grad for n, p in port.named_parameters()},
        dict(port.named_buffers()))


def test_train_step_two_ranks_matches_jax(pair, train_step, tmp_path):
    """The same step data-parallel over 2 gloo ranks of one clip each
    (`make_train_step` under a mesh, no VAT, unclipped;
    tests/torch_dp_worker.py): the all-reduced BCE and gradients and the
    global BatchNorm statistics against the JAX step's, by the
    one-process tolerances; the ranks' new parameters and statistics
    bit-equal."""
    _, variables, _ = pair
    r0, r1 = worker.run_job(tmp_path, {
        "model": "Segmentation", "kwargs": {"dropout_rate": 0.0},
        "state": flax_to_torch(variables), "batch_l": train_step["batch"],
        "batch_ul": None, "vat": False, "seed": 0})
    for k, v in r1["state"].items():
        assert torch.equal(r0["state"][k], v), k
    _assert_step_matches_jax(train_step, r0["losses"]["loss/train_frame"],
                             r0["grads"], r0["state"])


def test_vat_image_norm_matches_jax():
    """VAT as Segmentation configures it (one power iteration, the
    direction normalized over the bins of the (B, T, F, 1) image, xi 1e-6,
    eps 1e-2, the 1e10 rescue) on a stand-in network, both packages in
    float64 from the same pinned direction: the loss, r_adv and the
    normalized direction."""
    rng = np.random.RandomState(3)
    x = rng.rand(2, 9, F, 1)
    w = rng.randn(F, 88) * 0.1
    d = rng.randn(*x.shape)
    cfg = dict(xi=1e-6, eps=1e-2, n_power=1, norm_axis=2)
    assert SemanticSegmentation(device="cpu").vat_cfg == VATConfig(**cfg)
    with jax.enable_x64():
        ref = jax_vat_loss(lambda z: jax.nn.sigmoid(z[..., 0] @ w),
                           jnp.asarray(x), jax.random.PRNGKey(0),
                           JaxVATConfig(**cfg), init_d=jnp.asarray(d))
        ref = [np.asarray(r) for r in ref]
    wt = torch.from_numpy(w)
    got = vat_loss(lambda z: torch.sigmoid(z[..., 0] @ wt),
                   torch.from_numpy(x), None, VATConfig(**cfg),
                   init_d=torch.from_numpy(d))
    for name, a, b in zip(("lds", "r_adv", "d"), got, ref):
        _close(name, a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    assert np.abs(ref[0]) > 0


def test_multi_instrument_output_matches_jax():
    """out_class=2: the class axis survives, (B, 2, T, 88), each class's
    map through the same head; bucketed `transcribe` trims time on axis
    2."""
    jmodel, variables, port = _pair(out_class=2, seed=4)
    x = _spec(seed=4)
    ref = np.asarray(_jit(lambda v, z: jmodel.module.apply(
        v, z, train=False))(variables, jnp.asarray(x)))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (B, 2, FRAMES, 88)
    _close("posteriogram", got, ref)
    audio = torch.from_numpy(
        (np.random.RandomState(5).randn(1, 40 * 512) * 0.1).astype(
            np.float32))
    rolls = port.transcribe(audio, bucket_frames=32)
    assert rolls["frame"].shape == (1, 2, 40, 88)


def test_bf16_forward_within_jax_gap(pair, jax_eval):
    """compute_dtype='bfloat16' (the fp32 model's weights): the eval
    posteriogram within 2x JAX's own bf16-vs-fp32 gap plus the packages'
    fp32 gap of JAX's bf16 output; fp32 out, and not the fp32 result."""
    _, variables, port = pair
    jmodel16 = jseg.SemanticSegmentation(dropout_rate=0.0,
                                         compute_dtype="bfloat16")
    x = _spec()
    ref16 = np.asarray(_jit(lambda v, z: jmodel16.module.apply(
        v, z, train=False))(variables, jnp.asarray(x)), np.float64)
    port16 = SemanticSegmentation(device="cpu", dropout_rate=0.0,
                                  compute_dtype="bfloat16")
    port16.load_state_dict(flax_to_torch(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got16 = port16(torch.from_numpy(x))
        got32 = port(torch.from_numpy(x))
    assert got16.dtype == torch.float32
    got16, got32 = _np(got16), _np(got32)
    gap, fp32_gap = np.abs(ref16 - jax_eval).max(), np.abs(
        got32 - jax_eval).max()
    err = np.abs(got16 - ref16).max()
    assert err <= 2 * gap + fp32_gap, (err, gap, fp32_gap)
    assert np.abs(got16 - got32).max() > 1e-7


def test_reference_weights_and_round_trip(pair, tmp_path):
    """A `.pt` of the reference's names, with the stride-1 blocks' unused
    `conv_skip` weights, loads into the port (those dropped, `rel_t` and
    `rel_f` as they are) and into the JAX package's loader to the same
    weights; the port's state_dict goes back through `torch_to_flax` with
    nothing skipped, equal to the tree leaf for leaf. Any other key that
    does not fit raises."""
    jmodel, variables, port = pair
    sd = dict(flax_to_torch(variables))
    extra = {"encoder.layer1b.conv_skip.weight": torch.ones(32, 32, 1, 1),
             "encoder.layer1b.conv_skip.bias": torch.ones(32),
             "encoder.layer4e.conv_skip.weight": torch.ones(256, 256, 1, 1)}
    path = str(tmp_path / "weight.pt")
    torch.save({**sd, **extra}, path)
    other = SemanticSegmentation(device="cpu", seed=7)
    other.load_reference_weights(path)
    for k, v in sd.items():
        assert torch.equal(other.state_dict()[k], v), k
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    jax_loaded = jmodel.load_reference_weights(path, template)
    back, report = torch_to_flax(other.state_dict(), template)
    assert report["skipped"] == []
    flat = jax.tree_util.tree_leaves_with_path(variables)
    for tree in (back, jax_loaded):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(got) == len(flat)
        for p, leaf in flat:
            np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                          err_msg=str(p))
    with pytest.raises(ValueError, match="do not fit"):
        other.load_reference_weights(
            {**sd, "encoder.layer1a.conv_skip2.weight": torch.ones(1)})
    with pytest.raises(ValueError, match="do not fit"):    # a strided skip
        other.load_reference_weights(
            {k: v for k, v in sd.items()
             if k != "encoder.layer1a.conv_skip.weight"})
    assert type(get_model("Segmentation", device="cpu")) is \
        SemanticSegmentation


def test_streaming_matches_bucketed(pair):
    """`transcribe_streaming` at the default halo (256: the attention
    pair's reach) with 256-frame windows, of a 780-frame song (4 windows),
    against the bucketed `transcribe`."""
    _, _, port = pair
    audio = torch.from_numpy(
        (np.random.RandomState(6).randn(1, 780 * 512) * 0.1).astype(
            np.float32))
    full = port.transcribe(audio, bucket_frames=64)["frame"]
    streamed = port.transcribe_streaming(audio, window_frames=256)["frame"]
    assert streamed.shape == full.shape == (1, 780, 88)
    _close("inside", streamed[:, :-64], full[:, :-64], rtol=0, atol=1e-4)
    _close("tail", streamed[:, -64:], full[:, -64:], rtol=0, atol=1e-3)


STREAM_FRAMES, STREAM_WINDOW, STREAM_TAIL = 780, 256, 64
# the packages' streams, and their bucketed rolls, against each other
STREAM_PAIR_ATOL = 1e-5


def test_streaming_on_sharpened_weights_matches_jax():
    """Segmentation streamed on sharpened weights, in both packages. The
    port's seeded init (perturbed) with its output layer sharpened as
    `chip_smoke.sharpen_output` sharpens it (x 16, each pitch's bias at a
    gap in its top 2 % of logits), carried to JAX through
    `torch_to_flax`; one 780-frame song in 256-frame windows at the
    default halo of 256, where the receptive field reaches past the halo.
    Each stream against its own package's bucketed `transcribe`, and the
    port's against JAX's: the packages' streams and their bucketed rolls
    agree within STREAM_PAIR_ATOL (1e-5), and so do the two packages'
    stream-vs-bucketed gaps, so a gap of a stream is the model's own, the
    same in the JAX package. That gap is printed; that it is more than
    rounding is asserted (the song does reach past the halo)."""
    import chip_smoke

    jmodel, variables, port = _pair()
    audio = (np.random.RandomState(6).randn(1, STREAM_FRAMES * 512)
             * 0.1).astype(np.float32)
    song = torch.from_numpy(audio)
    chip_smoke.sharpen_output(port, [song], lin=port.inference_model)
    variables, report = torch_to_flax(port.state_dict(), variables)
    assert report["skipped"] == []
    rolls = {
        "port": (port.transcribe_streaming(
            song, window_frames=STREAM_WINDOW)["frame"].numpy(),
            port.transcribe(song, bucket_frames=64)["frame"].numpy()),
        "jax": (np.asarray(jmodel.transcribe_streaming(
            variables, jnp.asarray(audio),
            window_frames=STREAM_WINDOW)["frame"]),
            np.asarray(jmodel.transcribe(variables, jnp.asarray(audio),
                                         bucket_frames=64)["frame"]))}
    gaps = {}
    for pkg, (streamed, full) in rolls.items():
        assert streamed.shape == full.shape == (1, STREAM_FRAMES, 88), pkg
        gap = np.abs(streamed - full)
        gaps[pkg] = (gap[:, :-STREAM_TAIL].max(), gap[:, -STREAM_TAIL:].max())
    print(f"stream vs bucketed (inside, last {STREAM_TAIL} frames): {gaps}")
    for i, what in enumerate(("streamed", "bucketed")):
        _close(what, rolls["port"][i], rolls["jax"][i], rtol=0,
               atol=STREAM_PAIR_ATOL)
    for port_gap, jax_gap in zip(gaps["port"], gaps["jax"]):
        assert abs(port_gap - jax_gap) <= STREAM_PAIR_ATOL, gaps
    assert gaps["port"][0] > 10 * STREAM_PAIR_ATOL, gaps


def test_dropout_is_shared_and_layout_refused(monkeypatch):
    """Dropout layers are `SharedDropout` (one mask per step for the VAT
    chains and the supervised forward); 'folded' and an unknown frontend
    raise, CQT builds; CUDA is the default device."""
    model = SemanticSegmentation(device="cpu")
    drops = [m for m in model.modules() if isinstance(m, SharedDropout)]
    # 2 in each of 14 encoder and 4 transposed blocks, 1 in each of 3
    # decoder blocks, dropout_last
    assert len(drops) == 40 and all(m.p == 0.4 for m in drops)
    with pytest.raises(NotImplementedError, match="TPU"):
        SemanticSegmentation(device="cpu", conv_layout="folded")
    assert SemanticSegmentation(device="cpu", spec="CQT").n_bins == 176
    with pytest.raises(ValueError, match="unknown spectrogram"):
        SemanticSegmentation(device="cpu", spec="STFT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemanticSegmentation()
