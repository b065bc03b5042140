"""The port's Thickstun and Prestack baselines (`reconvat_tpu_torch/models/
thickstun.py`, `prestack.py`) against the JAX package's, on the CPU, at
full width (Thickstun: 128 x (128, 1) and 4096 x (1, 25) convolutions,
4096 x 51 -> 88; Prestack: the stride-1 U-Net and ResNet-18 on 229 x 25
patches) over 16-frame (Thickstun) and 8-frame (Prestack) clips.

Weights: the port's seeded init, saved as a `.pt` of the reference's names
and read by the JAX package's own loader (Thickstun's (3, 2, 1, 0) kernel
permutation, Prestack's `prestack_model.{0,1}` renames), perturbed
(`_perturb`), and carried back by `flax_to_torch`. The JAX sides are
jitted. Tolerances: tests/test_torch_onsets_frames.py's (eval forward and
`transcribe` atol 1e-4; train losses rtol 1e-4; running statistics rtol
1e-4, atol 1e-5; bf16 within 2x JAX's own bf16-vs-fp32 gap).

Prestack's train-mode comparison holds the port's fp32 step to the JAX
package run in float64: Flax's `BatchNorm` (the ResNet's) takes the batch
variance as E[x^2] - E[x]^2 in fp32, which puts the JAX package's own fp32
running statistics up to 8e-5 from its float64 ones at `layer4`, where the
port's fp32 statistics lie within 5e-7 of them.

In the bf16 comparison a bf16 convolution on the CPU is taken as the fp32
convolution of its bf16 operands, rounded to bf16 (`_bf16_conv`: bf16
products summed in fp32, as cuDNN and XLA compute it): torch's oneDNN bf16
convolution on the CPU returns NaN, or zeros, at the ResNet's 256 -> 512
stride-2 convolution on its 15 x 2 maps, and torch's native one takes 11 s
for a 4-frame Prestack forward. The port's casts, which decide the layers
that run in bf16, are what the test holds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.models.prestack import Prestack as JaxPrestack
from reconvat_tpu.models.thickstun import Thickstun as JaxThickstun
from reconvat_tpu_torch.models import get_model
from reconvat_tpu_torch.models.prestack import Prestack
from reconvat_tpu_torch.models.thickstun import Thickstun
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_bf16 import assert_within_jax_gap
from .test_torch_reconvat import _audio, _perturb
from .torch_threads import torch_one_thread  # noqa: F401

ATOL = RTOL = 1e-4
# (port class, JAX class, frames)
MODELS = {"thickstun": (Thickstun, JaxThickstun, 16),
          "prestack": (Prestack, JaxPrestack, 8)}


def _template(jmodel, frames):
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=frames)))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{name: the JAX tree of the port's seeded init (read by the JAX
    package's loader from a .pt), perturbed}."""
    out = {}
    for name, (cls, jcls, frames) in MODELS.items():
        path = str(tmp_path_factory.mktemp(name) / "weight.pt")
        torch.save(cls(device="cpu", seed=0).state_dict(), path)
        jmodel = jcls()
        out[name] = _perturb(jmodel.load_reference_weights(
            path, _template(jmodel, frames)), 0)
    return out


def _pair(trees, name, **kw):
    cls, jcls, _ = MODELS[name]
    port = cls(device="cpu", **kw)
    port.load_state_dict(flax_to_torch(trees[name], port), strict=True)
    return jcls(**kw), trees[name], port


def _bf16_conv(conv):
    """F.conv2d with bf16 operands taken as the fp32 convolution of those
    operands, rounded to bf16 (see the module's docstring)."""
    def run(x, w, b=None, *args):
        if x.dtype != torch.bfloat16:
            return conv(x, w, b, *args)
        return conv(x.float(), w.float(), None if b is None else b.float(),
                    *args).bfloat16()
    return run


_JAX_FORWARD = {}


def _jax_forward(name, variables, x, compute_dtype=None):
    """The JAX model's eval forward on x, one jit per model and dtype (the
    forward and bf16 tests share the fp32 one)."""
    key = (name, compute_dtype)
    if key not in _JAX_FORWARD:
        jmodel = MODELS[name][1](compute_dtype=compute_dtype)
        _JAX_FORWARD[key] = jax.jit(lambda v, x: jmodel.module.apply(
            v, x, train=False))
    return _JAX_FORWARD[key](variables, jnp.asarray(x))


def _spec_input(name):
    return np.random.RandomState(2).rand(1, MODELS[name][2], 229).astype(
        np.float32)


def _close(name, got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().double().numpy()
    assert got.shape == np.shape(ref), name
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_forward_and_transcribe_match_jax(trees, name):
    """The eval forward's posteriogram (Prestack: its logits) and
    `transcribe` bucketed by 8 (on 3 frames past a bucket; the exact path
    of the shared `FrameSpecModel.transcribe` is held in
    tests/test_torch_onsets_frames.py)."""
    jmodel, v, port = _pair(trees, name)
    frames = MODELS[name][2]
    x = _spec_input(name)
    with torch.no_grad():
        _close("forward", port(torch.from_numpy(x)), _jax_forward(name, v, x))
    audio = _audio(1, 512 * (frames + 2) + 7, seed=3)
    ref = jax.jit(lambda v, a: jmodel.transcribe(v, a, 8))(
        v, jnp.asarray(audio))
    got = port.transcribe(torch.from_numpy(audio), 8)
    assert torch.equal(got["onset"], got["frame"])
    _close("transcribe", got["frame"], ref["frame"])


@pytest.mark.parametrize("name", list(MODELS))
def test_train_losses_and_running_stats_match_jax(trees, name):
    """Train-mode run_on_batch (Thickstun B = 2; Prestack B = 1, against
    the JAX package's in float64, see the module's docstring): the loss
    under its reference key, and Prestack's running statistics after it
    (batch statistics over the B x T patches)."""
    jmodel, v, port = _pair(trees, name)
    frames = MODELS[name][2]
    x64 = name == "prestack"
    rng = np.random.RandomState(0)
    b = 1 if x64 else 2
    batch = {"audio": (rng.randn(b, frames * 512) * 0.1).astype(np.float32),
             "frame": (rng.rand(b, frames, 88) < 0.05).astype(np.float32)}

    def run(v, b):
        _, losses, _, stats = jmodel.run_on_batch(v, b, None, None,
                                                  train=True)
        return losses, stats

    jax.config.update("jax_enable_x64", x64)
    try:
        dtype = jnp.float64 if x64 else jnp.float32
        losses, stats = jax.tree_util.tree_map(np.asarray, jax.jit(run)(
            *jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    (v, batch))))
    finally:
        jax.config.update("jax_enable_x64", False)
    _, got, spec = port.run_on_batch(
        {k: torch.from_numpy(a) for k, a in batch.items()}, train=True)
    assert list(got) == ["loss/train_frame"] == list(losses)
    assert spec.shape == (b, frames, 229)
    _close("loss/train_frame", got["loss/train_frame"],
           losses["loss/train_frame"], atol=1e-7)
    sd = port.state_dict()
    running = {k for k in sd if "running" in k}
    if stats is None:
        assert not running
        return
    ref = {k: w for k, w in flax_to_torch(
        {"params": {}, "batch_stats": stats}, port).items()
        if "running" in k}
    assert set(ref) == running
    for k, w in ref.items():
        _close(k, sd[k], w.double().numpy(), atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_forward_within_jax_gap(trees, name, monkeypatch):
    """Eval forward with compute_dtype='bfloat16' within 2x JAX's
    bf16-vs-fp32 gap of JAX's bf16 output; Thickstun's posteriogram and
    Prestack's logits are fp32."""
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        _bf16_conv(torch.nn.functional.conv2d))
    x = _spec_input(name)
    outs = {}
    for dtype in (None, "bfloat16"):
        _, v, port = _pair(trees, name, compute_dtype=dtype)
        with torch.no_grad():
            outs[dtype] = (_jax_forward(name, v, x, dtype),
                           port(torch.from_numpy(x)))
    (j32, p32), (j16, p16) = outs[None], outs["bfloat16"]
    assert p16.dtype == torch.float32
    assert_within_jax_gap(name, p16, j16, j32, p32)


@pytest.mark.parametrize("name", list(MODELS))
def test_weights_round_trip(trees, name, tmp_path):
    """flax_to_torch of a JAX tree loads into the port with strict=True
    (through `load_reference_weights` too), and the port's state_dict,
    saved as a .pt, comes back through the JAX package's loader (which
    raises on a key it cannot place) equal to that tree, leaf for leaf."""
    cls, jcls, frames = MODELS[name]
    variables = trees[name]
    port = cls(device="cpu", seed=1)
    port.load_reference_weights(flax_to_torch(variables, port))
    path = str(tmp_path / "weight.pt")
    torch.save(port.state_dict(), path)
    jmodel = jcls()
    back = jmodel.load_reference_weights(path, _template(jmodel, frames))
    flat = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for p, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                      err_msg=str(p))
    assert type(get_model(cls.__name__, device="cpu")) is cls


def test_thickstun_weight_layout_is_the_references():
    """The convolutions hold the reference's (O, I, freq, time) weights;
    the flattened features are channel-major per frame."""
    sd = Thickstun(device="cpu").state_dict()
    assert sd["CNN_freq.weight"].shape == (128, 1, 128, 1)
    assert sd["CNN_time.weight"].shape == (4096, 128, 1, 25)
    assert sd["linear.weight"].shape == (88, 4096 * 51)
    assert sorted(sd) == ["CNN_freq.bias", "CNN_freq.weight",
                          "CNN_time.bias", "CNN_time.weight",
                          "linear.weight"]
