"""The port's attention models (`reconvat_tpu_torch/models/
attention_models.py`) and `MultiHeadAttention1D`'s options against the JAX
package's, on the CPU, at their default widths (model_complexity 48, 8
heads of Dh = 6; `OnsetsAndFramesSelfAttention` 8 heads of 96) over
32-frame clips.

Weights: the port's seeded init carried into the JAX tree (`torch_to_flax`
on a `jax.eval_shape` template, the O&F conv trunk's reference names
`cnn.N`, `fc.0` renamed to the JAX package's `conv0` ... `fc`, as
`flax_to_torch` renames them back), perturbed (`_perturb`), and carried
back (`flax_to_torch`). Dropout is off on both sides: p = 0 in the port,
`flax.linen.Dropout.__call__` the identity in the test. The JAX sides are
jitted.

Tolerances:
- eval forward (every output) and train-mode `run_on_batch` losses
  without VAT: atol 1e-4 (rtol 1e-4), fp32 on both sides; the running
  statistics rtol 1e-4, atol 1e-5.
- VAT losses: both packages in float64 (the JAX attention keeps its
  softmax in fp32 in x64 mode), 1 labeled + 1 unlabeled clip, xi 0.1, the
  directions pinned to the port's draws: rtol 1e-5.
- `MultiHeadAttention1D` options (a N(0, 1) input: large unscaled
  energies, a peaked softmax): the output and the gradients within 1e-4
  of their largest magnitude, the probabilities atol 1e-4.
"""
import re

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

import reconvat_tpu.models.attention_models as jam
from reconvat_tpu.nn.attention import MultiHeadAttention1D as JaxMHA1D
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import weights
from reconvat_tpu_torch.models import MODEL_REGISTRY, NOT_PORTED, get_model
from reconvat_tpu_torch.models import attention_models as am
from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D
from reconvat_tpu_torch.nn.layers import SharedDropout
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_reconvat import _perturb
from .torch_threads import torch_one_thread  # noqa: F401

ATOL = RTOL = 1e-4
VAT_RTOL = 1e-5
FRAMES, XI, SEED = 32, 0.1, 5
# case -> (registry name, constructor keys, eval outputs' names)
CASES = {
    "sa1d": ("VATSelfAttention1D", {}, ("frame", "attention")),
    "cnn_a": ("VATCNNAttention1D", {}, ("frame", "attention")),
    "cnn_b": ("VATCNNAttention1D", {"version": "b"}, ("frame", "attention")),
    "onset_frame": ("VATCNNAttentionOnsetFrame", {},
                    ("frame", "onset", "attention")),
    "of_self": ("OnsetsAndFramesSelfAttention", {},
                ("onset", "activation", "frame", "attention")),
    "simple": ("SimpleOnsetFrame", {}, ("frame", "onset", "attention")),
    "sa1d_standalone": ("StandaloneSelfAttention1D", {},
                        ("frame", "attention")),
    "sa1d_ln_after": ("StandaloneSelfAttention1D",
                      {"layernorm_pos": "After"}, ("frame", "attention")),
    "sa2d": ("StandaloneSelfAttention2D", {}, ("frame", "attention")),
    "reconstructor": ("Reconstructor", {}, ("reconstruction", "attention")),
}
VAT_CASES = ("sa1d", "cnn_a", "cnn_b", "onset_frame")
_TRUNK = {"0": "conv0", "1": "bn0", "3": "conv1", "4": "bn1", "8": "conv2",
          "9": "bn2"}


def _jax_names(sd):
    """The port's state_dict under the JAX package's module names: the
    O&F conv trunk's `cnn.N` and `fc.0` -> `conv0` ... `fc` (the inverse
    of `flax_to_torch`'s rename)."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"(^|\.)cnn\.(\d)\.", lambda m: f"{m.group(1)}"
                   f"{_TRUNK[m.group(2)]}.", k)
        out[k.replace(".fc.0.", ".fc.")] = v
    return out


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, SharedDropout):
            m.p = 0.0
    return model


@pytest.fixture
def flax_no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **kw: x)


def _template(jmodel):
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=FRAMES)))


@pytest.fixture(scope="module")
def trees():
    """{case: the JAX tree of the port's seeded init, perturbed}; the
    port's state_dict comes back through `torch_to_flax` with nothing
    skipped."""
    out = {}
    for case, (name, kw, _) in CASES.items():
        port = get_model(name, device="cpu", seed=0, **kw)
        template = _template(getattr(jam, name)(**kw))
        variables, report = torch_to_flax(_jax_names(port.state_dict()),
                                          template)
        assert report["skipped"] == [], (case, report["skipped"])
        out[case] = _perturb(variables, 0)
    return out


def _pair(trees, case, **extra):
    """(JAX model, its variables, the port with the same weights)."""
    name, kw, _ = CASES[case]
    port = _no_dropout(get_model(name, device="cpu", **kw, **extra))
    port.load_state_dict(flax_to_torch(trees[case], port), strict=True)
    return getattr(jam, name)(**kw, **extra), trees[case], port


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
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    assert np.shape(got) == np.shape(ref), name
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_losses_match_jax(trees, case, flax_no_dropout):
    """Every output of the eval forward, then `run_on_batch` without VAT
    (B = 2, train=True: the losses, their keys, and the running
    statistics after it)."""
    jmodel, v, port = _pair(trees, case)
    name, kw, names = CASES[case]
    rng = np.random.RandomState(2)
    if case == "reconstructor":
        x = (rng.rand(1, FRAMES, 88) < 0.1).astype(np.float32)
    else:
        x = rng.rand(1, FRAMES, 229).astype(np.float32)
    ref = _outputs(jax.jit(lambda v, x: jmodel.module.apply(
        v, x, train=False))(v, jnp.asarray(x)))
    port.eval()
    with torch.no_grad():
        got = _outputs(port(torch.from_numpy(x)))
    assert len(got) == len(ref) == len(names)
    for out_name, a, b in zip(names, got, ref):
        _close(out_name, a, b)

    batch_l, _ = _batch(2)

    def run(v, b):
        out = jmodel.run_on_batch(v, b, None, jax.random.PRNGKey(0),
                                  vat=False, train=True)
        return out[1], out[3]

    losses, stats = jax.jit(run)(v, batch_l)
    _, got, _ = port.run_on_batch(_torch(batch_l), None,
                                  torch.Generator().manual_seed(0),
                                  vat=False, train=True)
    assert set(got) == set(losses)
    for k, val in losses.items():
        _close(k, got[k], val)
    ref = {k: w for k, w in flax_to_torch(
        {"params": v["params"], "batch_stats": stats or {}}, port).items()
        if "running" in k}
    sd = port.state_dict()
    assert set(ref) == {k for k in sd if "running" in k}
    for k, w in ref.items():
        _close(k, sd[k], w.numpy(), atol=1e-5)


class _Jnp64:
    """`jax.numpy` with float32 read as float64 (the JAX VAT chain's
    direction draw)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("case", VAT_CASES)
def test_vat_losses_match_jax(trees, case, flax_no_dropout):
    """Both VAT chains in float64 (1 labeled + 1 unlabeled clip, xi 0.1,
    an `eps` given to the call), the directions pinned to the port's
    draws: every loss."""
    variables = trees[case]
    name, kw, _ = CASES[case]
    jmodel = getattr(jam, name)(xi=XI, **kw)
    g = torch.Generator().manual_seed(SEED)
    dirs = [jnp.asarray(torch.randn((1, FRAMES, 229), dtype=torch.float64,
                                    generator=g).numpy()) for _ in range(2)]
    batch_l, batch_ul = _batch(1, seed=1, dtype=np.float64)
    real = jam.vat_loss

    def pinned(apply_fn, x, key, cfg, init_d=None, y_ref=None, split=None):
        return real(apply_fn, x, key, cfg, init_d=dirs.pop(0), y_ref=y_ref,
                    split=split)

    def run(v, b_l, b_ul):
        return jmodel.run_on_batch(v, b_l, b_ul, jax.random.PRNGKey(1),
                                   vat=True, train=True, eps=0.5)[1]

    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jam, "vat_loss", pinned)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        ref = jax.tree_util.tree_map(np.asarray,
                                     jax.jit(run)(v64, batch_l, batch_ul))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "_tensor",
                   lambda w: torch.tensor(np.asarray(w, np.float64)))
        port = _no_dropout(get_model(name, device="cpu", xi=XI,
                                     **kw)).double()
        sd = weights.flax_to_torch(variables, port)
    port.load_state_dict(sd, strict=True)
    _, got, _ = port.run_on_batch(_torch(batch_l), _torch(batch_ul),
                                  torch.Generator().manual_seed(SEED),
                                  vat=True, train=True, eps=0.5)
    assert set(got) == set(ref)
    lds = [k for k in ref if "_LDS" in k]
    assert lds and all(ref[k] > 0 for k in lds), ref
    for k, val in ref.items():
        _close(k, got[k], val, rtol=VAT_RTOL, atol=1e-12)


@pytest.mark.parametrize("position,use_bias,return_probs", [
    (True, False, True), (False, False, True), (True, True, False),
    (False, True, True)])
def test_attention_1d_options_match_jax(position, use_bias, return_probs):
    """`MultiHeadAttention1D` at 8 heads of Dh = 6 with and without `rel`,
    with biased projections and without the probabilities: the output,
    the probabilities, and the gradients of a weighted sum with respect
    to the input and every parameter, through the kernel route (the
    plain versions on the CPU) and through the plain forward."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 40, 229).astype(np.float32)
    wsum = rng.randn(2, 40, 48).astype(np.float32)
    jmod = JaxMHA1D(out_features=48, kernel_size=31, groups=8,
                    position=position, use_bias=use_bias,
                    return_probs=return_probs)
    v = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(3), jnp.asarray(x)))
    assert ("rel" in v["params"]) == position

    def loss(p, x):
        return (jmod.apply({"params": p}, x)[0] * wsum).sum()

    ref_out, ref_probs = jmod.apply(v, jnp.asarray(x))
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    ref_grads = {k.split(".", 1)[1]: w for k, w in flax_to_torch(
        {"params": {"m": g_p}}).items()}
    mod = MultiHeadAttention1D(229, 48, 31, 8, position=position,
                               use_bias=use_bias, return_probs=return_probs)
    assert (mod.rel is None) != position
    assert (mod.W_q.bias is not None) == use_bias
    mod.load_state_dict({k.split(".", 1)[1]: w for k, w in flax_to_torch(
        {"params": {"m": v["params"]}}).items()}, strict=True)
    for use_kernel in (True, False):
        mod.use_kernel = use_kernel
        mod.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_(True)
        out, probs = mod(xt)
        (out * torch.from_numpy(wsum)).sum().backward()
        top = max(np.abs(np.asarray(g)).max() for g in ref_grads.values())
        _close("out", out, ref_out, rtol=0, atol=1e-4 * np.abs(
            np.asarray(ref_out)).max())
        if return_probs:
            _close("probs", probs, ref_probs)
        else:
            assert probs is None and ref_probs is None
        _close("d/dx", xt.grad, g_x, rtol=0,
               atol=1e-4 * np.abs(np.asarray(g_x)).max())
        assert {k for k, _ in mod.named_parameters()} == set(ref_grads)
        for k, p in mod.named_parameters():
            _close(k, p.grad / top, ref_grads[k].numpy() / top, rtol=0)


def test_triangular_cycle_and_registry():
    """`create_triangular_cycle` equals the JAX package's over two
    periods; the hard-wired cycle of `VATCNNAttention1D`, the configured
    one of `eps_period`; every name of the JAX package's registry builds,
    `NOT_PORTED` is empty and unknown names raise KeyError."""
    from reconvat_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    for args in ((1e-2, 10, 50), (0.1, 1.0, 5)):
        a, b = am.create_triangular_cycle(*args), \
            jam.create_triangular_cycle(*args)
        np.testing.assert_array_equal([next(a) for _ in range(200)],
                                      [next(b) for _ in range(200)])
    model = am.VATCNNAttention1D(device="cpu", version="b")
    ref = jam.create_triangular_cycle(1e-2, 10, 50)
    assert [next(model.triangular_cycle) for _ in range(60)] == \
        [next(ref) for _ in range(60)]
    assert am.VATSelfAttention1D(device="cpu").triangular_cycle is None
    cyc = am.VATSelfAttention1D(device="cpu", eps=0.2, eps_period=4,
                                eps_max=0.8).triangular_cycle
    np.testing.assert_allclose([next(cyc) for _ in range(6)],
                               [0.2, 0.4, 0.6, 0.8, 0.6, 0.4])
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY) and NOT_PORTED == ()
    for name in JAX_REGISTRY:
        assert get_model(name, device="cpu") is not None
    with pytest.raises(KeyError):
        get_model("NoSuchModel")


@pytest.mark.parametrize("kind", ["timbral", "convstack"])
def test_weights_follow_the_target_at_trunk_widths(kind):
    """A Timbral CNN (48, 96, 768) has the O&F trunk's leaf names and
    widths (768 / 16, 768 / 8): one JAX tree of it loads with strict=True
    into the port's `TimbralCNN` under the JAX names and into its
    `ConvStack` under the reference's, as the target names them."""
    from reconvat_tpu_torch.nn.layers import ConvStack

    x = jnp.zeros((1, 4, 229), jnp.float32)
    shapes = jax.eval_shape(jam.TimbralCNN(48, 96, 768).init,
                            jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), shapes)
    port = (am.TimbralCNN(48, 96, 768) if kind == "timbral"
            else ConvStack(229, 768))
    sd = flax_to_torch(tree, port)
    port.load_state_dict(sd, strict=True)
    conv0 = "conv0.weight" if kind == "timbral" else "cnn.0.weight"
    np.testing.assert_array_equal(
        sd[conv0].numpy(),
        tree["params"]["conv0"]["kernel"].transpose(3, 2, 0, 1))


def test_weights_round_trip(trees):
    """`flax_to_torch` of each model's JAX tree loads into the port with
    strict=True; the port's state_dict comes back equal to that tree, leaf
    for leaf, with nothing skipped (the trunk's names renamed back)."""
    for case, (name, kw, _) in CASES.items():
        port = get_model(name, device="cpu", seed=1, **kw)
        port.load_reference_weights(flax_to_torch(trees[case], port))
        back, report = torch_to_flax(_jax_names(port.state_dict()),
                                     jax.tree_util.tree_map(np.zeros_like,
                                                            trees[case]))
        assert report["skipped"] == [], case
        flat = jax.tree_util.tree_leaves_with_path(trees[case])
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(flat), case
        for p, leaf in flat:
            np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                          err_msg=f"{case} {p}")
