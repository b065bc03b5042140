"""The port's Onsets-and-Frames family (`reconvat_tpu_torch/nn/layers.py`,
`reconvat_tpu_torch/models/onsets_frames.py`) against the JAX package's,
on the CPU, at full width (model_complexity 48: convolutions of 48 and 96
channels, FC 5472 -> 768, BiLSTMs of 2 x 384) over 16-frame clips.

Weights: the port's seeded init, saved as a `.pt` of the reference's names
and read by the JAX package's own loader (`load_reference_weights`: the
renames and `lstm_torch_entries`), perturbed (`_perturb`: random biases and
BatchNorm statistics), and carried back by `flax_to_torch`. Dropout is off
on both sides for the comparisons: `flax.linen.Dropout.__call__` is the
identity inside each test, and the port's dropout p is 0. The JAX sides
are jitted.

Tolerances (tests/test_torch_unet_onset.py's):
- eval forward (every output) and `transcribe` (bucketed and exact):
  atol 1e-4 (rtol 1e-4): fp32 on both sides, other summation orders.
- train-mode `run_on_batch` without VAT: losses rtol 1e-4; BatchNorm
  running statistics rtol 1e-4, atol 1e-5.
- VAT losses: both packages in float64, 1 labeled + 1 unlabeled clip, xi
  0.1, the directions pinned to the port's draws: rtol 1e-6.
- bf16: each output within 2x JAX's own bf16-vs-fp32 gap of JAX's bf16
  output (tests/test_torch_bf16.py's rule).
- the stacks without an LSTM (`use_lstm=False`) and the models at
  `output_features=12`, narrow (model_size 96): atol 1e-4 (rtol 1e-4), as
  the eval forward; their weights through the bridge both ways, exact.
"""
import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

import reconvat_tpu.models.onsets_frames as jof_mod
import reconvat_tpu.nn.layers as jlayers
from reconvat_tpu.models.common import transcribe_spec as jax_transcribe_spec
from reconvat_tpu.nn.layers import BiLSTM as JaxBiLSTM
from reconvat_tpu.nn.layers import ConvStack as JaxConvStack
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import weights
from reconvat_tpu_torch.models import get_model
from reconvat_tpu_torch.models.onsets_frames import (FrameStackVAT,
                                                     OnsetsAndFrames,
                                                     OnsetStackVAT)
from reconvat_tpu_torch.nn.layers import (BiLSTM, CombineStack, ConvStack,
                                          OnsetStack, SharedDropout,
                                          new_dropout_masks)
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_bf16 import assert_within_jax_gap
from .test_torch_reconvat import _audio, _perturb
from .torch_threads import torch_one_thread  # noqa: F401

ATOL = RTOL = 1e-4
FRAMES, XI, SEED = 16, 0.1, 5
VAT_RTOL = 1e-6
# (port class, JAX class, output names of the eval forward)
MODELS = {
    "onset_frame": (OnsetsAndFrames, jof_mod.OnsetsAndFrames,
                    ("onset", "activation", "frame")),
    "frame": (FrameStackVAT, jof_mod.FrameStackVAT, ("activation", "frame")),
    "onset": (OnsetStackVAT, jof_mod.OnsetStackVAT, ("onset",)),
}


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
def trees(tmp_path_factory):
    """{name: the JAX tree of the port's seeded init (read by the JAX
    package's loader from a .pt), perturbed}."""
    out = {}
    for name, (cls, jcls, _) in MODELS.items():
        path = str(tmp_path_factory.mktemp(name) / "weight.pt")
        torch.save(cls(device="cpu", seed=0).state_dict(), path)
        jmodel = jcls()
        out[name] = _perturb(jmodel.load_reference_weights(
            path, _template(jmodel)), 0)
    return out


def _pair(trees, name, **kw):
    """(JAX model, its variables, port model with the same weights)."""
    cls, jcls, _ = MODELS[name]
    port = _no_dropout(cls(device="cpu", **kw))
    port.load_state_dict(flax_to_torch(trees[name], port), strict=True)
    return jcls(**kw), trees[name], port


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
    assert got.shape == np.shape(ref), name
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


class _Jnp64:
    """`jax.numpy` with float32 read as float64: the JAX BiLSTM casts its
    input to float32 (its fp32 recurrence policy), which a float64 run
    lifts to float64, as the port's LSTM keeps a float64 input."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_convstack_and_bilstm_match_jax(flax_no_dropout):
    """The layers alone: ConvStack (eval and train mode, with the running
    statistics after the train-mode call) and the BiLSTM (output, and the
    gradients of a weighted sum with respect to its input and weights)."""
    x = np.random.RandomState(0).rand(2, FRAMES, 229).astype(np.float32)
    jconv = JaxConvStack(229, 768)
    v = _perturb(jax.jit(jconv.init)(jax.random.PRNGKey(1), jnp.asarray(x)),
                 1)
    conv = _no_dropout(ConvStack(229, 768))
    wrapped = ["convstack." + k for k in conv.state_dict()]
    conv.load_state_dict({k.split(".", 1)[1]: w for k, w in flax_to_torch(
        {c: {"convstack": t} for c, t in v.items()}, wrapped).items()},
        strict=True)
    conv.eval()
    with torch.no_grad():
        _close("convstack eval", conv(torch.from_numpy(x)),
               jax.jit(lambda v, x: jconv.apply(v, x, False))(v, x))
    ref, upd = jax.jit(lambda v, x: jconv.apply(
        v, x, True, mutable=["batch_stats"]))(v, x)
    conv.train()
    with torch.no_grad():
        _close("convstack train", conv(torch.from_numpy(x)), ref)
    stats = {k.split(".", 1)[1]: w for k, w in flax_to_torch(
        {"params": {}, "batch_stats": {"convstack": upd["batch_stats"]}},
        wrapped)
        .items() if "running" in k}
    for k, w in stats.items():
        _close(k, conv.state_dict()[k], w.numpy(), atol=1e-5)

    h = np.random.RandomState(2).randn(2, FRAMES, 176).astype(np.float32)
    wsum = np.random.RandomState(3).randn(2, FRAMES, 768).astype(np.float32)
    jlstm = JaxBiLSTM(384)
    lv = jax.jit(jlstm.init)(jax.random.PRNGKey(2), jnp.asarray(h))
    lstm = BiLSTM(176, 384)
    lstm.load_state_dict({k.split(".", 1)[1]: w for k, w in flax_to_torch(
        {"params": {"sequence_model": lv["params"]}}).items()}, strict=True)
    ht = torch.from_numpy(h).requires_grad_(True)
    out = lstm(ht)
    (out * torch.from_numpy(wsum)).sum().backward()

    def loss(p, h):
        return (jlstm.apply({"params": p}, h) * wsum).sum()

    ref_out = jax.jit(jlstm.apply)(lv, jnp.asarray(h))
    g_p, g_h = jax.jit(jax.grad(loss, argnums=(0, 1)))(lv["params"],
                                                       jnp.asarray(h))
    _close("bilstm", out, ref_out)
    _close("bilstm d/dx", ht.grad, g_h)
    got = {k.split(".", 1)[1]: w for k, w in flax_to_torch(
        {"params": {"sequence_model": g_p}}).items()}
    for k, p in lstm.named_parameters():
        if k.startswith("bias_hh"):   # the fused bias's gradient is bias_ih's
            _close(k, p.grad, got[k.replace("hh", "ih")])
        else:
            _close(k, p.grad, got[k])


@pytest.mark.parametrize("stack", ["onset", "combine"])
def test_stacks_without_lstm_match_jax(stack, flax_no_dropout):
    """`OnsetStack` and `CombineStack` with `use_lstm=False`, at a narrow
    model_size of 96: no `sequence_model`, the linear head reading the
    conv trunk (96 features) or the input (176), as the JAX package's
    `Dense` infers them. Eval forward (train mode for the trunk's
    BatchNorm too) against the JAX module, its tree carried in by
    `flax_to_torch` with strict=True and back by the JAX package's
    `torch_to_flax` with nothing skipped, leaf for leaf (the trunk's
    reference names renamed back to the JAX package's as its loader
    does)."""
    width = 229 if stack == "onset" else 176
    x = np.random.RandomState(4).rand(2, FRAMES, width).astype(np.float32)
    if stack == "onset":
        jmod, port = (jlayers.OnsetStack(width, 96, 88, use_lstm=False),
                      OnsetStack(width, 96, 88, use_lstm=False))
    else:
        jmod, port = (jlayers.CombineStack(96, 88, use_lstm=False),
                      CombineStack(width, 96, 88, use_lstm=False))
    v = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(3), jnp.asarray(x)),
                 3)
    port = _no_dropout(port)
    assert port.sequence_model is None
    assert port.linear.in_features == (96 if stack == "onset" else width)
    port.load_state_dict(flax_to_torch(v, port), strict=True)
    inverse = {f".{t}.": f".{j}." for j, t in weights._CONVSTACK.items()}
    sd = {}
    for k, w in port.state_dict().items():
        for t, j in inverse.items():
            k = k.replace(t, j)
        sd[k] = w
    back, report = torch_to_flax(sd, v)
    assert report["skipped"] == []
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    for p, leaf in jax.tree_util.tree_leaves_with_path(v):
        np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                      err_msg=str(p))
    for train in (False, True):
        port.train(train)
        ref = jax.jit(lambda v, x: jmod.apply(
            v, x, train, mutable=["batch_stats"])[0])(v, x)
        with torch.no_grad():
            _close(f"{stack} train={train}", port(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("name", list(MODELS))
def test_output_features_forward_matches_jax(name, tmp_path):
    """`output_features` at 12 keys and model_complexity 6 (trunks of 96):
    every roll has 12 keys, and the eval forward matches the JAX model's
    on the same weights (the port's seeded init read by the JAX package's
    loader, perturbed, carried back by `flax_to_torch`)."""
    cls, jcls, outputs = MODELS[name]
    kw = dict(output_features=12, model_complexity=6)
    port = _no_dropout(cls(device="cpu", seed=2, **kw))
    jmodel = jcls(**kw)
    path = str(tmp_path / "weight.pt")
    torch.save(port.state_dict(), path)
    variables = _perturb(jmodel.load_reference_weights(
        path, _template(jmodel)), 2)
    port.load_state_dict(flax_to_torch(variables, port), strict=True)
    port.eval()
    x = _spec_input()
    ref = _outputs(jax.jit(lambda v, x: jmodel.module.apply(
        v, x, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _outputs(port(torch.from_numpy(x)))
    assert len(got) == len(ref) == len(outputs)
    for out_name, a, b in zip(outputs, got, ref):
        assert a.shape[-1] == 12, out_name
        _close(out_name, a, b)


_JAX_FORWARD = {}


def _jax_forward(name, variables, x, compute_dtype=None):
    """The JAX model's eval forward on x, one jit per model and dtype (the
    forward and bf16 tests share the fp32 one)."""
    key = (name, compute_dtype)
    if key not in _JAX_FORWARD:
        jmodel = MODELS[name][1](compute_dtype=compute_dtype)
        _JAX_FORWARD[key] = jax.jit(lambda v, x: jmodel.module.apply(
            v, x, train=False))
    return _outputs(_JAX_FORWARD[key](variables, jnp.asarray(x)))


def _spec_input(seed=2):
    return np.random.RandomState(seed).rand(1, FRAMES, 229).astype(
        np.float32)


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_forward_and_transcribe_match_jax(trees, name):
    """Every output of the eval forward, and `transcribe` bucketed by 16
    on 40 frames, against the JAX package's: its own `transcribe` for the
    full model (exact too), its eval forward on `transcribe_spec` for the
    two ablations (whose JAX `transcribe` unpacks the full model's three
    outputs from their two and one)."""
    jmodel, v, port = _pair(trees, name)
    x = _spec_input()
    ref = _jax_forward(name, v, x)
    with torch.no_grad():
        got = _outputs(port(torch.from_numpy(x)))
    assert len(got) == len(ref) == len(MODELS[name][2])
    for out_name, a, b in zip(MODELS[name][2], got, ref):
        _close(out_name, a, b)

    audio = _audio(2, 512 * 40 + 7, seed=3)
    cases = [(audio, 16)]
    if name == "onset_frame":
        cases.append((audio[:, :FRAMES * 512], 0))
    for a, bucket in cases:
        if name == "onset_frame":
            ref = jax.jit(lambda v, a: jmodel.transcribe(v, a, bucket))(
                v, jnp.asarray(a))
        else:
            def run(v, a):
                spec, t_true = jax_transcribe_spec(jmodel, a, bucket)
                outs = _outputs(jmodel.module.apply(v, spec, train=False))
                return {"onset": outs[-1 if name == "frame" else 0][
                    :, :t_true], "frame": outs[-1][:, :t_true]}

            ref = jax.jit(run)(v, jnp.asarray(a))
        got = port.transcribe(torch.from_numpy(a), bucket)
        assert torch.equal(got["onset"], got["frame"]) == (
            name != "onset_frame")
        for k in ("onset", "frame"):
            _close(f"transcribe {k} {bucket}", got[k], ref[k])


@pytest.mark.parametrize("name", list(MODELS))
def test_train_losses_and_running_stats_match_jax(trees, name,
                                                  flax_no_dropout):
    """Train-mode run_on_batch without VAT (B = 2): every loss and metric,
    and the running statistics after it."""
    jmodel, v, port = _pair(trees, name)
    batch_l, _ = _batch(2)

    def run(v, b):
        _, losses, _, stats = jmodel.run_on_batch(
            v, b, None, jax.random.PRNGKey(0), vat=False, train=True)
        return losses, stats

    losses, stats = jax.jit(run)(v, batch_l)
    _, got, _ = port.run_on_batch(_torch(batch_l), None,
                                  torch.Generator().manual_seed(0),
                                  vat=False, train=True)
    assert set(got) == set(losses)
    for k, val in losses.items():
        _close(k, got[k], val, atol=1e-7)
    ref = {k: w for k, w in flax_to_torch(
        {"params": {}, "batch_stats": stats}, port).items() if "running" in k}
    sd = port.state_dict()
    assert set(ref) == {k for k in sd if "running" in k}
    for k, w in ref.items():
        _close(k, sd[k], w.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_vat_losses_match_jax(trees, name, flax_no_dropout):
    """Both VAT chains in float64 (1 labeled + 1 unlabeled clip), the
    directions pinned to the port's draws: every loss."""
    variables = trees[name]
    cls, jcls, _ = MODELS[name]
    jmodel = jcls(xi=XI)
    g = torch.Generator().manual_seed(SEED)
    dirs = [jnp.asarray(torch.randn((1, FRAMES, 229), dtype=torch.float64,
                                    generator=g).numpy()) for _ in range(2)]
    batch_l, batch_ul = _batch(1, seed=1, dtype=np.float64)
    real = jof_mod.vat_loss

    def pinned(apply_fn, x, key, cfg, init_d=None, y_ref=None, split=None):
        return real(apply_fn, x, key, cfg, init_d=dirs.pop(0), y_ref=y_ref,
                    split=split)

    def run(v, b_l, b_ul):
        return jmodel.run_on_batch(v, b_l, b_ul, jax.random.PRNGKey(1),
                                   vat=True, train=True)[1]

    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jof_mod, "vat_loss", pinned)
            mp.setattr(jlayers, "jnp", _Jnp64())
            v64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), variables)
            ref = jax.tree_util.tree_map(
                np.asarray, jax.jit(run)(v64, batch_l, batch_ul))
    finally:
        jax.config.update("jax_enable_x64", False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "_tensor",
                   lambda w: torch.tensor(np.asarray(w, np.float64)))
        port = _no_dropout(cls(device="cpu", xi=XI)).double()
        sd = weights.flax_to_torch(variables, port)
    port.load_state_dict(sd, strict=True)
    gen = torch.Generator().manual_seed(SEED)
    _, got, _ = port.run_on_batch(_torch(batch_l), _torch(batch_ul), gen,
                                  vat=True, train=True)
    assert set(got) == set(ref)
    lds = [k for k in ref if "_LDS" in k]
    assert lds and all(ref[k] > 0 for k in lds), ref
    for k, val in ref.items():
        _close(k, got[k].double(), val, rtol=VAT_RTOL, atol=1e-12)


def test_dropout_masks_are_shared_within_a_step(monkeypatch):
    """The port's dropout has the JAX package's semantics, not torch's:
    within one run_on_batch every call of a layer reuses its mask, so with
    dropout on, the KL form of the LDS loss is 0 at r = 0 (eps 0), where
    masks drawn anew per call make it positive; the next step draws new
    masks; the keep share is 1 - p and kept elements are scaled by
    1 / (1 - p)."""
    port = OnsetsAndFrames(device="cpu", model_complexity=4, eps=0.0,
                           kl_div=True)
    batch_l, batch_ul = (_torch(b) for b in _batch(1, seed=4))
    gen = torch.Generator().manual_seed(0)
    drops = [m for m in port.modules() if isinstance(m, SharedDropout)]

    def lds():
        _, losses, _ = port.run_on_batch(batch_l, batch_ul, gen, vat=True,
                                         train=True)
        return [losses[f"loss/train_LDS_{k}"].item() for k in ("l", "ul")]

    assert max(lds()) < 1e-6
    assert len(drops) == 6 and all(len(m.masks) == 1 for m in drops)
    first = [next(iter(m.masks.values())) for m in drops]
    lds()
    again = [next(iter(m.masks.values())) for m in drops]
    assert not any(torch.equal(a, b) for a, b in zip(first, again))

    forward = SharedDropout.forward

    def fresh(self, x):
        self.masks = {}
        return forward(self, x)

    monkeypatch.setattr(SharedDropout, "forward", fresh)
    assert min(lds()) > 1e-3

    monkeypatch.undo()
    drop = SharedDropout(0.25).train()
    new_dropout_masks(drop, torch.Generator().manual_seed(1))
    x = torch.ones(64, 64, 32)
    y = drop(x)
    assert torch.equal(drop(x), y)
    kept = y != 0
    assert kept.float().mean().item() == pytest.approx(0.75, abs=5e-3)
    assert torch.all(y[kept] == 1 / 0.75)
    assert torch.equal(drop.eval()(x), x)


def test_bilstm_stays_in_training_mode():
    """cuDNN's RNN backward needs training mode: the BiLSTMs stay in it
    under model.eval() and inside an eval-mode VAT target, while BatchNorm
    and dropout follow the model's mode."""
    port = OnsetsAndFrames(device="cpu", model_complexity=4)
    lstms = [m for m in port.modules() if isinstance(m, BiLSTM)]
    assert len(lstms) == 2
    port.eval()
    assert all(m.training for m in lstms)
    assert not port.onset_stack.convstack.cnn[1].training
    seen = []
    hook = lstms[0].register_forward_hook(
        lambda m, i, o: seen.append((m.training, port.training)))
    port._transcriber_fn(False)(torch.rand(1, FRAMES, 229))
    port.train()
    port._transcriber_fn(False)(torch.rand(1, FRAMES, 229))
    hook.remove()
    assert seen == [(True, False), (True, False)]
    assert port.training


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_forward_within_jax_gap(trees, name):
    """Eval forward with compute_dtype='bfloat16': every output of the
    port's bf16 model within 2x JAX's bf16-vs-fp32 gap of JAX's bf16
    output; the conv trunks run in bf16, the LSTMs and heads in fp32."""
    x = _spec_input()
    outs = {}
    for dtype in (None, "bfloat16"):
        _, v, port = _pair(trees, name, compute_dtype=dtype)
        with torch.no_grad():
            outs[dtype] = (_jax_forward(name, v, x, dtype),
                           _outputs(port(torch.from_numpy(x))))
    (j32, p32), (j16, p16) = outs[None], outs["bfloat16"]
    for out_name, a, b, c, d in zip(MODELS[name][2], p16, j16, j32, p32):
        assert a.dtype == torch.float32, out_name
        assert_within_jax_gap(out_name, a, b, c, d)


@pytest.mark.parametrize("name", list(MODELS))
def test_weights_round_trip(trees, name, tmp_path):
    """flax_to_torch of a JAX tree loads into the port with strict=True
    (also through `load_reference_weights`), and the port's state_dict,
    saved as a .pt, comes back through the JAX package's loader equal to
    that tree, leaf for leaf."""
    cls, jcls, _ = MODELS[name]
    variables = trees[name]
    port = cls(device="cpu", seed=1)
    port.load_reference_weights(flax_to_torch(variables, port))
    path = str(tmp_path / "weight.pt")
    torch.save(port.state_dict(), path)
    jmodel = jcls()
    back = jmodel.load_reference_weights(path, _template(jmodel))
    flat = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for p, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[p]), leaf,
                                      err_msg=str(p))
    assert type(get_model({"onset_frame": "OnsetsAndFrames", "frame":
                           "FrameStack", "onset": "OnsetStack"}[name],
                          device="cpu")) is cls


def test_cuda_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, _, _ in MODELS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
