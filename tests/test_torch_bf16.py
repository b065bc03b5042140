"""The port's bf16 mixed precision (`compute_dtype='bfloat16'`) against the
JAX package's, on the CPU, with the same weights (`flax_to_torch`).

Tolerance, computed in each test from the JAX package itself: for every
output, max |port_bf16 - jax_bf16| <= 2 * max |jax_bf16 - jax_fp32| on the
same input and weights. The two packages round to bf16 at other places (XLA
rounds the q.k scores to bf16, the port's attention keeps them in fp32 as
the Pallas kernel does; summation orders differ), so the port's bf16 output
may lie as far from JAX's as JAX's bf16 lies from its own fp32, and twice
that covers two roundings that fall apart. Each output must also differ
from the port's own fp32 output by more than 1e-7: bf16 really ran.
The card's tests of the bf16 kernels and of the bf16 attention module are
in `tests/test_torch_kernels.py`, which imports no JAX; the bf16 train step
is held against JAX's in `tests/test_torch_bf16_train.py`.
The JAX models run their default XLA, NHWC path, jitted; BatchNorm is in
eval mode with perturbed statistics (`_perturb`). The weights are the
port's seeded init carried into the JAX tree (`torch_to_flax`), perturbed,
and carried back (`flax_to_torch`): a JAX `init` run op by op costs tens of
seconds of compilation on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu.nn import attention as jattn
from reconvat_tpu.nn.unet import Decoder as JaxDecoder
from reconvat_tpu.nn.unet import Encoder as JaxEncoder
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import serve
from reconvat_tpu_torch.decode import unpack_roll
from reconvat_tpu_torch.models.common import pack_roll_device
from reconvat_tpu_torch.models.reconvat import ReconVAT, init_parameters
from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D
from reconvat_tpu_torch.nn.precision import resolve_compute_dtype
from reconvat_tpu_torch.nn.unet import Decoder, Encoder
from reconvat_tpu_torch.ops import banded_attention_kernel as bak
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_attention import _inputs
from .test_torch_reconvat import _audio, _perturb
from .torch_threads import torch_one_thread  # noqa: F401

BF16 = "bfloat16"
GAP_FACTOR = 2.0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_within_jax_gap(name, port16, jax16, jax32, port32):
    """The module docstring's rule for one output."""
    port16, jax16, jax32, port32 = map(_np, (port16, jax16, jax32, port32))
    assert port16.shape == jax16.shape == jax32.shape, name
    gap = np.abs(jax16 - jax32).max()
    err = np.abs(port16 - jax16).max()
    assert np.isfinite(port16).all(), name
    assert err <= GAP_FACTOR * gap, (
        f"{name}: port bf16 is {err} from JAX bf16, JAX's own bf16-vs-fp32 "
        f"gap is {gap}")
    assert np.abs(port16 - port32).max() > 1e-7, f"{name}: bf16 did not run"


def _jax_variables(module, jax_init, seed):
    """The JAX variable tree (structure from `jax.eval_shape(jax_init)`)
    holding `module`'s seeded init, perturbed (`_perturb`)."""
    init_parameters(module, torch.Generator().manual_seed(seed))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      jax.eval_shape(jax_init))
    variables, report = torch_to_flax(module.state_dict(), template)
    assert report["skipped"] == []
    return _perturb(variables, seed)


@pytest.mark.parametrize("L,window,with_rel", [(100, 31, True),
                                               (40, 7, False)])
def test_banded_attention_bf16_matches_jax(L, window, with_rel):
    """The plain bf16 attention core (bf16 q, k, v; fp32 rel) against the
    JAX package's XLA banded attention on the same bf16 operands; fp32 on
    the fp32 operands they were rounded from gives the gap."""
    q, kpad, vpad, rel = _inputs(L=L, window=window, seed=5)
    rel_t = torch.from_numpy(rel) if with_rel else None
    rel_j = jnp.asarray(rel) if with_rel else None

    def jax_fwd(dtype):
        args = (jnp.asarray(a, dtype) for a in (q, kpad, vpad))
        return jax.jit(jattn.banded_attention, static_argnums=(4, 5))(
            *args, rel_j, window, 64)

    got = bak.banded_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, kpad, vpad)), rel_t, window)
    got32 = bak.banded_attention(*(torch.from_numpy(a)
                                   for a in (q, kpad, vpad)), rel_t, window)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, a, b, c, d in zip(("out", "probs"), got, jax_fwd(jnp.bfloat16),
                                jax_fwd(jnp.float32), got32):
        assert_within_jax_gap(name, a, b, c, d)


def test_multihead_attention_bf16_matches_jax():
    xt = torch.from_numpy(np.random.RandomState(3).randn(2, 40, 229)
                          .astype(np.float32))
    x = jnp.asarray(xt.numpy())
    ref16, ref32 = (jattn.MultiHeadAttention1D(out_features=916,
                                               kernel_size=31, groups=4,
                                               dtype=dtype)
                    for dtype in (BF16, None))
    mod16 = MultiHeadAttention1D(229, 916, 31, 4,
                                 compute_dtype=torch.bfloat16)
    mod32 = MultiHeadAttention1D(229, 916, 31, 4)
    variables = _jax_variables(
        mod32, lambda: ref32.init(jax.random.PRNGKey(0), x), 0)
    for mod in (mod16, mod32):
        mod.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        got, got32 = mod16(xt), mod32(xt)
    assert got[0].dtype == torch.bfloat16
    for name, a, b, c, d in zip(
            ("out", "attention"), got, jax.jit(ref16.apply)(variables, x),
            jax.jit(ref32.apply)(variables, x), got32):
        assert_within_jax_gap(name, a, b, c, d)


def test_encoder_decoder_bf16_match_jax():
    """At the size of test_torch_reconvat's fp32 encoder/decoder test."""
    x = np.random.RandomState(1).rand(2, 32, 40, 1).astype(np.float32)
    enc32, dec32 = JaxEncoder(layout="nhwc"), JaxDecoder(layout="nhwc")
    enc16 = JaxEncoder(layout="nhwc", dtype=BF16)
    dec16 = JaxDecoder(layout="nhwc", dtype=BF16)
    tenc, tdec = Encoder(), Decoder()
    with torch.no_grad():
        _, sizes, _ = tenc(torch.from_numpy(x).permute(0, 3, 1, 2))
    ve = _jax_variables(tenc, lambda: enc32.init(
        jax.random.PRNGKey(1), jnp.asarray(x), False), 1)
    z, _, c = jax.eval_shape(lambda v: enc32.apply(v, jnp.asarray(x), False),
                             ve)
    vd = _jax_variables(tdec, lambda: dec32.init(
        jax.random.PRNGKey(2), jnp.zeros(z.shape), sizes,
        [jnp.zeros(t.shape) for t in c], False), 2)

    def jax_run(enc, dec):
        @jax.jit
        def run(ve, vd, x):
            z, s, c = enc.apply(ve, x, False)
            return z, s, c, dec.apply(vd, z, sizes, c, False)
        z, s, c, y = run(ve, vd, jnp.asarray(x))
        assert [tuple(int(i) for i in v) for v in s] == sizes
        return z, c, y

    def port_run(compute_dtype):
        enc = Encoder(compute_dtype=compute_dtype).eval()
        dec = Decoder(compute_dtype=compute_dtype).eval()
        enc.load_state_dict(flax_to_torch(ve), strict=True)
        dec.load_state_dict(flax_to_torch(vd), strict=True)
        with torch.no_grad():
            z, s, c = enc(torch.from_numpy(x).permute(0, 3, 1, 2))
            y = dec(z, s, c)
        assert s == sizes
        return [t.permute(0, 2, 3, 1) for t in (z, *c, y)]

    got, got32 = port_run(torch.bfloat16), port_run(None)
    assert got[-1].dtype == torch.bfloat16
    z16, c16, y16 = jax_run(enc16, dec16)
    z32, c32, y32 = jax_run(enc32, dec32)
    names = ["z"] + [f"skip{i}" for i in range(len(c16))] + ["y"]
    for name, a, b, c_, d in zip(names, got, [z16, *c16, y16],
                                 [z32, *c32, y32], got32):
        assert_within_jax_gap(name, a, b, c_, d)


@pytest.fixture(scope="module")
def models():
    """JAX fp32 and bf16 models on one perturbed variable tree, and the
    port's fp32 and bf16 models holding the same weights, on the CPU."""
    jax32 = JaxReconVAT(conv_layout="nhwc")
    jax16 = JaxReconVAT(conv_layout="nhwc", compute_dtype=BF16)
    port32 = ReconVAT(device="cpu")
    variables = _jax_variables(port32, lambda: jax32.init(
        jax.random.PRNGKey(0), seq_frames=64), 0)
    port32.load_state_dict(flax_to_torch(variables), strict=True)
    port16 = ReconVAT(device="cpu", compute_dtype=BF16)
    port16.load_state_dict(port32.state_dict(), strict=True)
    return variables, jax32, jax16, port32, port16


FORWARD_OUTPUTS = ("reconstruction", "pianoroll", "pianoroll2")


@pytest.fixture(scope="module")
def full_forward(models):
    """The eval-mode full forward (every parameter is used) of all four
    models on one 64-frame spec, by output name."""
    variables, jax32, jax16, port32, port16 = models
    x = np.random.RandomState(2).rand(1, 64, 229, 1).astype(np.float32)
    outs = {}
    with torch.no_grad():
        for key, fwd in (("port16", lambda: port16(torch.from_numpy(x))),
                         ("port32", lambda: port32(torch.from_numpy(x))),
                         ("jax16", lambda: jax.jit(jax16.module.apply)(
                             variables, jnp.asarray(x))),
                         ("jax32", lambda: jax.jit(jax32.module.apply)(
                             variables, jnp.asarray(x)))):
            outs[key] = dict(zip(FORWARD_OUTPUTS, fwd()[:3]))
    return outs


@pytest.mark.parametrize("name", FORWARD_OUTPUTS)
def test_full_forward_bf16_matches_jax(full_forward, name):
    o = full_forward
    assert_within_jax_gap(name, o["port16"][name], o["jax16"][name],
                          o["jax32"][name], o["port32"][name])


@pytest.fixture(scope="module")
def transcribed(models):
    variables, jax32, jax16, port32, port16 = models
    audio = _audio(2, 64 * 512, seed=3)
    return dict(
        port16=port16.transcribe(torch.from_numpy(audio))["frame"],
        port32=port32.transcribe(torch.from_numpy(audio))["frame"],
        **{key: jax.jit(lambda v, a, m=m: m.transcribe(v, a)["frame"])(
            variables, jnp.asarray(audio))
           for key, m in (("jax16", jax16), ("jax32", jax32))})


def test_transcribe_bf16_matches_jax(transcribed):
    t = transcribed
    assert t["port16"].dtype == torch.float32      # the posteriogram is fp32
    assert tuple(t["port16"].shape) == (2, 64, 88)
    assert_within_jax_gap("posteriogram", t["port16"], t["jax16"],
                          t["jax32"], t["port32"])


def test_serving_submit_runs_bf16_model(models, transcribed):
    """`serve.submit` takes a bf16 model unchanged: its packed roll is that
    of the model's fp32 posteriogram."""
    port16 = models[-1]
    audio = _audio(2, 64 * 512, seed=3)
    audio_i16 = np.round(audio * 32768.0).astype(np.int16)
    packed = serve.submit(port16, audio_i16).packed()
    probs = port16.transcribe(torch.from_numpy(audio_i16 / 32768.0).float()
                              )["frame"]
    assert torch.equal(packed, pack_roll_device(probs))
    np.testing.assert_array_equal(unpack_roll(packed.numpy()),
                                  probs.numpy() > 0.5)


@pytest.mark.parametrize("name", ["float16", torch.bfloat16])
def test_compute_dtype_takes_one_name(name):
    """The model takes None or 'bfloat16'; the layers under it take the
    torch dtype that resolves to."""
    assert resolve_compute_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        ReconVAT(device="cpu", compute_dtype=name)
