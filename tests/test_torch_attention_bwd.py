"""Port's banded-attention backward vs the JAX package, on the CPU.

Tolerance: each gradient divided by max(its largest magnitude, 1), then
atol 3e-6 (rtol 1e-4), the bound the JAX package holds its Pallas backward
to against the XLA VJP (tests/test_pallas_attention_bwd.py). Both sides are
fp32; dk and dv add up to `window` terms per row in another order, and
drel sums over every (batch, row) of a head.
bf16 operands (q, kpad, vpad, d_out bf16; rel fp32): each gradient within
2x JAX's own bf16-vs-fp32 gap on the same inputs (the rule of
tests/test_torch_bf16.py), against each JAX route: the XLA formulation's
VJP rounds each einsum's output to bf16 (the scores among them), and the
Pallas kernel also rounds rel to bf16, where the port keeps rel fp32 and
rounds only dS and p before their products.
The kernel-against-plain tests are in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.nn import attention as jattn
from reconvat_tpu.ops.pallas_attention_bwd import pallas_banded_backward
from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D
from reconvat_tpu_torch.ops import banded_attention_kernel as bak
from reconvat_tpu_torch.weights import flax_to_torch

from .torch_threads import torch_one_thread  # noqa: F401

ATOL, RTOL = 3e-6, 1e-4
NAMES = ("dq", "dk", "dv", "drel")
GAP_FACTOR = 2.0


def _inputs(B=2, L=100, H=4, Dh=57, window=31, seed=0):
    rng = np.random.RandomState(seed)
    hw = (window - 1) // 2
    pad = ((0, 0), (hw, hw), (0, 0), (0, 0))
    q = rng.randn(B, L, H, Dh).astype(np.float32)
    kpad = np.pad(rng.randn(B, L, H, Dh).astype(np.float32), pad)
    vpad = np.pad(rng.randn(B, L, H, Dh).astype(np.float32), pad)
    rel = (rng.randn(H, Dh, window) * 0.1).astype(np.float32)
    d_out = rng.randn(B, L, H, Dh).astype(np.float32)
    return q, kpad, vpad, rel, d_out


def _assert_scaled_close(got, expect, names=NAMES):
    for name, a, b in zip(names, got, expect):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# the parameter sets of tests/test_pallas_attention_bwd.py
@pytest.mark.parametrize("L,window,block", [(100, 31, 64), (64, 7, 64),
                                            (130, 31, 128)])
def test_backward_plain_matches_jax(L, window, block):
    """Against jax.vjp of the XLA formulation and against the Pallas
    backward kernel in interpret mode."""
    arrays = _inputs(L=L, window=window)
    q, kpad, vpad, rel, d_out = (jnp.asarray(a) for a in arrays)

    def ref_fn(q_, k_, v_, r_):
        out, _ = jattn.banded_attention(q_, k_, v_, r_, window, 64,
                                        return_probs=False)
        return out

    _, vjp = jax.vjp(ref_fn, q, kpad, vpad, rel)
    got = bak.banded_attention_bwd_plain(
        *(torch.from_numpy(a) for a in arrays), window)
    _assert_scaled_close(got, vjp(d_out))
    _assert_scaled_close(got, pallas_banded_backward(q, kpad, vpad, rel,
                                                     d_out, window, block))


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("L,window,block", [(100, 31, 64), (64, 7, 64)])
def test_backward_plain_bf16_matches_jax(L, window, block):
    """bf16 q, kpad, vpad and d_out, fp32 rel: the port's plain backward
    and the autograd op on the CPU (which runs it) against jax.vjp of the
    XLA formulation in bf16 and against the Pallas backward kernel in
    interpret mode on the same bf16 operands, each held to 2x its own
    route's bf16-vs-fp32 gap; dq, dk and dv come back bf16, drel fp32."""
    q, kpad, vpad, rel, d_out = _inputs(L=L, window=window, seed=6)

    def xla(dtype):
        def ref_fn(q_, k_, v_, r_):
            out, _ = jattn.banded_attention(q_, k_, v_, r_, window, 64,
                                            return_probs=False)
            return out
        args = [jnp.asarray(a, dtype) for a in (q, kpad, vpad)]
        _, vjp = jax.vjp(ref_fn, *args, jnp.asarray(rel))
        return vjp(jnp.asarray(d_out, dtype))

    def pallas(dtype):
        return pallas_banded_backward(
            *(jnp.asarray(a, dtype) for a in (q, kpad, vpad)),
            jnp.asarray(rel), jnp.asarray(d_out, dtype), window, block)

    qb, kb, vb, db = _bf16(q, kpad, vpad, d_out)
    rel_t = torch.from_numpy(rel)
    got = bak.banded_attention_bwd_plain(qb, kb, vb, rel_t, db, window)
    got32 = bak.banded_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, kpad, vpad, rel, d_out)), window)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]

    leaves = [t.clone().requires_grad_() for t in (qb, kb, vb, rel_t)]
    out, _ = bak.BandedAttention.apply(*leaves, window)
    op = torch.autograd.grad(out, leaves, db)
    for name, a, b in zip(NAMES, op, got):
        assert a.dtype == b.dtype and torch.equal(a, b), name

    for route in (xla, pallas):
        ref16, ref32 = route(jnp.bfloat16), route(jnp.float32)
        for name, a, b, c, d in zip(NAMES, got, ref16, ref32, got32):
            a, b, c, d = map(_np, (a, b, c, d))
            gap = np.abs(b - c).max()
            err = np.abs(a - b).max()
            assert err <= GAP_FACTOR * gap, (
                f"{route.__name__} {name}: port bf16 is {err} from JAX "
                f"bf16, JAX's own bf16-vs-fp32 gap is {gap}")
            assert np.abs(a - d).max() > 0, f"{name}: bf16 did not run"


@pytest.mark.parametrize("L,window,tile", [(100, 31, 32), (33, 7, 8),
                                           (64, 31, 16)])
def test_two_pass_plain_equals_backward(L, window, tile):
    """The kernel's two passes in plain PyTorch (per-tile partials, then
    overlap-add in tile order) give the backward's gradients, for tiles
    wider and narrower than the window."""
    t = [torch.from_numpy(a) for a in _inputs(L=L, window=window, seed=1)]
    dq, dk_part, dv_part, drel_part = bak.banded_attention_bwd_partials_plain(
        *t, window, tile)
    n = -(-L // tile)
    assert tuple(dk_part.shape) == (2, 4, n, tile + window - 1, 57)
    assert tuple(drel_part.shape) == (2, 4, n, 57, window)
    got = (dq, *bak.banded_attention_bwd_reduce_plain(
        dk_part, dv_part, drel_part, L, window, tile))
    expect = bak.banded_attention_bwd_plain(*t, window)
    for name, a, b in zip(NAMES, got, expect):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-5,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("L,window,tile", [(100, 31, 32), (33, 7, 8)])
def test_two_pass_plain_bf16_equals_backward(L, window, tile):
    """The two passes in plain PyTorch on bf16 operands: dq bf16 and equal
    to the backward's, fp32 partials, dk and dv overlap-added in fp32 and
    then rounded to bf16 once, as the kernel's second pass does (one bf16
    ulp of |ref| where the fp32 sums in another order round the other
    way), drel fp32 (rtol 1e-4)."""
    q, kpad, vpad, rel, d_out = _inputs(L=L, window=window, seed=7)
    t = [*_bf16(q, kpad, vpad), torch.from_numpy(rel), *_bf16(d_out)]
    dq, dk_part, dv_part, drel_part = bak.banded_attention_bwd_partials_plain(
        *t, window, tile)
    assert dq.dtype == torch.bfloat16
    assert {x.dtype for x in (dk_part, dv_part, drel_part)} == {torch.float32}
    dk, dv, drel = bak.banded_attention_bwd_reduce_plain(
        dk_part, dv_part, drel_part, L, window, tile)
    expect = bak.banded_attention_bwd_plain(*t, window)
    assert torch.equal(dq, expect[0])
    for name, a, b in zip(("dk", "dv"), (dk, dv), expect[1:3]):
        a = a.to(torch.bfloat16)       # the kernel's one rounding
        err = (a.float() - b.float()).abs()
        assert (err <= 2 ** -7 * b.float().abs()).all(), (name, err.max())
    torch.testing.assert_close(drel, expect[3], rtol=RTOL, atol=1e-5)


def test_autograd_op_matches_autograd_of_plain_forward():
    """The autograd Function's gradients (its backward is the plain
    backward on the CPU) against autograd through the plain forward; the
    probabilities come out equal and carry no gradient."""
    q, kpad, vpad, rel, d_out = (torch.from_numpy(a)
                                 for a in _inputs(L=50, window=15, seed=2))

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, kpad, vpad, rel)]
        out, probs = fn(*leaves, 15)
        return probs, torch.autograd.grad(out, leaves, d_out)

    before = bak.banded_attention_bwd.launches
    probs, got = grads(bak.BandedAttention.apply)
    probs_ref, expect = grads(bak.banded_attention)
    assert bak.banded_attention_bwd.launches == before   # plain on the CPU
    assert not probs.requires_grad
    torch.testing.assert_close(probs, probs_ref, rtol=0, atol=0)
    _assert_scaled_close(got, expect)


def test_backward_wrappers_are_plain_on_cpu():
    t = [torch.from_numpy(a) for a in _inputs(L=40, window=7, seed=3)]
    before = (bak.banded_attention_bwd.launches,
              bak.banded_attention_bwd_partials.launches)
    for a, b in zip(bak.banded_attention_bwd(*t, 7),
                    bak.banded_attention_bwd_plain(*t, 7)):
        assert torch.equal(a, b)
    for a, b in zip(bak.banded_attention_bwd_partials(*t, 7),
                    bak.banded_attention_bwd_partials_plain(*t, 7)):
        assert torch.equal(a, b)
    assert (bak.banded_attention_bwd.launches,
            bak.banded_attention_bwd_partials.launches) == before


@pytest.mark.parametrize("in_features,out_features,groups,window",
                         [(24, 32, 4, 7), (229, 916, 4, 31)])
def test_multihead_attention_grads_match_jax(in_features, out_features,
                                             groups, window):
    """Input and parameter gradients of MultiHeadAttention1D through the
    autograd op, against jax.grad of the JAX module, for the loss
    sum(out * g)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 40, in_features).astype(np.float32)
    g = rng.randn(2, 40, out_features).astype(np.float32)
    ref_mod = jattn.MultiHeadAttention1D(out_features=out_features,
                                         kernel_size=window, groups=groups)
    variables = ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(params, x_):
        out, _ = ref_mod.apply({"params": params}, x_)
        return jnp.sum(out * g)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x))
    expect = flax_to_torch({"params": gp})

    mod = MultiHeadAttention1D(in_features, out_features, window, groups)
    mod.load_state_dict(flax_to_torch(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = mod(xt)
    (out * torch.from_numpy(g)).sum().backward()
    names = ["x", *expect]
    _assert_scaled_close(
        [xt.grad, *(dict(mod.named_parameters())[n].grad for n in expect)],
        [gx, *expect.values()], names)
