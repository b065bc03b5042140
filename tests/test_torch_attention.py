"""Port's banded attention vs the JAX package, on the CPU.

Tolerance: atol 1e-5 (rtol 1e-4) for out and probs, the bound the JAX
package holds its Pallas forward to against XLA
(tests/test_pallas_attention.py). Both sides are fp32 with no TF32; only
the summation order of the Dh-term dot products and the window-term
softmax and output sums differ. The module test
(`test_multihead_attention_matches_jax`) holds both packages against the
port's module in float64 instead: a fixed pair holds one CPU's BLAS order
only at the flagship's 229 x 916 projections.
The kernel-against-plain tests are in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.nn import attention as jattn
from reconvat_tpu.ops.pallas_attention import pallas_banded_forward
from reconvat_tpu_torch.nn.attention import MultiHeadAttention1D
from reconvat_tpu_torch.ops import banded_attention_kernel as bak
from reconvat_tpu_torch.weights import flax_to_torch

ATOL, RTOL = 1e-5, 1e-4


def _inputs(B=2, L=100, H=4, Dh=57, window=31, seed=0):
    rng = np.random.RandomState(seed)
    hw = (window - 1) // 2
    q = rng.randn(B, L, H, Dh).astype(np.float32)
    k = rng.randn(B, L, H, Dh).astype(np.float32)
    v = rng.randn(B, L, H, Dh).astype(np.float32)
    kpad = np.pad(k, ((0, 0), (hw, hw), (0, 0), (0, 0)))
    vpad = np.pad(v, ((0, 0), (hw, hw), (0, 0), (0, 0)))
    rel = (rng.randn(H, Dh, window) * 0.1).astype(np.float32)
    return q, kpad, vpad, rel


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("L,window,with_rel", [(100, 31, True),
                                               (64, 7, True),
                                               (33, 31, True),
                                               (80, 15, False)])
def test_banded_attention_matches_jax(L, window, with_rel):
    q, kpad, vpad, rel = _inputs(L=L, window=window)
    rel = rel if with_rel else None
    ref_out, ref_probs = jattn.banded_attention(
        *(jnp.asarray(a) for a in (q, kpad, vpad)),
        None if rel is None else jnp.asarray(rel), window, block_size=64)
    out, probs = bak.banded_attention(
        *_t(q, kpad, vpad), None if rel is None else torch.from_numpy(rel),
        window)
    assert tuple(out.shape) == (2, L, 4, 57)
    assert tuple(probs.shape) == (2, L, 4, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs),
                               rtol=RTOL, atol=ATOL)


def test_banded_attention_matches_jax_pallas_interpret():
    q, kpad, vpad, rel = _inputs(L=100, window=31, seed=1)
    ref = pallas_banded_forward(*(jnp.asarray(a) for a in (q, kpad, vpad,
                                                            rel)), 31, 64)
    out, _ = bak.banded_attention(*_t(q, kpad, vpad, rel), 31)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_tile_models_match_jax_pallas_interpret(dtype):
    """The CPU models of the port's tensor-core forward kernels against
    the Pallas forward (interpret mode). fp32: the 3xTF32 tile model at
    the fp32 tolerance above. bf16: the bf16 tile model on the same
    inputs rounded to bf16, rel too (the Pallas kernel rounds rel to the
    operand dtype, the port keeps it fp32), both rounding p to bf16
    before the PV product and out to bf16 at the end; out within one bf16
    ulp (2**-7 |ref|) + 1e-3 max |ref|, and at most 1 % of its elements
    differing at all (fp32 sums in another order)."""
    q, kpad, vpad, rel = _inputs(L=70, window=31, seed=5)
    if dtype == "float32":
        ref = pallas_banded_forward(*(jnp.asarray(a) for a in (q, kpad, vpad,
                                                                rel)), 31, 64)
        out, _ = bak.banded_attention_fwd_tf32x3_plain(*_t(q, kpad, vpad,
                                                           rel), 31)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
        return
    q, kpad, vpad, rel = (torch.from_numpy(a).to(torch.bfloat16)
                          for a in (q, kpad, vpad, rel))
    ref = pallas_banded_forward(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
          for t in (q, kpad, vpad, rel)), 31, 64)
    out, _ = bak.banded_attention_fwd_mma_plain(q, kpad, vpad, rel.float(),
                                                31)
    got = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got - ref)
    assert (err <= 2 ** -7 * np.abs(ref) + 1e-3 * np.abs(ref).max()).all(), \
        err.max()
    assert (err > 0).mean() <= 1e-2


def test_wrapper_is_plain_on_cpu():
    q, kpad, vpad, rel = _t(*_inputs(L=40, window=31, seed=2))
    before = bak.banded_attention_fwd.launches
    a = bak.banded_attention_fwd(q, kpad, vpad, rel, 31)
    b = bak.banded_attention(q, kpad, vpad, rel, 31)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bak.banded_attention_fwd.launches == before


# the module's criterion (test_multihead_attention_matches_jax)
TRUTH_FACTOR, TRUTH_FLOOR, JAX_TRUTH_SHARE = 2.0, 1e-6, 1e-4


@pytest.mark.parametrize("in_features,out_features,groups,window",
                         [(24, 32, 4, 7), (229, 916, 4, 31)])
def test_multihead_attention_matches_jax(in_features, out_features, groups,
                                         window):
    """The port's fp32 module and the JAX package's, on the same weights,
    each held against a float64 evaluation: the port's module under
    `.double()` on the plain route. For `out` and `attn`:

    - the port's largest error is at most TRUTH_FACTOR (2) x the JAX
      package's + TRUTH_FLOOR (1e-6) x max |truth|: the two fp32 routes
      sum the 229-term projections and Dh-term scores in other orders, so
      neither rounds closer by more than a small factor, and a fixed
      atol/rtol pair holds one CPU's BLAS order only (2 of 73,280 output
      elements at 229 x 916 missed rtol 1e-4 on one machine, 1.3e-5
      absolute on values near 1e-2);
    - the JAX package's own error is at most JAX_TRUTH_SHARE (1e-4) x max
      |truth|: the float64 reference is the port's module, so this is what
      a fault shared by its fp32 and float64 runs (a window off by one,
      two heads swapped) fails, by a share of the output's size; fp32
      rounding through a 229-term projection, 229-term scores and a
      31-term window sum stays under (229 + 229 + 31) x 2^-24 ~ 3e-5 of
      the terms' magnitude.

    The (24, 32, 4, 7) case also keeps the atol 1e-5 / rtol 1e-4 bound
    against the JAX output."""
    x = np.random.RandomState(3).randn(2, 40, in_features).astype(np.float32)
    ref_mod = jattn.MultiHeadAttention1D(out_features=out_features,
                                         kernel_size=window, groups=groups)
    variables = ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = ref_mod.apply(variables, jnp.asarray(x))

    mod = MultiHeadAttention1D(in_features, out_features, window, groups)
    mod.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
        truth = mod.double()(torch.from_numpy(x).double())
    for name, a, b, t in zip(("out", "attn"), got, ref, truth):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        t = t.numpy()
        assert a.shape == b.shape == t.shape, name
        top = np.abs(t).max()
        port_err, jax_err = np.abs(a - t).max(), np.abs(b - t).max()
        assert jax_err <= JAX_TRUTH_SHARE * top, (name, jax_err, top)
        assert port_err <= TRUTH_FACTOR * jax_err + TRUTH_FLOOR * top, \
            (name, port_err, jax_err, top)
        if in_features == 24:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
