"""The port's batched VAT chain and application objective against the
JAX package, on the CPU.

The losses of `run_on_batch` with `vat_chain='batched'` and of
`run_on_batch_application`, at B = 1 labeled + 1 unlabeled x 32 frames,
xi 0.1, the directions pinned to the port's draws, the JAX side of both in
one jit, both packages in float64 (as tests/test_torch_train.py compares a
VAT step): rtol 1e-6. The JAX attention takes its softmax in float32 even
in x64 mode (~4e-7 relative on its output, which the power iteration
scales by 1 / xi on the direction). The application's running statistics
after the step: rtol 1e-7, atol 1e-8 against JAX's (means near zero of
O(1) activations), and equal to the bit to those of its labeled forward
alone (the unlabeled full forward leaves them unchanged).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reconvat_tpu.models.reconvat as jreconvat_mod
from reconvat_tpu import vat as jvat
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import weights
from reconvat_tpu_torch.models.reconvat import ReconVAT, init_parameters

from .test_torch_reconvat import _perturb
from .test_torch_vat_chain import (FRAMES, SEED, XI, _batches, _close,
                                   _torch)
from .torch_threads import torch_one_thread  # noqa: F401

JAX_LOSS_RTOL = 1e-6


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's losses of the batched chain's run_on_batch and of
    run_on_batch_application (B = 1 + 1 x 32 frames, float64, directions
    pinned to the port's draws), both in one jit; and the port's weights
    they ran on."""
    port = ReconVAT(device="cpu", xi=XI)
    init_parameters(port, torch.Generator().manual_seed(0))
    jmodel = JaxReconVAT(conv_layout="nhwc", xi=XI, vat_chain="batched")
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=FRAMES)))
    variables, report = torch_to_flax(port.state_dict(), template)
    assert report["skipped"] == []
    variables = _perturb(variables, 0)
    g = torch.Generator().manual_seed(SEED)
    d_batched = torch.randn((2, FRAMES, 229, 1), dtype=torch.float64,
                            generator=g)
    g = torch.Generator().manual_seed(SEED)
    d_app = [torch.randn((1, FRAMES, 229, 1), dtype=torch.float64,
                         generator=g) for _ in range(2)]
    dirs = [jnp.asarray(d.numpy()) for d in [d_batched, *d_app]]
    batch_l, batch_ul = _batches(1)

    def pinned(apply_fn, x, key, cfg, init_d=None, y_ref=None, split=None):
        return jvat.vat_loss(apply_fn, x, key, cfg, init_d=dirs.pop(0),
                             y_ref=y_ref, split=split)

    def both(variables, batch_l, batch_ul):
        _, batched, _, _ = jmodel.run_on_batch(
            variables, batch_l, batch_ul, jax.random.PRNGKey(1), vat=True,
            train=True)
        _, app, _, stats = jmodel.run_on_batch_application(
            variables, batch_l, batch_ul, jax.random.PRNGKey(1), vat=True,
            train=True)
        return batched, app, stats

    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jreconvat_mod, "vat_loss", pinned)
            v64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), variables)
            out = jax.jit(both)(v64, batch_l, batch_ul)
            out = jax.tree_util.tree_map(np.asarray, out)
    finally:
        jax.config.update("jax_enable_x64", False)
    return variables, out


def _f64_state(variables):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "_tensor",
                   lambda w: torch.tensor(np.asarray(w, np.float64)))
        return weights.flax_to_torch(variables)


@pytest.mark.parametrize("objective", ["batched_chain", "application"])
def test_losses_match_jax(jax_reference, objective):
    """Every loss of the port's batched-chain `run_on_batch` and of its
    `run_on_batch_application` against the JAX package's, same weights
    and directions; the application's running statistics are those of
    its labeled forward alone."""
    variables, (jbatched, japp, jstats) = jax_reference
    model = ReconVAT(device="cpu", xi=XI, vat_chain="batched").double()
    model.load_state_dict(_f64_state(variables), strict=True)
    batch_l, batch_ul = (_torch(b) for b in _batches(1))
    gen = torch.Generator().manual_seed(SEED)
    if objective == "batched_chain":
        _, losses, _ = model.run_on_batch(batch_l, batch_ul, gen, vat=True,
                                          train=True)
        expect = jbatched
    else:
        _, losses, _ = model.run_on_batch_application(
            batch_l, batch_ul, gen, vat=True, train=True)
        expect = japp
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        # the unlabeled full forward left the running statistics alone:
        # the labeled forward alone, from the same weights, lands on them
        fresh = ReconVAT(device="cpu", xi=XI).double()
        fresh.load_state_dict(_f64_state(variables), strict=True)
        fresh.run_on_batch_application(batch_l, None, gen, vat=False,
                                       train=True)
        for k, v in fresh.state_dict().items():
            if "running" in k:
                assert torch.equal(v, stats[k]), k
        jsd = _f64_state({"params": variables["params"],
                          "batch_stats": jstats})
        for k, v in stats.items():
            _close(v, jsd[k], 1e-7, 1e-8, k)
    assert set(losses) == set(expect)
    for k, v in expect.items():
        _close(losses[k], v, JAX_LOSS_RTOL, 1e-12, k)
