"""The port's bf16 mixed-precision train step against the JAX package's, on
the CPU, with the same weights (`flax_to_torch`) and the same VAT
directions.

One `run_on_batch` with reconstruction and VAT on a labeled and an
unlabeled batch (B = 2 + 2, 32 frames) in four routes: the JAX package and
the port, each in fp32 and in `compute_dtype='bfloat16'`. The JAX steps are
jitted once each (`jax.grad` of the total loss); the directions are pinned
as `tests/test_torch_train.py` pins them (the port draws them from a
torch.Generator, the test hands the same numbers to the JAX `vat_loss`).
The weights are the port's seeded init carried into the JAX tree and
perturbed (`tests/test_torch_bf16.py:_jax_variables`).

Tolerance, for every loss and every parameter gradient (max abs over the
leaf): |port_bf16 - jax_bf16| <= 2 * gap_jax + |port_fp32 - jax_fp32|,
all read on the same weights and directions. The first term is the rule
of `tests/test_torch_bf16.py` (the two packages round to bf16 at other
places, so the port's bf16 may lie as far from JAX's as JAX's bf16 lies
from its own fp32, and twice that covers two roundings that fall apart);
the second is what separates the packages already in fp32 (summation
orders, which the VAT direction amplifies). Each output must also differ
from the port's own fp32 result: bf16 ran.

gap_jax is the largest |jax_bf16 - jax_fp32| over the batch and
N_PROBES copies of it whose audio is perturbed by PROBE = 1e-3
(relative), each pair on the same input. In train mode at random init the
step amplifies a bf16 rounding by orders of magnitude in both packages
(train-mode BatchNorm of the reconstructor runs on a near-constant
pianoroll, and the softmax of the random-init attention is nearly one-hot),
so each output's bf16 error is a draw from a distribution, in JAX as in
the port: on this batch JAX's bf16 reconstruction loss lies 8.9e-4 from its
fp32 one and the port's 6.5e-3, on the probes JAX's reads up to 6.5e-3
and the port's down to 8e-5. One draw of a scalar says little about that
distribution's scale, so the gap is the largest of N_PROBES + 1 draws.
Measured: the closest output is loss/train_frame2, at 0.99 of its limit;
the gradient leaves read at most 0.86 of theirs, half of them under 0.38.

xi is 0.1 here, not the default 1e-6. At the default the perturbation is
about 7e-8 per spec element, below a bf16 ulp of any spec value but those
near 0, and the first convolution casts the perturbed spec to bf16: at
this size (2 x 32 x 229 spec elements) the cast rounds it away, the
perturbed prediction equals the clean one bit for bit, the power
iteration's gradient is exactly zero, and JAX's own bf16 direction is zero
in every (b, t) vector (`test_default_xi_bf16_direction_vanishes_as_in_jax`).
At xi 1e-3, 1e-2, 0.1 and 1 the cosine between JAX's bf16 and fp32
directions on this model is about 0.14, 0.30, 0.66 and 0.63: from 0.1 on
the bf16 direction carries the fp32 one, so the comparison is of two
directions and not of two rounding noises.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reconvat_tpu.models.reconvat as jreconvat_mod
from reconvat_tpu import vat as jvat
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu.train.state import total_loss_from_dict as jax_total
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.nn.unet import frozen_batch_stats
from reconvat_tpu_torch.train.state import (create_train_state,
                                            make_train_step,
                                            total_loss_from_dict)
from reconvat_tpu_torch.vat import vat_loss
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_bf16 import _jax_variables

BF16 = "bfloat16"
B, FRAMES, XI, SEED, EPS = 2, 32, 0.1, 11, 2.0
GAP_FACTOR = 2.0
PROBE, N_PROBES = 1e-3, 5


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    n = FRAMES * 512
    return ({"audio": (rng.randn(B, n) * 0.1).astype(np.float32),
             "frame": (rng.rand(B, FRAMES, 88) < 0.05).astype(np.float32)},
            {"audio": (rng.randn(B, n) * 0.1).astype(np.float32)})


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _directions():
    """The port's two VAT draws from `SEED`: unlabeled chain, then
    labeled."""
    g = torch.Generator().manual_seed(SEED)
    return [torch.randn((B, FRAMES, 229, 1), generator=g).numpy()
            for _ in range(2)]


def _probes():
    """The batches, then N_PROBES copies whose audio is perturbed by
    PROBE (relative)."""
    batches = [_batches()]
    rng = np.random.RandomState(7)
    for _ in range(N_PROBES):
        batches.append(tuple(
            {**b, "audio": (b["audio"] * (1 + PROBE * rng.randn(
                *b["audio"].shape))).astype(np.float32)}
            for b in batches[0]))
    return batches


def _jax_steps(model, variables, batches):
    """Losses and parameter gradients of one JAX VAT step (jitted once),
    the directions pinned, for each (batch_l, batch_ul) of `batches`."""
    dirs = [jnp.asarray(d) for d in _directions()]

    def pinned(apply_fn, x, key, cfg, init_d=None, y_ref=None, split=None):
        return jvat.vat_loss(apply_fn, x, key, cfg, init_d=dirs.pop(0),
                             y_ref=y_ref, split=split)

    def loss_fn(params, batch_l, batch_ul):
        _, losses, _, _ = model.run_on_batch(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch_l, batch_ul, jax.random.PRNGKey(1), vat=True, train=True)
        return jax_total(losses, 1.0), losses

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreconvat_mod, "vat_loss", pinned)
        step = jax.jit(jax.grad(loss_fn, has_aux=True))
        for batch_l, batch_ul in batches:
            grads, losses = step(variables["params"], batch_l, batch_ul)
            out.append(({k: float(v) for k, v in losses.items()},
                        flax_to_torch({"params": grads})))
    return out


def _port_step(model, batch_l, batch_ul):
    model.zero_grad(set_to_none=True)
    _, losses, _ = model.run_on_batch(
        _torch_batch(batch_l), _torch_batch(batch_ul),
        torch.Generator().manual_seed(SEED), vat=True, train=True)
    total_loss_from_dict(losses, 1.0).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {k: v.item() for k, v in losses.items()}, grads


@pytest.fixture(scope="module")
def steps():
    """Losses and gradients of the four routes, by route name."""
    jax32 = JaxReconVAT(conv_layout="nhwc", xi=XI)
    jax16 = JaxReconVAT(conv_layout="nhwc", xi=XI, compute_dtype=BF16)
    port32 = ReconVAT(device="cpu", xi=XI)
    variables = _jax_variables(port32, lambda: jax32.init(
        jax.random.PRNGKey(0), seq_frames=FRAMES), 0)
    port32.load_state_dict(flax_to_torch(variables), strict=True)
    port16 = ReconVAT(device="cpu", xi=XI, compute_dtype=BF16)
    port16.load_state_dict(port32.state_dict(), strict=True)
    batches = _probes()
    return {"jax32": _jax_steps(jax32, variables, batches),
            "jax16": _jax_steps(jax16, variables, batches),
            "port32": _port_step(port32, *batches[0]),
            "port16": _port_step(port16, *batches[0])}


def _assert_held(steps, kind: int, name: str):
    """The module docstring's rule for one output: kind 0 a loss, 1 a
    gradient leaf."""
    def get(route, i=0):
        x = steps[route] if route.startswith("port") else steps[route][i]
        return torch.as_tensor(x[kind][name], dtype=torch.float64)

    def gap(a, b):
        return (a - b).abs().max().item()

    port16, port32 = get("port16"), get("port32")
    jax_gap = max(gap(get("jax16", i), get("jax32", i))
                  for i in range(N_PROBES + 1))
    pkg_gap = gap(port32, get("jax32"))
    err, limit = gap(port16, get("jax16")), GAP_FACTOR * jax_gap + pkg_gap
    assert torch.isfinite(port16).all(), name
    assert err <= limit, (
        f"{name}: port bf16 is {err} from JAX bf16; limit {limit} (JAX's "
        f"bf16-vs-fp32 gap {jax_gap}, the packages' fp32 gap {pkg_gap})")
    assert gap(port16, port32) > 0, f"{name}: bf16 did not run"


def test_bf16_step_losses_match_jax(steps):
    assert set(steps["port16"][0]) == set(steps["jax16"][0][0])
    for name in steps["jax16"][0][0]:
        _assert_held(steps, 0, name)


def test_bf16_step_gradients_match_jax(steps):
    assert set(steps["port16"][1]) == set(steps["jax16"][0][1])
    for name in steps["jax16"][0][1]:
        assert steps["port16"][1][name].dtype == torch.float32, name
        _assert_held(steps, 1, name)


def _shares(r_adv):
    """Shares of (b, t) vectors of r_adv (B, T, F, 1) whose norm is eps
    and whose norm is 0."""
    norms = np.linalg.norm(np.asarray(r_adv, np.float64)[..., 0], axis=2)
    eps = np.isclose(norms, EPS, rtol=1e-3)
    zero = norms == 0
    assert (eps | zero).all(), norms
    return eps.mean(), zero.mean()


def test_default_xi_bf16_direction_vanishes_as_in_jax():
    """At the default xi (1e-6), VAT on the transcriber in both packages
    and both dtypes, from the same weights, spec and direction: every
    perturbation vector has norm eps or 0. In fp32 all have norm eps. In
    bf16 the perturbation survives the first convolution's cast only where
    it moves a spec element across a bf16 rounding boundary (a share of
    ~1e-5 of them), so at this size the clean and perturbed predictions
    agree bit for bit and the direction is zero; the port's share of zero
    vectors lies within 0.1 of JAX's (the two packages round at other
    places)."""
    jax32 = JaxReconVAT(conv_layout="nhwc")
    port32 = ReconVAT(device="cpu")
    variables = _jax_variables(port32, lambda: jax32.init(
        jax.random.PRNGKey(0), seq_frames=FRAMES), 3)
    port32.load_state_dict(flax_to_torch(variables), strict=True)
    port16 = ReconVAT(device="cpu", compute_dtype=BF16)
    port16.load_state_dict(port32.state_dict(), strict=True)
    spec = port32.make_spec(_torch_batch(_batches(4)[1])["audio"]).detach()
    d = _directions()[0]
    shares = {}
    for dt, port in ((BF16, port16), (None, port32)):
        jmodel = JaxReconVAT(conv_layout="nhwc", compute_dtype=dt)
        _, r_adv, _ = jax.jit(lambda v, x, d_, m=jmodel: jvat.vat_loss(
            m._transcriber_fn(v, True), x, None, m.vat_cfg, init_d=d_))(
                variables, jnp.asarray(spec.numpy()), jnp.asarray(d))
        shares["jax", dt] = _shares(r_adv)
        port.train()
        with frozen_batch_stats(port):
            _, r_adv, _ = vat_loss(port.transcribe_frames, spec, None,
                                   port.vat_cfg, init_d=torch.from_numpy(d))
        shares["port", dt] = _shares(r_adv.detach())
    assert shares["jax", None] == shares["port", None] == (1.0, 0.0), shares
    assert abs(shares["port", BF16][1] - shares["jax", BF16][1]) <= 0.1, \
        shares


def test_default_xi_bf16_step_is_finite_and_updates_in_place():
    """At the default xi the bf16 step's losses are finite, each r_adv
    vector has norm eps or 0, and make_train_step updates the fp32
    parameters, the running statistics and the schedule in place."""
    model = ReconVAT(device="cpu", seed=1, compute_dtype=BF16)
    batch_l, batch_ul = (_torch_batch(b) for b in _batches(seed=2))
    preds, losses, _ = model.run_on_batch(
        batch_l, batch_ul, torch.Generator().manual_seed(0), vat=True)
    assert preds["r_adv"].dtype == torch.float32
    _shares(preds["r_adv"][..., None].detach())
    assert all(torch.isfinite(v) for v in losses.values())
    assert all(v.dtype == torch.float32 for v in losses.values())

    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model)
    step = make_train_step(model, alpha=1.0, vat=True, use_unlabeled=True)
    out = step(state, batch_l, batch_ul, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in out.values())
    assert state.step == 1
    assert all(p.dtype == torch.float32 for p in model.parameters())
    after = model.state_dict()
    for key in ("transcriber.linear1.weight",
                "transcriber.lstm1.W_q.weight", "transcriber.lstm1.rel",
                "transcriber.Unet1_encoder.block1.conv1.weight",
                "transcriber.Unet1_encoder.block1.bn1.running_var"):
        assert not torch.equal(before[key], after[key]), key
