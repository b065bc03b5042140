"""`chip_smoke.py` phase 9b's rule (bf16 train losses, the card against
the CPU) on the CPU, where a "card" route is built to miss one bf16 cast;
and the gradient rule of `compare_routes` (`grad_rule` with its second
reading, the plain route's spread under further probes) on a flagship, a
Segmentation and an O&F self-attention step (phases 8, 14 and 15a) where a
"kernel" route carries a defect; and phase 20's place in `main` and its
rule for the library frontends (`frontend_held`) against defective routes.

Phase 9b runs phase 9's short clip at the weights and at `BF16_9B_DRAWS`
perturbed copies of them (`chip_smoke.weight_draws`) through the card and
the CPU, each in bf16 and fp32, and holds medians over those draws of the
rms gaps of the step's predictions (`chip_smoke.median_rule`). Here the CPU's own bf16 route, and a bf16
model whose convolutions were left in fp32, stand in for the card's bf16
route; the CPU's fp32 route stands in for the card's. The model is the
port's seeded init at 2 x 32 frames, as phase 9's short clip.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from reconvat_tpu_torch.models import get_model
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
from reconvat_tpu_torch.nn.unet import Conv2d, ConvTranspose2d

from .torch_threads import torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def preds():
    """Predictions by route, one dict per weight draw."""
    routes = {"cpu32": ReconVAT(seed=0, device="cpu"),
              "cpu16": ReconVAT(seed=0, device="cpu",
                                compute_dtype="bfloat16"),
              "no_conv_cast": ReconVAT(seed=0, device="cpu",
                                       compute_dtype="bfloat16")}
    for mod in routes["no_conv_cast"].modules():
        if isinstance(mod, (Conv2d, ConvTranspose2d)):
            mod.compute_dtype = None
    batch = _short_batch()
    out = {name: [] for name in routes}
    for weights in _states():
        for name, m in routes.items():
            m.load_state_dict(weights)
            out[name].append(chip_smoke.short_step(m, batch)[0])
    return out


def _short_batch():
    rng = np.random.RandomState(0)
    return {"audio": torch.tensor(rng.randn(2, 32 * 512) * 0.1,
                                  dtype=torch.float32),
            "frame": torch.tensor(rng.rand(2, 32, 88) < 0.03,
                                  dtype=torch.float32)}


def _states():
    """The seeded init and BF16_9B_DRAWS perturbed copies of it."""
    return chip_smoke.weight_draws(
        ReconVAT(seed=0, device="cpu").state_dict(),
        chip_smoke.BF16_9B_DRAWS, 19)


def test_median_rule_passes_the_cpu_bf16_route(preds):
    misses, read = chip_smoke.median_rule(preds["cpu16"], preds["cpu16"],
                                          preds["cpu32"], preds["cpu32"])
    assert misses == [], read
    assert all(not torch.equal(a[k], b[k]) for a, b in zip(
        preds["cpu16"], preds["cpu32"]) for k in a)          # bf16 ran


def test_median_rule_fails_a_route_missing_the_conv_cast(preds):
    """The route whose convolutions run in fp32 stays within the upper
    bound (it is no further from the CPU's bf16 than the CPU's fp32 is),
    and breaks the lower one on the reconstruction and the frame
    posteriogram, which it moves from fp32 by 0.09 and 0.05 of the CPU's
    gap (frame2, after a second transcriber pass over the bf16 rounded
    reconstruction, by 0.27)."""
    misses, read = chip_smoke.median_rule(
        preds["no_conv_cast"], preds["cpu16"], preds["cpu32"],
        preds["cpu32"])
    assert misses == ["reconstruction", "frame"], read
    for k in misses:
        upper, move = read[k]
        assert upper <= 1.0 and move < 1 / chip_smoke.BF16_MOVE_FLOOR, read


def test_median_rule_second_reading_keeps_the_lower_bound(preds):
    """Phase 9b's second reading (`chip_smoke.bf16_spread`: the CPU bf16
    route's own rms move under 1e-6 audio probes, median over the weight
    draws; PROBE_FACTOR x it added to the upper limit): the spread is
    nonzero for every prediction, the CPU's bf16 route holds it with each
    share no larger than the first reading's, and the route that misses
    the convolutions' cast still breaks the lower bound it breaks
    without the spread."""
    cpu16 = ReconVAT(seed=0, device="cpu", compute_dtype="bfloat16")
    spread = chip_smoke.bf16_spread(cpu16, _states(), _short_batch())
    assert all(v > 0 for v in spread.values()), spread
    misses, read = chip_smoke.median_rule(preds["cpu16"], preds["cpu16"],
                                          preds["cpu32"], preds["cpu32"],
                                          spread)
    assert misses == [] and all(r[2] <= r[0] for r in read.values()), read
    misses, read = chip_smoke.median_rule(
        preds["no_conv_cast"], preds["cpu16"], preds["cpu32"],
        preds["cpu32"], spread)
    assert misses == ["reconstruction", "frame"], read


def _readings(model, frames: int, onset=False):
    """The readings of `compare_routes`'s step without VAT at the CPU test
    size (2 clips of `frames` frames, seeded): the plain route's
    gradients, its move under one probe and its spread under
    R_NORM_PROBES further probes, and `run`."""
    import copy

    rng = np.random.RandomState(0)
    batch = {"audio": torch.tensor(rng.randn(2, frames * 512) * 0.1,
                                   dtype=torch.float32),
             "frame": torch.tensor(rng.rand(2, frames, 88) < 0.03,
                                   dtype=torch.float32)}
    if onset:
        batch["onset"] = torch.tensor(rng.rand(2, frames, 88) < 0.01,
                                      dtype=torch.float32)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def run(m, bl, bul, vat):
        m.load_state_dict(start)
        return chip_smoke.step_grads(m, bl, bul, seed=5, vat=vat)

    plain = copy.deepcopy(model)
    gp = run(plain, batch, None, False)[1]
    gq = run(plain, chip_smoke.probed(batch, 9), None, False)[1]
    spread = chip_smoke.plain_spread(run, plain, batch, gp)
    return model, batch, run, gp, gq, spread


@pytest.fixture(scope="module")
def segmentation_grads():
    """Phase 14's readings (Segmentation, fp32, seeded init, 2 clips of 37
    frames)."""
    return _readings(SemanticSegmentation(device="cpu", seed=0), 37)


def _misses(gk, gp, gq, spread):
    _, read = chip_smoke.grad_rule(gk, gp, gq, spread)
    return [n for n, (diff, _, _, limit) in read.items() if diff > limit]


def test_segmentation_grad_rule_fails_a_defective_mel(segmentation_grads):
    """A mel route whose output is off by 1e-3 relative, element by element
    (n standard normal), fails the second reading on many leaves. A
    uniform (1 + 1e-3) scale is no such defect: the imagewise min-max
    normalization of the log-spec takes it out (its gradients stay within
    0.73 of the limits at this size)."""
    import copy

    model, batch, run, gp, gq, spread = segmentation_grads
    noisy = copy.deepcopy(model)
    noise = 1e-3 * torch.randn((2, 37, 229),
                               generator=torch.Generator().manual_seed(1))
    noisy.frontend.register_forward_hook(lambda m, i, o: o * (1 + noise))
    gk = run(noisy, batch, None, False)[1]
    assert len(_misses(gk, gp, gq, spread)) > 20
    same = run(copy.deepcopy(model), batch, None, False)[1]
    assert _misses(same, gp, gq, spread) == []


def test_segmentation_grad_rule_fails_a_lost_gradient(segmentation_grads):
    """The output layer's gradient zeroed fails the second reading (its
    gradient is ~90x its limit; an early layer's gradient can lie inside
    its second limit at this size, and `compare_routes` fails a zeroed
    leaf on its own)."""
    _, _, _, gp, gq, spread = segmentation_grads
    for leaf in ("conv_last.weight", "conv_last.bias"):
        gk = dict(gp, **{leaf: torch.zeros_like(gp[leaf])})
        assert _misses(gk, gp, gq, spread) == [leaf]


@pytest.fixture(scope="module")
def flagship_grads():
    """Phase 8's readings (the flagship with reconstruction, fp32, seeded
    init, 2 clips of 32 frames). Every phase holds a leaf above its first
    limit by the second reading (`compare_routes`; its rule over weight
    states: `python3 chip_smoke.py --NAME-step-rule`)."""
    return _readings(ReconVAT(device="cpu", seed=0), 32)


def test_flagship_grad_rule_fails_a_defective_mel(flagship_grads):
    """A mel route off by 1e-3 relative, element by element, fails phase
    8's rule with the second reading on many leaves; the same route
    passes it."""
    import copy

    model, batch, run, gp, gq, spread = flagship_grads
    noisy = copy.deepcopy(model)
    noise = 1e-3 * torch.randn((2, 32, 229),
                               generator=torch.Generator().manual_seed(1))
    noisy.frontend.register_forward_hook(lambda m, i, o: o * (1 + noise))
    gk = run(noisy, batch, None, False)[1]
    assert len(_misses(gk, gp, gq, spread)) > 20
    same = run(copy.deepcopy(model), batch, None, False)[1]
    assert _misses(same, gp, gq, spread) == []


def test_flagship_grad_rule_fails_a_lost_gradient(flagship_grads):
    """The output layers' gradients zeroed (the transcriber's roll head
    and the reconstructor's spec head) fail the second reading."""
    _, _, _, gp, gq, spread = flagship_grads
    for leaf in ("transcriber.linear1.weight", "transcriber.linear1.bias",
                 "reconstructor.linear2.weight"):
        gk = dict(gp, **{leaf: torch.zeros_like(gp[leaf])})
        assert _misses(gk, gp, gq, spread) == [leaf]


@pytest.fixture(scope="module")
def attention_grads():
    """Phase 15a's readings of `OnsetsAndFramesSelfAttention` (fp32,
    seeded init, 2 clips of 32 frames): its conv trunks max-pool over
    frequency, where a rounding switches a gradient's route."""
    return _readings(get_model("OnsetsAndFramesSelfAttention", seed=0,
                               device="cpu"), 32, onset=True)


def test_attention_grad_rule_fails_a_defective_mel(attention_grads):
    """A mel route off by 1e-3 relative, element by element, fails phase
    15a's rule with the second reading on many leaves; the same route
    passes it."""
    import copy

    model, batch, run, gp, gq, spread = attention_grads
    noisy = copy.deepcopy(model)
    noise = 1e-3 * torch.randn((2, 32, 229),
                               generator=torch.Generator().manual_seed(1))
    noisy.frontend.register_forward_hook(lambda m, i, o: o * (1 + noise))
    gk = run(noisy, batch, None, False)[1]
    assert len(_misses(gk, gp, gq, spread)) > 10
    same = run(copy.deepcopy(model), batch, None, False)[1]
    assert _misses(same, gp, gq, spread) == []


def test_attention_grad_rule_fails_a_lost_gradient(attention_grads):
    """The output heads' gradients zeroed (onset, frame and combined) fail
    the second reading."""
    _, _, _, gp, gq, spread = attention_grads
    for leaf in ("onset_linear.weight", "frame_linear.weight",
                 "combined_linear.weight", "combined_linear.bias"):
        gk = dict(gp, **{leaf: torch.zeros_like(gp[leaf])})
        assert _misses(gk, gp, gq, spread) == [leaf]


def test_phase_20_runs_in_main_and_counts_mel_power():
    """Phase 20 is in `main`'s phase list, after 19d, and reads MFCC's
    launches of the mel kernel with every count reset just before."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    assert main.index('("19d", phase_sharded_family_clis') < \
        main.index('("20", phase_extra_frontends, (rows,))')
    phase = inspect.getsource(chip_smoke.phase_extra_frontends)
    assert '"mel_power": 1' in phase and 'again["mel_power"] != 3' in phase
    assert 'mel_row["launches_mfcc"]' in phase
    assert "use_kernel = False" in phase


def test_phase_20b_rule_fails_an_ignored_mel_setting():
    """Phase 20b's `MelSpectrogram` settings on the CPU: each one's route
    is the one XF_MEL_SETTINGS expects, its fp32 route is held by
    `frontend_held` against its float64 run, and the default module's
    output in its place (the setting ignored) is not held."""
    import inspect

    from reconvat_tpu_torch.ops.spectrogram import MelSpectrogram

    audio = torch.tensor(np.random.RandomState(20).randn(2, 16384) * 0.1,
                         dtype=torch.float32)
    default = MelSpectrogram()(audio)
    for kw, kernel, key in chip_smoke.XF_MEL_SETTINGS:
        module = MelSpectrogram(**kw)
        assert module.use_kernel is kernel and (key is not None) is kernel
        truth = module.double()(audio.double())
        cpu32 = module.float()(audio)
        assert chip_smoke.frontend_held(cpu32, cpu32, truth)[2], kw
        assert not chip_smoke.frontend_held(default, cpu32, truth)[2], kw
    phase = inspect.getsource(chip_smoke.phase_extra_frontends)
    assert "phase_mel_settings(mel_row, audio, counted)" in phase


def test_phase_20_rule_fails_a_defective_frontend():
    """`frontend_held` on phase 20's cases at a short clip on the CPU: the
    CPU's own fp32 route is held; a CQT1992 whose basis misses one bin,
    an MFCC whose DFT basis is one sample off, and an output shifted by
    one frame are not."""
    from reconvat_tpu_torch.ops import extra_frontends as xf

    audio = torch.tensor(np.random.RandomState(20).randn(2, 16384) * 0.1,
                         dtype=torch.float32)
    for name, module, inp, call in chip_smoke.extra_frontend_cases(audio):
        truth = call(module.double(), inp.double())
        cpu32 = call(module.float(), inp)
        outs = cpu32 if isinstance(cpu32, tuple) else (cpu32,)
        truths = truth if isinstance(truth, tuple) else (truth,)
        for o, t in zip(outs, truths):
            assert chip_smoke.frontend_held(o, o, t)[2], name
            if o.dim() == 3 and o.shape[1] > 1:
                shifted = torch.roll(o, 1, dims=1)
                assert not chip_smoke.frontend_held(shifted, o, t)[2], name
    cqt = xf.CQT1992(n_bins=60)
    truth = cqt.double()(audio.double())
    good = cqt.float()(audio)
    with torch.no_grad():
        cqt.kernel_spec_real[:, 30] = 0
        cqt.kernel_spec_imag[:, 30] = 0
    assert not chip_smoke.frontend_held(cqt(audio), good, truth)[2]
    mfcc = xf.MFCC()
    truth = mfcc.double()(audio.double())
    good = mfcc.float()(audio)
    with torch.no_grad():
        mfcc.melspec.stft.wcos.copy_(torch.roll(mfcc.melspec.stft.wcos, 1, 0))
    assert not chip_smoke.frontend_held(mfcc(audio), good, truth)[2]
