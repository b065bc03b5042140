"""`chip_smoke.py` phase 9b's rule (bf16 train losses, the card against
the CPU) on the CPU, where a "card" route is built to miss one bf16 cast.

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
from reconvat_tpu_torch.models.reconvat import ReconVAT
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
    rng = np.random.RandomState(0)
    batch = {"audio": torch.tensor(rng.randn(2, 32 * 512) * 0.1,
                                   dtype=torch.float32),
             "frame": torch.tensor(rng.rand(2, 32, 88) < 0.03,
                                   dtype=torch.float32)}
    out = {name: [] for name in routes}
    for weights in chip_smoke.weight_draws(routes["cpu32"].state_dict(),
                                           chip_smoke.BF16_9B_DRAWS, 19):
        for name, m in routes.items():
            m.load_state_dict(weights)
            out[name].append(chip_smoke.short_step(m, batch)[0])
    return out


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
