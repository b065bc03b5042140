"""The program under test, built from a configuration file, with weights
drawn on its device from the seed."""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference.model import logit


def build(config: dict, device):
    """The configuration's model of the program (`reconvat_tpu_torch`),
    on `device`, in eval mode, in the configuration's `compute_dtype`
    (None: fp32)."""
    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.models.unet_onset import UNetOnset

    cls = {"ReconVAT": ReconVAT, "UNetOnset": UNetOnset}[config["model"]]
    return cls(device=device, compute_dtype=config.get("compute_dtype"),
               **config["constructor"])


def _scale(name: str, p: torch.Tensor) -> float:
    """Half-width of the uniform draw of a leaf: the program's init rule,
    matched in variance where it draws a normal (attention projections
    N(0, 2 / fan_out), rel N(0, 1))."""
    if name.endswith(".rel"):
        return math.sqrt(3.0)
    if name.endswith((".W_q.weight", ".W_k.weight", ".W_v.weight")):
        return math.sqrt(3.0 * 2.0 / p.shape[0])
    return 1.0 / math.sqrt(p[0].numel())


@torch.no_grad()
def draw_weights(model, seed: int) -> None:
    """Every weight of two or more dimensions (convolutions, projections,
    rel) from one uniform draw on the model's device; biases stay zero
    and BatchNorm at identity, as the program's own init leaves them."""
    leaves = [(n, p) for n, p in model.named_parameters() if p.dim() >= 2]
    total = sum(p.numel() for _, p in leaves)
    device = leaves[0][1].device
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    offset = 0
    for name, p in leaves:
        n = p.numel()
        p.copy_(flat[offset:offset + n].view_as(p) * _scale(name, p))
        offset += n


def split_state(model) -> tuple[dict, dict]:
    """(parameters, running statistics) of the model as detached clones,
    under the reference state_dict's names."""
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if "running_" in k}
    return params, stats


@torch.no_grad()
def calibrate_batchnorm(model, audio) -> None:
    """Set the transcriber's BatchNorm running statistics to the moments
    of one train-mode forward of `audio` (momentum 1 for that forward),
    as a trained model's statistics follow its data: random weights with
    the initial statistics put out nearly the same roll for every input.
    The model is left in eval mode."""
    from reconvat_tpu_torch.models.base import fp32_math

    layers = [m for m in model.transcriber.modules()
              if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in layers]
    for m in layers:
        m.momentum = 1.0
    model.train()
    try:
        with fp32_math():
            model.transcriber(model.make_spec(audio))
    finally:
        for m, momentum in zip(layers, momenta):
            m.momentum = momentum
        model.eval()


def density_shift(probs: torch.Tensor, density: float) -> float:
    """The bias shift that puts `density` of the probe's bins above 0.5:
    minus the logit of its (1 - density) quantile (`chip_smoke.py` phase
    4's calibration)."""
    q = float(np.clip(np.quantile(probs.float().cpu().numpy(),
                                  1.0 - density), 1e-4, 1 - 1e-4))
    return -logit(q)
