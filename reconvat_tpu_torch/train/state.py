"""Train state, optimizer and the train/eval steps (PyTorch counterpart of
`reconvat_tpu/train/state.py`).

Optimization follows the reference recipe (`train_UNet_Onset_VAT.py:
113-124`, `model/helper_functions.py:570-615`) as the JAX package runs it:
Adam, StepLR(step_size=1000, gamma=0.98) stepped per batch (a staircase
exponential decay), LDS losses scaled by alpha/2, and the gradient's global
norm clipped to 3.0 *before* the update (the reference clips after
`optimizer.step()`, which leaves the step it just took unclipped; the JAX
package clips before, and so does this port). TF32 is off throughout. A
fp32 model runs the whole step in fp32; a bf16 model
(`compute_dtype='bfloat16'`) runs its convolutions, attention projections
and attention core in bf16, while its parameters, and so the gradients
that reach them through the casts, the clipping and Adam, stay fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.reconvat import fp32_math
from ..parallel import mesh as pmesh


@dataclasses.dataclass
class TrainState:
    """What the step updates besides the model's own parameters and
    BatchNorm statistics: the optimizer, its schedule and the step count.
    clip_gradient_norm 0 turns clipping off."""
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    clip_gradient_norm: float
    step: int = 0


def make_optimizer(params, learning_rate: float = 1e-3,
                   decay_steps: int = 1000, decay_rate: float = 0.98):
    """Adam and its per-step staircase decay (StepLR)."""
    optimizer = torch.optim.Adam(params, lr=learning_rate)
    scheduler = torch.optim.lr_scheduler.StepLR(optimizer, decay_steps,
                                                decay_rate)
    return optimizer, scheduler


def create_train_state(model, learning_rate: float = 1e-3,
                       decay_steps: int = 1000, decay_rate: float = 0.98,
                       clip_gradient_norm: float = 3.0) -> TrainState:
    optimizer, scheduler = make_optimizer(model.parameters(), learning_rate,
                                          decay_steps, decay_rate)
    return TrainState(optimizer, scheduler, clip_gradient_norm)


def total_loss_from_dict(losses: dict, alpha: float) -> torch.Tensor:
    """Reference loss summation (`model/helper_functions.py:588-595`)."""
    total = 0.0
    for key, val in losses.items():
        if key.startswith("loss/train_LDS"):
            total = total + alpha * val / 2.0
        else:
            total = total + val
    return total


def apply_gradients(model, state: TrainState) -> None:
    """Clip the gradients' global norm, then take one Adam step and one
    schedule step."""
    if state.clip_gradient_norm:
        torch.nn.utils.clip_grad_norm_(model.parameters(),
                                       state.clip_gradient_norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def make_train_step(model, alpha: float, vat: bool, use_unlabeled: bool,
                    application: bool = False) -> Callable:
    """Builds step(state, batch_l, batch_ul, generator) -> losses.
    `application=True` takes `run_on_batch_application` (the unlabeled
    consistency fine-tuning objective, reference
    `model/helper_functions.py:618-663`).

    Unlike the JAX package's pure step, this one updates in place, the
    PyTorch idiom: the model's parameters and BatchNorm running statistics
    and the state's optimizer, schedule and step count. The returned
    losses are detached device scalars, with "loss/total" (every loss,
    LDS terms at alpha 1) beside the reference's keys.

    Under an active data-parallel mesh (`parallel.mesh.activate`) the
    batches are this rank's rows of the global batch: the step runs as a
    `sharded_step` (global BatchNorm moments, the global batch's random
    draws), all-reduces the gradients to their mean after the backward and
    before the clipping (one flat buffer per dtype, in the parameters'
    order, a `gradient_all_reduce` profiler span), and returns the losses'
    means over the ranks. `run_on_batch` runs the transcriber several
    times a step and VAT differentiates with respect to its input inside
    it, so the gradients are reduced here, once, instead of by
    `DistributedDataParallel`'s reducer."""

    run = (model.run_on_batch_application if application
           else model.run_on_batch)

    def step(state: TrainState, batch_l, batch_ul, generator):
        ctx = pmesh.active()
        state.optimizer.zero_grad(set_to_none=True)
        with fp32_math(), pmesh.sharded_step(ctx):
            _, losses, _ = run(
                batch_l, batch_ul if use_unlabeled else None, generator,
                vat=vat, train=True)
            total_loss_from_dict(losses, alpha).backward()
            if ctx is not None:
                with torch.profiler.record_function("gradient_all_reduce"):
                    pmesh.all_reduce_mean(
                        [p.grad for p in model.parameters()
                         if p.grad is not None], ctx)
            apply_gradients(model, state)
        losses = {k: v.detach() for k, v in losses.items()}
        if ctx is not None:
            losses = {k: v.clone() for k, v in losses.items()}
            pmesh.all_reduce_mean(list(losses.values()), ctx)
        losses["loss/total"] = total_loss_from_dict(losses, 1.0)
        return losses

    return step


def make_eval_step(model, vat: bool = False) -> Callable:
    """Builds step(batch, generator) -> losses on the running BatchNorm
    statistics; no gradient is kept."""

    def step(batch, generator=None):
        with fp32_math(), torch.set_grad_enabled(vat):
            _, losses, _ = model.run_on_batch(batch, None, generator,
                                              vat=vat, train=False)
        return {k: v.detach() for k, v in losses.items()}

    return step
