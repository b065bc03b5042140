"""The training driver of the VAT training CLI (the port's counterpart of
`reconvat_tpu/train/driver.py`, reference `train_UNet_Onset_VAT.py:
82-170`): prepare the datasets -> loaders with device prefetch -> train
state -> epoch loop (`train_VAT_model`, `tensorboard_log`, periodic
checkpoints) -> full-song evaluation of the test split, on one device.

One `torch.Generator` on the model's device, seeded from `seed`, draws
every VAT direction in place of the JAX package's key splits, so a run's
random stream differs from the JAX package's; the loaders' orders and the
datasets' crops are the same for a seed.
"""
from __future__ import annotations

import os
import pickle

import torch

from ..data.loader import (DataLoader, cycle, device_batch,
                           prefetch_to_device)
from ..evaluate import (evaluate_wo_velocity, make_bucketed_runner,
                        print_metrics)
from ..utils import summary
from . import checkpoint as ckpt
from . import profiler
from .loop import (TensorboardLogger, tensorboard_log, train_model,
                   train_VAT_model)
from .prepare import prepare_VAT_dataset
from .state import create_train_state, make_eval_step, make_train_step


def build_mesh(cfg):
    """None: the port trains on one device. Raises for the JAX package's
    mesh settings (mesh_dp, mesh_sp other than 0 or 1, multihost)."""
    dp = int(cfg.get("mesh_dp") or 0)
    sp = int(cfg.get("mesh_sp") or 0)
    if cfg.get("multihost", False) or dp > 1 or sp > 1 or dp == -1:
        raise NotImplementedError(
            f"mesh_dp={dp}, mesh_sp={sp}, multihost="
            f"{cfg.get('multihost', False)}: training over a device mesh "
            f"is not ported (ROADMAP §1 item 11, multi-GPU)")
    return None


def run_training(model, cfg, datasets=None):
    """cfg: the resolved config dict (the CLI's names). datasets: an
    optional prebuilt (labeled, unlabeled, validation, full_validation)
    tuple. Trains `model` in place on its device and writes the run's
    artifacts under cfg["logdir"]: `model-N` checkpoints, the TensorBoard
    event file, `MIDI_results/` and the `result_dict` pickle. Returns
    (model, train state, metrics). `donate` is taken and has no effect
    (the updates are in place)."""
    build_mesh(cfg)
    if datasets is None:
        datasets = prepare_VAT_dataset(
            sequence_length=cfg["sequence_length"],
            validation_length=cfg["sequence_length"],
            refresh=cfg.get("refresh", False),
            small=cfg.get("small", False),
            supersmall=cfg.get("supersmall", False),
            dataset=cfg["train_on"])
    supervised_set, unsupervised_set, validation_dataset, full_validation = \
        datasets

    device = model.device
    vat = cfg.get("VAT", False)
    alpha = cfg.get("alpha", 1)
    seed = cfg.get("seed", 42)
    logdir = cfg["logdir"]
    train_batch_size = cfg.get("train_batch_size", cfg["batch_size"])

    ul_loader = None
    if vat and len(unsupervised_set):
        ul_loader = DataLoader(unsupervised_set, cfg["batch_size"],
                               shuffle=True, drop_last=True, seed=seed + 1)
    supervised_loader = DataLoader(supervised_set, train_batch_size,
                                   shuffle=True, drop_last=True, seed=seed)
    # the reference's validation batch of 4 (`helper_functions.py:117`),
    # capped by the batch size and the split
    val_batch_size = (min(4, cfg.get("batch_size", 4),
                          len(validation_dataset)) or 1)
    valloader = DataLoader(validation_dataset, val_batch_size,
                           shuffle=False, drop_last=True, seed=seed)
    batch_visualize = {k: torch.from_numpy(v).to(device) for k, v in
                       device_batch(next(iter(valloader))).items()}

    generator = torch.Generator(device=device).manual_seed(seed)
    state = create_train_state(
        model, learning_rate=cfg["learning_rate"],
        decay_steps=cfg.get("learning_rate_decay_steps", 1000),
        decay_rate=cfg.get("learning_rate_decay_rate", 0.98),
        clip_gradient_norm=cfg.get("clip_gradient_norm", 3))

    resume = cfg.get("resume_iteration")
    if resume == "latest":
        path = ckpt.latest_checkpoint(cfg.get("trained_dir", logdir))
        if path is not None:
            ckpt.restore_checkpoint(path, model, state)
            print(f"auto-resumed from {path}")
    elif resume is not None:
        path = os.path.join(cfg.get("trained_dir", "trained_MAPS"),
                            f"model-{resume}")
        ckpt.restore_checkpoint(path, model, state)
        print(f"resumed from {path}")

    summary(type(model).__name__, model)

    application = cfg.get("application", False)
    train_steps = {
        False: make_train_step(model, alpha, vat=False, use_unlabeled=False,
                               application=application),
        True: make_train_step(model, alpha, vat=True,
                              use_unlabeled=ul_loader is not None,
                              application=application),
    }
    eval_step = make_eval_step(model)

    # batches assembled in the loaders' threads and copied to the device
    # ahead of the step that takes them
    l_iter = prefetch_to_device(cycle(supervised_loader), device)
    ul_iter = (prefetch_to_device(cycle(ul_loader), device)
               if ul_loader is not None else None)

    epoches = cfg.get("epoches", 20000)
    iteration = cfg.get("iteration", 10)
    logging_freq = cfg.get("logging_freq", 100)
    saving_freq = cfg.get("saving_freq", 200)
    vat_start = cfg.get("VAT_start", 0)
    # steps in flight before their losses are read back (loop._StepDrain)
    pipeline = cfg.get("pipeline", 1)
    timer = profiler.StepTimer(audio_seconds_per_step=(
        train_batch_size * cfg["sequence_length"] / 16000))
    # supervised baselines sweep the whole loader each epoch (reference
    # `train_baseline_Thickstun.py:122`); VAT configs take `iteration`
    # steps
    full_epoch = cfg.get("train_loop", "iteration") == "full_epoch"

    logger = None
    for ep in range(1, epoches + 1):
        if full_epoch:
            losses = train_model(model, state, train_steps[False], ep,
                                 supervised_loader, generator, timer=timer,
                                 pipeline=pipeline)
        else:
            losses = train_VAT_model(
                model, state, train_steps, iteration, ep, l_iter, ul_iter,
                generator, vat=vat, vat_start=vat_start, timer=timer,
                pipeline=pipeline)
        if cfg.get("profile_epoch") == ep:
            with profiler.trace(os.path.join(logdir, "profile")):
                train_VAT_model(model, state, train_steps, 1, ep, l_iter,
                                ul_iter, generator, vat=vat,
                                vat_start=vat_start, verbose=False)
        if logger is None:
            logger = TensorboardLogger(logdir)
        tensorboard_log(logger, model, batch_visualize, validation_dataset,
                        supervised_loader, eval_step, ep, logging_freq,
                        generator, vat, vat_start,
                        cfg.get("reconstruction", False))
        if ep % saving_freq == 0:
            ckpt.save_checkpoint(logdir, ep, model, state)
        logger.log_losses(losses, ep)

    print("Training finished, now evaluating on the test split (full songs)")
    metrics = evaluate_wo_velocity(
        full_validation, make_bucketed_runner(model),
        reconstruction=False,
        batch_songs=cfg.get("eval_batch_songs", 1),
        host_workers=cfg.get("eval_host_workers", 4),
        save_path=os.path.join(logdir, "MIDI_results"))
    print_metrics(metrics)
    with open(os.path.join(logdir, "result_dict"), "wb") as f:
        pickle.dump(dict(metrics), f)
    if logger is not None:
        logger.close()
    ckpt.wait_for_checkpoints()
    return model, state, metrics
