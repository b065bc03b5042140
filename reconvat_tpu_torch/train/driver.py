"""The training driver of the training CLIs (the port's counterpart of
`reconvat_tpu/train/driver.py`, reference `train_UNet_Onset_VAT.py:
82-170`): prepare the datasets -> loaders with device prefetch -> train
state -> epoch loop (`train_VAT_model`, or the supervised baselines'
full-epoch `train_model`; `tensorboard_log`, periodic checkpoints) ->
full-song evaluation of the test split, on one device or data-parallel
over the ranks of `mesh_dp` (`run_training`).

One `torch.Generator` on the model's device, seeded from `seed`, draws
every VAT direction and dropout mask in place of the JAX package's key
splits, so a run's random stream differs from the JAX package's; the
loaders' orders and the datasets' crops are the same for a seed.
"""
from __future__ import annotations

import os
import pickle

import torch

from ..data.loader import (DataLoader, MappedLoader, cycle, device_batch,
                           prefetch_to_device)
from ..evaluate import (evaluate_wo_velocity, make_bucketed_runner,
                        print_metrics)
from ..models.base import resolve_device
from ..models.common import frames_in
from ..parallel import distributed, launch
from ..parallel import mesh as pmesh
from ..utils import summary
from . import checkpoint as ckpt
from . import profiler
from .loop import (NullLogger, TensorboardLogger, tensorboard_log,
                   train_model, train_VAT_model)
from .prepare import prepare_VAT_dataset
from .state import create_train_state, make_eval_step, make_train_step


def mesh_sp(cfg) -> int:
    """The config's sp ranks per row group (`mesh_sp` 0 or 1: one)."""
    sp = int(cfg.get("mesh_sp") or 0)
    if sp < 0:
        raise ValueError(f"mesh_sp={sp}: 0 or 1 for none, N for N ranks")
    return max(sp, 1)


def mesh_world(cfg) -> int:
    """The number of ranks the config asks for, dp x sp: `mesh_dp` 0 or 1
    one row group, N > 1 N, -1 every visible GPU over `mesh_sp`;
    `multihost=True` the launcher's `WORLD_SIZE` (required). Raises
    ValueError for a setting that cannot run, before any work."""
    dp = int(cfg.get("mesh_dp") or 0)
    sp = mesh_sp(cfg)
    launched = distributed.launcher_env()
    if cfg.get("multihost", False):
        if not launched:
            raise ValueError(
                "multihost=True needs the launcher's environment "
                f"({', '.join(distributed.LAUNCH_ENV)}, as torchrun sets "
                f"it) on every host")
        world = int(os.environ["WORLD_SIZE"])
        if world % sp or dp not in (0, 1, -1, world // sp):
            raise ValueError(f"mesh_dp={dp} x mesh_sp={sp} under multihost: "
                             f"each process holds one device, {world} "
                             f"ranks in all")
        return world
    if dp < -1:
        raise ValueError(f"mesh_dp={dp}: 0 or 1 for one device, N for N "
                         f"ranks, -1 for every visible GPU")
    if dp == -1:
        if torch.device(cfg.get("device", "cuda")).type != "cuda":
            raise ValueError("mesh_dp=-1 takes every visible GPU; on the "
                             "CPU give the number of ranks")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
        if cards % sp:
            raise ValueError(f"mesh_dp=-1 with mesh_sp={sp}: {cards} "
                             f"visible GPUs do not divide over {sp}")
        dp = cards // sp
    world = max(dp, 1) * sp
    if launched and world > 1 and int(os.environ["WORLD_SIZE"]) != world:
        raise ValueError(f"mesh_dp={dp} x mesh_sp={sp} under a launcher of "
                         f"{os.environ['WORLD_SIZE']} ranks")
    return world


def check_mesh(cfg, frame_multiple: int = pmesh.SP_FRAME_MULTIPLE) -> int:
    """`mesh_world` and the JAX driver's divisibility checks
    (`reconvat_tpu/train/driver.py:111-114`): each sharded loader's batch
    (the labeled `train_batch_size`, and with VAT the unlabeled
    `batch_size`) must divide over the dp ranks, and a crop's frames over
    the sp ranks into multiples of `frame_multiple`, the model's
    (`SP_FRAME_MULTIPLE`: 16, Thickstun's 1; `parallel.mesh.
    check_sp_frames`). Returns the number of ranks."""
    world = mesh_world(cfg)
    sp = mesh_sp(cfg)
    dp = world // sp
    sizes = {"train_batch_size": cfg.get("train_batch_size",
                                         cfg.get("batch_size"))}
    if cfg.get("VAT", False):
        sizes["batch_size"] = cfg.get("batch_size")
    for key, size in sizes.items():
        if size is not None and int(size) % dp:
            raise ValueError(
                f"global batch ({key}={size}) must divide over {dp} "
                f"data-parallel ranks (mesh_dp): adjust the batch size or "
                f"mesh_dp")
    if sp > 1:
        pmesh.check_sp_frames(frames_in(int(cfg["sequence_length"])), sp,
                              frame_multiple)
    return world


def build_mesh(cfg, device=None):
    """This rank's view of the config's dp x sp mesh over the started
    process group (`start_ranks`) on `device`, or None for one device."""
    world = mesh_world(cfg)
    if world == 1:
        return None
    if distributed.world_size() != world:
        raise RuntimeError(
            f"{world} ranks asked for, the process group has "
            f"{distributed.world_size()}: run through a training CLI (which "
            f"starts them) or start the group first "
            f"(parallel.distributed.initialize)")
    return pmesh.make_mesh(sp=mesh_sp(cfg), device=device)


def start_ranks(cfg, main_fn, overrides):
    """The training CLIs' `Experiment` launch: the ranks of `mesh_world`,
    started from this process without a launcher (`parallel.launch`); the
    other ranks take this run's directory. Yields whether this process
    writes (rank 0)."""
    settings = dict(overrides)
    if "logdir" in cfg:
        settings["logdir"] = cfg["logdir"]
    return launch.ranks(mesh_world(cfg), cfg.get("device", "cuda"), main_fn,
                        settings)


def check_spec(spec: str) -> None:
    """Raise ValueError for a frontend the training and evaluation CLIs
    cannot run: an unknown name, or 'CFP', whose spec has T - 2 frames for
    labels of T (it drops the first and last STFT frame), so no
    `run_on_batch` of the JAX package or of the port takes it. 'Mel' and
    'CQT' pass."""
    if spec == "CFP":
        raise ValueError(
            "spec='CFP' gives T - 2 spectrogram frames for labels of T "
            "frames (it drops the first and last STFT frame): CFP serves "
            "(the transcription CLI) but does not train or evaluate, as in "
            "the JAX package")
    if spec not in ("Mel", "CQT"):
        raise ValueError(f"unknown spectrogram type: {spec}")


def check_settings(cfg, model):
    """Raise for the settings the training CLIs of the port do not run: a
    mesh that cannot run (`check_mesh`, at the frame multiple of `model`,
    the class the CLI trains), sequence parallelism (`mesh_sp` > 1) for a
    `model` that runs data-parallel only (`SEQUENCE_PARALLEL` False: the
    O&F family, the attention models, Prestack), the folded U-Net
    layout, the plain attention, the CFP
    frontend (`check_spec`), and CUDA without a card. `attn_impl` and
    `conv_layout` are read where a CLI has them (the baselines' have
    neither). The CLIs' `Experiment` runs it before the observers write
    the run directory."""
    if not model.SEQUENCE_PARALLEL:
        pmesh.refuse_sp(mesh_sp(cfg), model.__name__)
    check_mesh(cfg, model.SP_FRAME_MULTIPLE)
    check_spec(cfg["spec"])
    attn_impl = cfg.get("attn_impl", "auto")
    if attn_impl == "xla":
        raise ValueError(
            "attn_impl='xla' selects the plain attention, which must not "
            "be the training path; use 'auto' or 'pallas' (the kernels)")
    if attn_impl not in ("auto", "pallas"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    conv_layout = cfg.get("conv_layout", "auto")
    if conv_layout == "folded":
        raise NotImplementedError(
            "conv_layout='folded' is the JAX package's TPU layout; the port "
            "runs the NHWC-equivalent layout only ('auto' or 'nhwc')")
    if conv_layout not in ("auto", "nhwc"):
        raise ValueError(f"unknown conv_layout {conv_layout!r}")
    resolve_device(cfg["device"])


def run_training(model, cfg, datasets=None):
    """cfg: the resolved config dict (the CLI's names). datasets: an
    optional prebuilt (labeled, unlabeled, validation, full_validation)
    tuple. Trains `model` in place on its device and writes the run's
    artifacts under cfg["logdir"]: `model-N` checkpoints, the TensorBoard
    event file, `MIDI_results/` and the `result_dict` pickle. Returns
    (model, train state, metrics). `donate` is taken and has no effect
    (the updates are in place).

    With `mesh_dp` x `mesh_sp` N > 1 (or `multihost`) the whole run is
    sharded over the N ranks of the process group (`start_ranks`), each on
    its own device or sharing one: every rank runs the same seeded loaders
    and keeps its rows of each global batch and, under sp, its frames of
    the labels (`parallel.mesh.shard_batch`; the audio stays whole per
    row), the parameters and optimizer state start as rank 0's
    (`parallel.mesh.replicate`), each step is a sharded step
    (`train.state.make_train_step`), and rank 0 alone writes the
    artifacts. The logging passes and the full-song evaluation run whole,
    unsharded, on every rank (eval mode runs no collective; the logging
    passes' batches and the evaluation's songs are not split), as the JAX
    package's hosts run the same computations."""
    ctx = build_mesh(cfg, model.device)
    if ctx is None:
        return _run_training(model, cfg, datasets, None)
    with pmesh.activate(ctx):
        return _run_training(model, cfg, datasets, ctx)


def _run_training(model, cfg, datasets, ctx):
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

    is_main = ctx is None or ctx.rank == 0
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

    if ctx is not None:
        pmesh.replicate(model, ctx)
        pmesh.replicate(state, ctx)
    if is_main:
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
    # ahead of the step that takes them; under a mesh each rank's rows
    def rows(batches):
        return (batches if ctx is None else
                (pmesh.batch_rows(b, ctx) for b in batches))

    l_iter = prefetch_to_device(rows(cycle(supervised_loader)), device)
    ul_iter = (prefetch_to_device(rows(cycle(ul_loader)), device)
               if ul_loader is not None else None)
    epoch_loader = (supervised_loader if ctx is None else
                    MappedLoader(supervised_loader,
                                 lambda b: pmesh.shard_batch(b, ctx)))

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
                                 epoch_loader, generator, timer=timer,
                                 pipeline=pipeline, verbose=is_main)
        else:
            losses = train_VAT_model(
                model, state, train_steps, iteration, ep, l_iter, ul_iter,
                generator, vat=vat, vat_start=vat_start, timer=timer,
                pipeline=pipeline, verbose=is_main)
        if cfg.get("profile_epoch") == ep:
            with profiler.trace(os.path.join(logdir, "profile")):
                train_VAT_model(model, state, train_steps, 1, ep, l_iter,
                                ul_iter, generator, vat=vat,
                                vat_start=vat_start, verbose=False)
        if logger is None:
            logger = TensorboardLogger(logdir) if is_main else NullLogger()
        # every rank runs the whole of it, writing nothing but on rank 0:
        # the generator and the loaders' shuffles stay in step
        tensorboard_log(logger, model, batch_visualize, validation_dataset,
                        supervised_loader, eval_step, ep, logging_freq,
                        generator, vat, vat_start,
                        cfg.get("reconstruction", False), verbose=is_main)
        if ep % saving_freq == 0:
            ckpt.save_checkpoint(logdir, ep, model, state)
        logger.log_losses(losses, ep)

    print("Training finished, now evaluating on the test split (full songs)")
    metrics = evaluate_wo_velocity(
        full_validation, make_bucketed_runner(model),
        reconstruction=False,
        batch_songs=cfg.get("eval_batch_songs", 1),
        host_workers=cfg.get("eval_host_workers", 4),
        save_path=(os.path.join(logdir, "MIDI_results") if is_main
                   else None))
    if is_main:
        print_metrics(metrics)
        with open(os.path.join(logdir, "result_dict"), "wb") as f:
            pickle.dump(dict(metrics), f)
    if logger is not None:
        logger.close()
    ckpt.wait_for_checkpoints()
    return model, state, metrics
