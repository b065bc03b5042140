"""Train the Onsets-and-Frames CNN + BiLSTM baseline, optionally with VAT
(the port's counterpart of `train_baseline_onset_frame_VAT.py`, with its
keys and defaults):

    python -m reconvat_tpu_torch.train_baseline_onset_frame_VAT with \
        train_on=MAPS VAT=True model_name=frame

`model_name` picks `onset_frame` (`OnsetsAndFrames`), `frame`
(`FrameStackVAT`) or `onset` (`OnsetStackVAT`); any other value raises (the
reference's 'attention' branch names a class it does not define). Runs on
CUDA unless `device=cpu`; without a card, for another `model_name`, a
`mesh_sp` > 1 or the CFP frontend it raises before the run directory is
written (`train.driver.check_settings`); `with mesh_dp=N` trains
data-parallel on N ranks. Writes its run
directory under `root` as `train_UNet_VAT` does.
"""
from datetime import datetime

from .config import Experiment, FileStorageObserver, print_config
from .models.onsets_frames import (FrameStackVAT, OnsetsAndFrames,
                                   OnsetStackVAT)
from .train.driver import check_settings, start_ranks

MODELS = {"onset_frame": OnsetsAndFrames, "frame": FrameStackVAT,
          "onset": OnsetStackVAT}


def check(cfg):
    if cfg["model_name"] not in MODELS:
        raise ValueError(f"unsupported model_name {cfg['model_name']!r} "
                         f"(the reference's 'attention' branch references "
                         f"an undefined class); one of {tuple(MODELS)}")
    check_settings(cfg, MODELS[cfg["model_name"]])


ex = Experiment("train_original", check=check, launch=start_ranks)

mode = "imagewise"
logging_freq = 100
saving_freq = 200


@ex.config
def config():
    root = "runs"
    onset_stack = True
    device = "cuda"
    log = True
    w_size = 31
    model_complexity = 48
    spec = "Mel"
    resume_iteration = None
    train_on = "String"
    iteration = 10
    alpha = 1
    VAT = False
    XI = 1e-6
    eps = 1e-1
    VAT_mode = "all"
    model_name = "onset_frame"
    VAT_start = 0
    small = True
    supersmall = False
    n_heads = 4
    reconstruction = False

    batch_size = 8
    train_batch_size = 8
    sequence_length = 327680

    epoches = 20000
    learning_rate = 5e-4
    learning_rate_decay_steps = 10000
    learning_rate_decay_rate = 0.98
    leave_one_out = None
    clip_gradient_norm = 3
    validation_length = sequence_length
    refresh = False
    seed = 42
    compute_dtype = None   # 'bfloat16' = mixed-precision conv trunks
    # data parallelism over mesh_dp ranks (-1: every visible GPU),
    # started from this command (train/driver.run_training); mesh_sp > 1
    # raises: data-parallel only, as the JAX package runs it
    mesh_dp = 0
    mesh_sp = 0
    multihost = False

    logdir = (f"{root}/baseline_Onset_Frame-"
              + datetime.now().strftime("%y%m%d-%H%M%S"))

    ex.observers.append(FileStorageObserver.create(logdir))


@ex.automain
def train(device, log, spec, model_name, model_complexity, XI, eps,
          VAT_mode, compute_dtype, seed, **_ignored):
    print_config(ex.current_run)
    from .train.driver import run_training

    kwargs = dict(model_complexity=model_complexity, log=log, mode=mode,
                  spec=spec, xi=XI, eps=eps, seed=seed, device=device,
                  compute_dtype=compute_dtype)
    if model_name != "onset_frame":
        kwargs["vat_mode"] = VAT_mode
    model = MODELS[model_name](**kwargs)
    return run_training(model, ex.current_run.config)
