"""Train the Thickstun translation-invariant baseline (the port's
counterpart of `train_baseline_Thickstun.py`, with its keys and defaults):

    python -m reconvat_tpu_torch.train_baseline_Thickstun with train_on=MAPS

Supervised full-epoch sweeps at batch 1 (`train_loop='full_epoch'`,
`train.driver.run_training`). Runs on CUDA unless `device=cpu`; without a
card, for `mesh_sp` > 1 or the CFP frontend it raises before the run
directory is written (`train.driver.check_settings`); `with mesh_dp=N`
trains data-parallel on N ranks. Writes its run
directory under `root` as `train_UNet_VAT` does.
"""
from datetime import datetime

from .config import Experiment, FileStorageObserver, print_config
from .train.driver import check_settings, start_ranks

ex = Experiment("train_original", check=check_settings, launch=start_ranks)

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
    spec = "Mel"
    resume_iteration = None
    train_on = "String"
    n_heads = 4
    position = True
    iteration = 10
    VAT_start = 0
    alpha = 1
    VAT = False
    XI = 1e-6
    eps = 1.3
    small = True
    supersmall = False
    KL_Div = False
    reconstruction = False

    batch_size = 1
    train_batch_size = 1
    sequence_length = 327680

    epoches = 20000
    learning_rate = 0.0001
    learning_rate_decay_steps = 1000
    learning_rate_decay_rate = 0.98
    leave_one_out = None
    clip_gradient_norm = 3
    validation_length = sequence_length
    refresh = False
    seed = 42
    # reference protocol: full-epoch supervised sweeps, not the
    # 10-iteration VAT loop (`train_baseline_Thickstun.py:122`)
    train_loop = "full_epoch"
    compute_dtype = None   # 'bfloat16' = mixed-precision compute
    # data parallelism over mesh_dp ranks (-1: every visible GPU),
    # started from this command (train/driver.run_training); mesh_sp > 1,
    # sequence parallelism, raises
    mesh_dp = 0
    mesh_sp = 0
    multihost = False

    logdir = (f"{root}/baseline_Thickstun-train_on={train_on}"
              f"-lr={learning_rate}-"
              + datetime.now().strftime("%y%m%d-%H%M%S"))

    ex.observers.append(FileStorageObserver.create(logdir))


@ex.automain
def train(device, log, spec, compute_dtype, seed, **_ignored):
    print_config(ex.current_run)
    from .models.thickstun import Thickstun
    from .train.driver import run_training

    model = Thickstun(log=log, mode=mode, spec=spec, seed=seed,
                      device=device,
                      compute_dtype=compute_dtype)
    return run_training(model, ex.current_run.config)
