"""Train the semantic-segmentation transcriber, "baseline_Multi_Inst" (the
port's counterpart of `train_baseline_Multi_Inst.py`, with its keys and
defaults):

    python -m reconvat_tpu_torch.train_baseline_Multi_Inst with train_on=MAPS

`SemanticSegmentation` over `train.driver.run_training`: 8 labeled clips a
step, VAT off by default (`VAT=True` adds 8 unlabeled ones). Runs on CUDA
unless `device=cpu`; without a card, for `conv_layout=folded`, the CFP
frontend or a crop whose frames do not split over `mesh_sp` into
multiples of 16 it raises before the run directory is written
(`train.driver.check_settings`). `with mesh_dp=N mesh_sp=S` trains on N x
S ranks, started from this command: the batch over N, each crop's frames
over S (sequence parallelism: the layers take the neighbouring ranks'
frames, `models/segmentation.py`); rank 0 alone writes. Writes its run
directory under `root` as `train_UNet_VAT` does.
"""
from datetime import datetime
from functools import partial

from .config import Experiment, FileStorageObserver, print_config
from .models.segmentation import SemanticSegmentation
from .train.driver import check_settings, start_ranks

ex = Experiment("train_original",
                check=partial(check_settings, model=SemanticSegmentation),
                launch=start_ranks)

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
    n_heads = 1
    position = True
    iteration = 10
    VAT_start = 0
    alpha = 1
    VAT = False
    XI = 1e-6
    eps = 1e-2
    small = True
    supersmall = False
    KL_Div = False
    reconstruction = False
    out_class = 1

    batch_size = 8
    train_batch_size = 8
    sequence_length = 327680

    epoches = 20000
    learning_rate = 1e-3
    learning_rate_decay_steps = 1000
    learning_rate_decay_rate = 0.98
    leave_one_out = None
    clip_gradient_norm = 3
    validation_length = sequence_length
    refresh = False
    seed = 42
    compute_dtype = None   # 'bfloat16' = mixed-precision compute
    conv_layout = 'auto'   # 'auto' or 'nhwc'; 'folded' (TPU) raises
    # mesh_dp x mesh_sp ranks (mesh_dp -1: every visible GPU over mesh_sp),
    # started from this command (train/driver.run_training): the batch over
    # dp, each crop's frames over sp (multiples of 16 frames a rank)
    mesh_dp = 0
    mesh_sp = 0
    multihost = False

    logdir = (f"{root}/VAT_Segmentation={reconstruction}-KL={KL_Div}-XI={XI}"
              f"-eps={eps}-alpha={alpha}-train_on=small_{small}_{train_on}"
              f"-w_size={w_size}-n_heads={n_heads}-lr={learning_rate}-"
              + datetime.now().strftime("%y%m%d-%H%M%S"))

    ex.observers.append(FileStorageObserver.create(logdir))


@ex.automain
def train(spec, device, log, XI, eps, KL_Div, out_class, compute_dtype,
          conv_layout, seed, **_ignored):
    print_config(ex.current_run)
    from .train.driver import run_training

    model = SemanticSegmentation(out_class=out_class, log=log, mode=mode,
                                 spec=spec, xi=XI, eps=eps, kl_div=KL_Div,
                                 compute_dtype=compute_dtype,
                                 conv_layout=conv_layout, seed=seed,
                                 device=device)
    return run_training(model, ex.current_run.config)
