"""Train the ReconVAT U-Net semi-supervised with VAT (the port's
counterpart of `train_UNet_VAT.py`, with its keys and defaults):

    python -m reconvat_tpu_torch.train_UNet_VAT with train_on=MAPS \
        small=True root=runs

Runs on CUDA unless `device=cpu`; without a card it raises before any
work. On the card the model runs the port's kernels (`attn_impl` 'auto' or
'pallas'); 'xla', the plain attention, is refused there and here alike.
`with mesh_dp=N` trains data-parallel on N ranks (one per GPU, or
sharing one; gloo ranks with `device=cpu`), started from this command, or
joins a launcher's group (`multihost=True`). `mesh_sp` > 1 (sequence
parallelism) and `conv_layout='folded'` raise,
`donate` has no effect (the updates are in place). Writes its run
directory under `root`: `config.json`, `run.json`, `_sources/`, the
TensorBoard event file, `model-N` checkpoints, `MIDI_results/` and
`result_dict`.
"""
from datetime import datetime

from .config import Experiment, FileStorageObserver, print_config
from .train.driver import check_settings, start_ranks

ex = Experiment("train_original", check=check_settings, launch=start_ranks)

ds_ksize, ds_stride = (2, 2), (2, 2)
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
    train_on = "Wind"
    n_heads = 4
    position = True
    iteration = 10
    VAT_start = 0
    alpha = 1
    VAT = True
    XI = 1e-6
    eps = 2
    small = False
    supersmall = True
    KL_Div = False
    reconstruction = False

    batch_size = 8
    train_batch_size = 1
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
    compute_dtype = 'bfloat16'  # fp32 params/BN/heads; None = full fp32
    attn_impl = 'auto'  # 'auto'|'pallas': the kernels ('xla' is refused)
    conv_layout = 'auto'  # 'auto'|'nhwc' ('folded' is TPU-only)
    # data parallelism over mesh_dp ranks (-1: every visible GPU),
    # started from this command (train/driver.run_training); mesh_sp > 1,
    # sequence parallelism, raises
    mesh_dp = 0
    mesh_sp = 0
    multihost = False
    # 'batched' fuses the labeled and unlabeled VAT chains into one
    # frozen-BN 2B chain; 'separate' keeps the reference's two train-mode
    # chains (models/reconvat.ReconVAT.vat_chain)
    vat_chain = 'separate'
    eval_host_workers = 4  # thread pool over songs' host metrics (0 = sync)

    logdir = (f"{root}/Unet-recons={reconstruction}-XI={XI}-eps={eps}"
              f"-alpha={alpha}-train_on=small_{small}_{train_on}"
              f"-w_size={w_size}-n_heads={n_heads}-lr={learning_rate}-"
              + datetime.now().strftime("%y%m%d-%H%M%S"))

    ex.observers.append(FileStorageObserver.create(logdir))


@ex.automain
def train(device, log, reconstruction, spec, XI, eps, KL_Div, compute_dtype,
          vat_chain, seed, **_ignored):
    cfg = ex.current_run.config
    print_config(ex.current_run)
    from .models.reconvat import ReconVAT
    from .train.driver import run_training

    model = ReconVAT(log=log, reconstruction=reconstruction, mode=mode,
                     spec=spec, xi=XI, eps=eps, kl_div=KL_Div, seed=seed,
                     device=device, compute_dtype=compute_dtype,
                     vat_chain=vat_chain)
    return run_training(model, cfg)
