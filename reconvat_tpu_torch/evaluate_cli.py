"""Evaluate a model on the MAPS test split (full songs) and write its MIDI
and PNG artifacts (the port's counterpart of the root `evaluate.py`; the
library it drives is `reconvat_tpu_torch/evaluate.py`):

    python -m reconvat_tpu_torch.evaluate_cli with model_type=UNet_Onset \
        weight_file=runs/.../model-200

`model_type` is a name of the model registry: the root CLI's `ReconVAT`,
`UNet_Onset`, `OnsetsAndFrames`, `Thickstun`, `Segmentation` and
`Prestack`, or another transcriber of the JAX package's registry;
`Reconstructor`, which maps rolls to spectrograms, raises. `weight_file`
is a torch `.pt` of the reference's
state_dict names, a `model-N` checkpoint directory of the port's training
CLIs, or None (random weights, with a warning); an orbax checkpoint of the
JAX package raises. The songs of MAPS `ENSTDkAm` and `ENSTDkCl` (under
`RECONVAT_MAPS_ROOT`) go through the bucketed full-song runner; the table
of metrics is printed and `result_dict_{infer|no_infer}` written under
`logdir`. Runs on CUDA unless `device=cpu`; without a card, or for a model
it cannot evaluate, it raises before any work.
"""
import os
import pickle

import numpy as np

from .config import Experiment, print_config
from .models import check_model_name, get_model
from .models.base import resolve_device
from .train.driver import check_spec

log = True


def check_settings(cfg):
    """Raise for a model it cannot evaluate, a frontend it cannot evaluate
    (CFP, `train.driver.check_spec`), and CUDA without a card, before a
    dataset or a model is built."""
    check_model_name(cfg["model_type"])
    if cfg["model_type"] == "Reconstructor":
        raise ValueError("model_type='Reconstructor' maps frame rolls to "
                         "spectrograms: it transcribes nothing to evaluate")
    check_spec(cfg["spec"])
    resolve_device(cfg["device"])


ex = Experiment("evaluate", check=check_settings)


def load_weights(model, weight_file) -> None:
    """Load `weight_file` onto the model in place (see the module's
    docstring)."""
    if weight_file is None:
        print("WARNING: no weight_file given — evaluating random weights")
        return
    if weight_file.endswith(".pt"):
        model.load_reference_weights(weight_file)
        return
    from .train.checkpoint import load_state

    # a model-N directory of the port's training CLIs; an orbax directory
    # of the JAX package raises here
    model.load_reference_weights(load_state(weight_file)["model"])


@ex.config
def config():
    spec = "Mel"
    mode = "imagewise"
    model_type = "ReconVAT"
    reconstruction = False
    weight_file = None
    output_folder = "results"
    inference = True
    onset = True
    device = "cuda"
    refresh = False
    rule = "rule2"
    batch_songs = 1  # >1: same-bucket songs in one forward (exact)
    host_workers = 4  # thread pool over songs' host scoring (0 = sync)

    # under output_folder also for an absolute weight_file (the root CLI's
    # join would put it at the weights themselves)
    logdir = os.path.join(output_folder, str(weight_file).lstrip(os.sep))


@ex.automain
def main(model_type, reconstruction, spec, weight_file, mode, inference,
         device, refresh, rule, batch_songs, host_workers, logdir,
         **_ignored):
    print_config(ex.current_run)

    from .data.datasets import MAPS
    from .evaluate import (evaluate_wo_velocity, make_bucketed_runner,
                           metric_parts)
    from .train.prepare import _roots

    inference_state = "infer" if inference else "no_infer"
    model = get_model(model_type, log=log, reconstruction=reconstruction,
                      mode=mode, spec=spec, device=device)
    load_weights(model, weight_file)
    validation_dataset = MAPS(_roots()["MAPS"],
                              groups=["ENSTDkAm", "ENSTDkCl"],
                              sequence_length=None, refresh=refresh)

    metrics = evaluate_wo_velocity(
        validation_dataset, make_bucketed_runner(model),
        reconstruction=reconstruction, onset=inference, rule=rule,
        batch_songs=batch_songs, host_workers=host_workers,
        save_path=os.path.join(logdir, f"MIDI_results-{inference_state}"))

    for key, values in metrics.items():
        if metric_parts(key):
            category, name = metric_parts(key)
            print(f"{category:>32} {name:25}: "
                  f"{np.mean(values) * 100:.3f} ± {np.std(values) * 100:.3f}")
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, f"result_dict_{inference_state}"),
              "wb") as f:
        pickle.dump(dict(metrics), f)
    return {k: float(np.mean(v)) for k, v in metrics.items()
            if k.startswith("metric/")}
