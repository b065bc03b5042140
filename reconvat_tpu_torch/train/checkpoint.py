"""Checkpoint save and restore with auto-resume (the port's counterpart of
`reconvat_tpu/train/checkpoint.py`).

A checkpoint is a directory `model-{step}` holding `state.pt`: the model's
`state_dict` (parameters and BatchNorm statistics), the optimizer's and the
scheduler's `state_dict`s and the step. `save_checkpoint` copies every
tensor to the host before it returns, so the next step may change the
model at once, and writes the file in a background thread into a
temporary directory that is then renamed into place, as orbax does: a
reader never sees half a checkpoint. The JAX package's orbax directories
are not read (that needs orbax and tensorstore).
"""
from __future__ import annotations

import atexit
import os
import re
import shutil
import tempfile
import threading

import torch

from ..parallel import distributed

STATE_FILE = "state.pt"

_lock = threading.Lock()
_writers: list = []     # (thread, [exception]) of in-flight saves


def _to_host(obj):
    """obj with every tensor copied to the host (a copy even for a CPU
    tensor, so that later in-place updates do not reach it)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(tree, path):
    parent = os.path.dirname(path)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-",
                           dir=parent)
    try:
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(directory: str, step: int, model, state,
                    block: bool = False) -> str:
    """Save the model and the train state `state` (`train.state.
    TrainState`) as `directory/model-{step}`; returns its path. Returns
    once the tensors are on the host; block=True also waits for the file
    (before reading it back in the same process). In a data-parallel run
    over several ranks rank 0 alone writes, blocking, and every rank then
    waits at a barrier; each rank restores the same `model-N`."""
    path = os.path.abspath(os.path.join(directory, f"model-{step}"))
    if distributed.world_size() > 1:
        # several ranks hold the same state (parallel.mesh.replicate and
        # the all-reduced steps): rank 0 writes it, to the end, and every
        # rank waits at a barrier, so none races past an unfinished write
        if distributed.rank() == 0:
            _save(path, step, model, state, block=True)
        distributed.sync(f"checkpoint-{step}")
        return path
    _save(path, step, model, state, block)
    return path


def _save(path, step, model, state, block):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tree = _to_host({"model": model.state_dict(),
                     "optimizer": state.optimizer.state_dict(),
                     "scheduler": state.scheduler.state_dict(),
                     "step": int(state.step)})
    failure: list = []

    def run():
        try:
            _write(tree, path)
        except BaseException as e:   # raised by wait_for_checkpoints
            failure.append(e)

    thread = threading.Thread(target=run, name=f"checkpoint-{step}")
    with _lock:
        _writers.append((thread, failure))
    thread.start()
    if block:
        wait_for_checkpoints()


def wait_for_checkpoints() -> None:
    """Block until every checkpoint write in flight has landed; raises the
    first write's failure."""
    with _lock:
        writers = list(_writers)
        _writers.clear()
    for thread, _ in writers:
        thread.join()
    for _, failure in writers:
        if failure:
            raise failure[0]


atexit.register(wait_for_checkpoints)


def latest_checkpoint(directory: str):
    """The `model-N` directory of `directory` with the largest N, or
    None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = re.fullmatch(r"model-(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best


def load_state(path: str) -> dict:
    """The saved tree of a checkpoint directory (tensors on the host).
    Raises for a directory without `state.pt`, such as an orbax
    checkpoint of the JAX package."""
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        raise ValueError(
            f"{path!r} holds no {STATE_FILE}: it is not a checkpoint of "
            f"this package (an orbax checkpoint of the JAX package needs "
            f"orbax and tensorstore to read; not ported, ROADMAP §1)")
    return torch.load(file, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, model, state) -> None:
    """Load a checkpoint into `model` and the train state, in place."""
    tree = load_state(path)
    model.load_state_dict(tree["model"], strict=True)
    state.optimizer.load_state_dict(tree["optimizer"])
    state.scheduler.load_state_dict(tree["scheduler"])
    state.step = tree["step"]
