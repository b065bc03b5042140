"""Process-group start-up for data-parallel training (the port's
counterpart of `reconvat_tpu/parallel/distributed.py`).

The JAX package starts `jax.distributed` once per process; here each rank
is one process and `initialize` starts `torch.distributed`'s process group
once. Its arguments default to the standard launcher environment
(`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE`, as `torchrun` sets them), as the JAX package reads
`JAX_COORDINATOR_ADDRESS` and its neighbours.

Backend rule: NCCL when every rank of a host holds a CUDA device of its own
(rank `LOCAL_RANK` on `cuda:LOCAL_RANK`); gloo on the CPU, and for ranks
that share a card (NCCL refuses two ranks on one device; gloo all-reduces
and broadcasts CUDA tensors through the host). The choice is printed. An
initialization that fails raises; it is never retried on the other
backend.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


# how long a rank waits at a collective for the others (a checkpoint write
# of rank 0 holds the others at a barrier)
TIMEOUT = datetime.timedelta(minutes=30)

_STARTED = False        # this module started the process group
_DEVICE = None          # the device `initialize` gave this rank


def launcher_env() -> bool:
    """True when the launcher's variables (`LAUNCH_ENV`) are all set."""
    return all(os.environ.get(k) for k in LAUNCH_ENV)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def choose_backend(device: str, local_world: int) -> str:
    """'nccl' when `device` is CUDA and the host has a card for each of its
    `local_world` ranks, else 'gloo'."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def initialize(address: str | None = None, port: int | None = None,
               world: int | None = None, rank_: int | None = None,
               local_rank: int | None = None,
               local_world: int | None = None,
               device: str = "cuda") -> torch.device:
    """Start the process group once (idempotent) and return this rank's
    device: `cuda:LOCAL_RANK` under NCCL, `cuda:LOCAL_RANK mod cards`
    under gloo on CUDA (made the current device, so that 'cuda' means it),
    or the CPU. Arguments not given are read from the launcher's
    environment."""
    global _STARTED, _DEVICE
    env = os.environ
    address = address or env.get("MASTER_ADDR", "localhost")
    port = int(port if port is not None else env["MASTER_PORT"])
    world = int(world if world is not None else env["WORLD_SIZE"])
    rank_ = int(rank_ if rank_ is not None else env["RANK"])
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", rank_))
    local_world = int(local_world if local_world is not None
                      else env.get("LOCAL_WORLD_SIZE", world))
    kind = torch.device(device).type
    backend = choose_backend(device, local_world)
    if kind == "cuda":
        index = local_rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        here = torch.device("cuda", index)
    else:
        here = torch.device("cpu")
    _DEVICE = here
    if is_initialized():
        return here
    how = ("a card per rank" if backend == "nccl" else
           "ranks share a card" if kind == "cuda" else "CPU ranks")
    print(f"rank {rank_} of {world}: process group on {backend} ({here}; "
          f"{how})", flush=True)
    kwargs = {"device_id": here} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{address}:{port}",
                            world_size=world, rank=rank_, timeout=TIMEOUT,
                            **kwargs)
    _STARTED = True
    return here


def device() -> torch.device:
    """This rank's device (`initialize`'s), the CPU before it ran."""
    return _DEVICE if _DEVICE is not None else torch.device("cpu")


def shutdown() -> None:
    """End the process group if `initialize` started it."""
    global _STARTED, _DEVICE
    if _STARTED and is_initialized():
        dist.destroy_process_group()
    _STARTED, _DEVICE = False, None


def sync(name: str = "sync") -> None:
    """Barrier across every rank; does nothing in one process."""
    del name
    if world_size() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
