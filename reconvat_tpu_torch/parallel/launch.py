"""Start the ranks of a data-parallel run from one command.

    python -m reconvat_tpu_torch.train_UNet_VAT with mesh_dp=2 ...

A training CLI asked for N ranks without a launcher's environment (see
`distributed.LAUNCH_ENV`) becomes rank 0 and starts ranks 1..N-1 itself,
each a process that runs the same CLI entry point with the same settings
and rank 0's run directory (`python -m reconvat_tpu_torch.parallel.launch
<module> <function> <settings>`); the ranks meet on a free local port.
Under a launcher (`torchrun`, or the environment set by hand on several
hosts) each process joins the group as the rank the environment names.
"""
from __future__ import annotations

import ast
import contextlib
import importlib
import os
import socket
import subprocess
import sys

from . import distributed

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def entry_module(fn) -> str:
    """The importable name of the module that defines `fn`."""
    name = fn.__module__
    if name == "__main__":
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        if spec is None:
            raise ValueError("several ranks from one command need the CLI "
                             "run as a module (python -m "
                             "reconvat_tpu_torch.<cli>)")
        name = spec.name
    return name


@contextlib.contextmanager
def ranks(world: int, device: str, main_fn, settings: dict):
    """Within, this process is one of `world` ranks of a started process
    group (nothing is started for one rank, or when the group exists
    already); yields whether it is rank 0. Without a launcher's
    environment it starts the other ranks, each running
    `main_fn` of its module through the module's `ex` with `settings`, and
    on leaving waits for them, raising if one failed (or, when this rank
    failed, stops them)."""
    if world == 1 or distributed.is_initialized():
        yield distributed.rank() == 0
        return
    workers = []
    if distributed.launcher_env():
        distributed.initialize(device=device)
    else:
        port = free_port()
        args = [sys.executable, "-m", __name__, entry_module(main_fn),
                main_fn.__name__, repr(settings)]
        path = os.pathsep.join(p for p in (PACKAGE_ROOT,
                                           os.environ.get("PYTHONPATH"))
                               if p)
        for r in range(1, world):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), PYTHONPATH=path)
            workers.append(subprocess.Popen(args, env=env))
    done = False
    try:
        if workers:
            distributed.initialize("localhost", port, world, 0, 0, world,
                                   device)
        yield distributed.rank() == 0
        done = True
    finally:
        if not done:
            for w in workers:
                w.kill()
        # every rank leaves the group before this one waits for the others
        # to end: NCCL's teardown waits for the peers' own
        distributed.shutdown()
        codes = [_wait(w) for w in workers]
    failed = [(r, c) for r, c in enumerate(codes, start=1) if c]
    if failed:
        raise RuntimeError(f"ranks (rank, exit code) {failed} failed")


def _wait(worker) -> int:
    """The worker's exit code; one that has not ended a collective's
    timeout after this rank left the group is stopped."""
    try:
        return worker.wait(timeout=distributed.TIMEOUT.total_seconds())
    except subprocess.TimeoutExpired:
        worker.kill()
        return worker.wait()


def main(argv: list) -> None:
    """Run one rank: `<module> <function> <settings>` (the settings as a
    Python literal)."""
    module, function, settings = argv
    mod = importlib.import_module(module)
    mod.ex.run(getattr(mod, function), ast.literal_eval(settings))


if __name__ == "__main__":
    main(sys.argv[1:])
