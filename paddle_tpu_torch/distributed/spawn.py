"""`paddle.distributed.spawn` (counterpart of paddle_tpu/distributed/
spawn.py): run a function in N fresh trainer processes under the
launcher's PADDLE_* contract.

The trainers are new Python processes started with `subprocess`, each of
which imports `func` by its module and name and calls it; `func` then
calls `init_parallel_env()` (as Paddle's spawned functions do).  `spawn`
and `launch` are two doors to the same topology code.  `func` must be
importable (a module-level def), as Paddle requires where it spawns.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .launch_utils import (find_free_ports, get_cluster,
                           start_local_trainers, terminate_local_trainers,
                           visible_gpus, watch_local_trainers)

_WORKER_SNIPPET = """\
import os, pickle, sys, importlib
spec = sys.argv[1]
with open(spec, "rb") as f:
    mod_name, fn_name, args = pickle.load(f)
fn = importlib.import_module(mod_name)
for part in fn_name.split("."):
    fn = getattr(fn, part)
fn(*args)
"""


@dataclass
class SpawnContext:
    procs: List
    spec_path: str

    def _cleanup(self):
        try:
            os.unlink(self.spec_path)
        except OSError:
            pass

    def join(self) -> int:
        try:
            return watch_local_trainers(self.procs)
        finally:
            self._cleanup()

    def terminate(self):
        try:
            terminate_local_trainers(self.procs)
        finally:
            self._cleanup()


def spawn(func, args: Tuple = (), nprocs: int = -1, join: bool = True,
          started_port: Optional[int] = None, gpus=None,
          env: Optional[dict] = None) -> Optional[SpawnContext]:
    """Spawn `nprocs` trainers each calling `func(*args)` under the
    PADDLE_* contract; nprocs=-1 means one a card (one without CUDA).
    `gpus`: the cards to deal out (default launch_utils.visible_gpus());
    `env`: extra environment for every trainer.  With join, waits and
    raises on the first nonzero exit code; else returns the context."""
    gpus = visible_gpus() if gpus is None else list(gpus)
    if nprocs == -1:
        nprocs = max(1, len(gpus))
    mod = getattr(func, "__module__", None)
    qual = getattr(func, "__qualname__", None)
    if not mod or not qual or "<locals>" in qual or mod == "__main__":
        raise ValueError(
            "spawn(func): func must be importable from workers "
            f"(module-level def), got {mod}:{qual}")

    fd, spec_path = tempfile.mkstemp(suffix=".spawn.pkl")
    with os.fdopen(fd, "wb") as f:
        pickle.dump((mod, qual, args), f)

    ports = ([started_port + i for i in range(nprocs)] if started_port
             else find_free_ports(nprocs))
    cluster, pod = get_cluster(["127.0.0.1"], "127.0.0.1", ports, nprocs,
                               gpus)
    cmd = [sys.executable, "-u", "-c", _WORKER_SNIPPET, spec_path]
    procs = start_local_trainers(cluster, pod, cmd, extra_env=env)
    ctx = SpawnContext(procs=procs, spec_path=spec_path)
    if not join:
        return ctx
    rc = ctx.join()
    if rc != 0:
        raise RuntimeError(f"spawned worker failed with exit code {rc}")
    return None
