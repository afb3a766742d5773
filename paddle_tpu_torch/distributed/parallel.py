"""Process group bootstrap (counterpart of paddle_tpu/distributed/
parallel.py).

The reference runs one controller over every device: its
`init_parallel_env` calls `jax.distributed.initialize` and its collectives
are `lax` collectives inside a `shard_map`.  The port runs one process a
rank, as Paddle does: `init_parallel_env` starts a `torch.distributed`
process group from the launcher's `PADDLE_*` contract, and each
collective rule calls `torch.distributed` on the group its ring names.

The backend is `nccl` for a CUDA device and `gloo` for the CPU.  `gloo`
runs on CUDA tensors only when it is asked for, by
`PADDLE_DISTRI_BACKEND=gloo` or the `backend` argument (Paddle 2.x's
switch); nothing switches the backend or the device silently.  NCCL
cannot hold two ranks of one communicator on one card, so a group with
more NCCL ranks on this host than cards raises and names both counts.

Each rank's device is `cuda:{FLAGS_selected_gpus or local rank}`, or the
CPU when `device="cpu"` is given.  With no group, or a group of one,
every collective rule is the identity (the reference's rules outside a
mesh), so one process computes today's bits.
"""

from __future__ import annotations

import datetime
import inspect
import os
from typing import Optional

import torch

_STATE = {"backend": None, "device": None, "store": None, "prev_device": None}

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600.0


def _dist():
    return torch.distributed


def is_initialized() -> bool:
    d = _dist()
    return d.is_available() and d.is_initialized()


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v.strip() else default


def _endpoints():
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return [e for e in eps.split(",") if e]


def process_index() -> int:
    """This process's rank: the live group's, else the PADDLE_* contract,
    else 0.  The key the feed pipeline shards datasets by."""
    if is_initialized():
        return _dist().get_rank()
    return _env_int("PADDLE_TRAINER_ID", 0)


def process_count() -> int:
    """The number of ranks: the live group's, else the PADDLE_*
    contract, else 1."""
    if is_initialized():
        return _dist().get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", 1)


def local_rank() -> int:
    """This rank's index among the ranks of its host: PADDLE_LOCAL_RANK
    when the launcher set it, else the rank's position among the
    endpoints of its own host, else the rank."""
    if "PADDLE_LOCAL_RANK" in os.environ:
        return _env_int("PADDLE_LOCAL_RANK", 0)
    rank = _env_int("PADDLE_TRAINER_ID", 0)
    eps = _endpoints()
    if rank < len(eps):
        host = eps[rank].rsplit(":", 1)[0]
        return sum(1 for e in eps[:rank] if e.rsplit(":", 1)[0] == host)
    return rank


def local_count() -> int:
    """The number of ranks on this host (endpoints sharing its address),
    else the world size."""
    rank = _env_int("PADDLE_TRAINER_ID", 0)
    eps = _endpoints()
    if rank < len(eps):
        host = eps[rank].rsplit(":", 1)[0]
        return sum(1 for e in eps if e.rsplit(":", 1)[0] == host)
    return process_count()


def rank_device(device=None) -> torch.device:
    """The rank's device: `device` when given ("cpu" asks for the CPU),
    else `cuda:{FLAGS_selected_gpus or local rank}`."""
    if device is not None:
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", _selected_gpu())
        return d
    return torch.device("cuda", _selected_gpu())


def _selected_gpu() -> int:
    sel = os.environ.get("FLAGS_selected_gpus", "").split(",")[0].strip()
    return int(sel) if sel else local_rank()


def select_backend(device: torch.device, backend: Optional[str] = None
                   ) -> str:
    """nccl for CUDA, gloo for the CPU; gloo on CUDA only when asked
    (the argument, else PADDLE_DISTRI_BACKEND)."""
    asked = backend or os.environ.get("PADDLE_DISTRI_BACKEND") or None
    if asked is not None:
        asked = asked.lower()
        if asked not in BACKENDS:
            raise ValueError(f"backend {asked!r}: one of {BACKENDS}")
        if asked == "nccl" and device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device; the CPU "
                             "runs gloo")
        return asked
    return "nccl" if device.type == "cuda" else "gloo"


def backend() -> Optional[str]:
    """The live group's backend, else None."""
    if not is_initialized():
        return None
    return _STATE["backend"] or _dist().get_backend()


def device() -> Optional[torch.device]:
    """The device init_parallel_env chose for this rank, else None."""
    return _STATE["device"] if is_initialized() else None


class ParallelEnv:
    """This rank's place in the job (fluid.dygraph.ParallelEnv): read
    from the live group where there is one, else from the PADDLE_*
    contract."""

    def __init__(self):
        self._rank = process_index()
        self._world_size = process_count()
        self._local_rank = local_rank()
        self._device_id = _selected_gpu()
        self._endpoints = _endpoints()

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def nranks(self):
        return self._world_size

    @property
    def dev_id(self):
        return self._device_id

    @property
    def trainer_endpoints(self):
        return list(self._endpoints)


def init_parallel_env(backend: Optional[str] = None, device=None,
                      store=None, rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> ParallelEnv:
    """Start this rank's process group and return its ParallelEnv.

    The rendezvous is read from the PADDLE_* contract where the
    arguments do not give it: rank PADDLE_TRAINER_ID, world size
    PADDLE_TRAINERS_NUM, address the first of PADDLE_TRAINER_ENDPOINTS
    (`tcp://host:port`).  `store` (a torch.distributed Store, such as a
    FileStore) takes the address's place.  A rank waits up to TIMEOUT_S
    for the others.  A world of one with no
    address rendezvouses through an in-process store.  Calling it again
    returns the live group's ParallelEnv."""
    if is_initialized():
        return ParallelEnv()
    d = _dist()
    rank = _env_int("PADDLE_TRAINER_ID", 0) if rank is None else int(rank)
    world_size = _env_int("PADDLE_TRAINERS_NUM", max(1, len(_endpoints()))) \
        if world_size is None else int(world_size)
    dev = rank_device(device)
    be = select_backend(dev, backend)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"init_parallel_env: device {dev} but CUDA is not "
                "available; pass device='cpu' for the gloo CPU group")
        cards = torch.cuda.device_count()
        here = min(world_size, local_count()) if _endpoints() \
            else world_size
        if be == "nccl" and here > cards:
            raise RuntimeError(
                f"init_parallel_env: {here} NCCL ranks on this host but "
                f"{cards} card(s): NCCL cannot hold two ranks of one "
                "communicator on one card; start at most one rank a card, "
                "or ask for gloo (PADDLE_DISTRI_BACKEND=gloo)")
        if dev.index >= cards:
            raise RuntimeError(f"init_parallel_env: device {dev} but this "
                               f"host has {cards} card(s)")
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    init_method = None
    if store is None:
        eps = _endpoints()
        if eps:
            init_method = f"tcp://{eps[0]}"
        elif world_size == 1:
            store = d.HashStore()
        else:
            raise RuntimeError(
                "init_parallel_env: no rendezvous for a world of "
                f"{world_size}: set PADDLE_TRAINER_ENDPOINTS (the "
                "launcher does) or pass store=")
    kw = dict(backend=be, rank=rank, world_size=world_size, timeout=timeout)
    if be == "nccl" and "device_id" in inspect.signature(
            d.init_process_group).parameters:
        kw["device_id"] = dev
    if store is not None:
        d.init_process_group(store=store, **kw)
    else:
        d.init_process_group(init_method=init_method, **kw)
    from .. import device as _device

    _STATE.update(backend=be, device=dev, store=store,
                  prev_device=_device._CURRENT[0])
    _device.set_device(dev)
    return ParallelEnv()


def destroy_parallel_env() -> None:
    """Tear the group down (and the rings and mesh built over it), and
    give the port back the default device it had before the group."""
    from . import comm

    comm.reset()
    if is_initialized():
        _dist().destroy_process_group()
    if _STATE["device"] is not None:
        from .. import device as _device

        _device._CURRENT[0] = _STATE["prev_device"]
    _STATE.update(backend=None, device=None, store=None, prev_device=None)


def prepare_context(strategy=None):
    """fluid.dygraph.prepare_context: start the group from the PADDLE_*
    contract when the job has more than one rank; returns the
    ParallelEnv the caller hands to DataParallel."""
    if process_count() > 1:
        init_parallel_env()
    return ParallelEnv()
