"""The device mesh of the port (counterpart of paddle_tpu/parallel/mesh.py).

The reference's mesh is a `jax.sharding.Mesh` over `jax.devices()` in one
process.  The port's is over the ranks of the process group: world size
stands in for device count, and the axes sit over
`torch.distributed.device_mesh.init_device_mesh` when a group of more
than one is running.  This slice is data parallelism: a mesh that gives
an axis other than `data` (or its alias `dp`) a size above 1 raises;
the model-parallel axes are ROADMAP queue 1 item 10b.

Axis names (the reference's): "data", "fsdp", "tp", "model", "pipe",
"seq".
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"

DATA_AXES = (DATA_AXIS, "dp")
LATER = ("the model-parallel axes (fsdp, tp, model, pipe, seq) wait for "
         "ROADMAP queue 1 item 10b")

_current_mesh = [None]


class Mesh:
    """Named axes over the group's ranks.  `group` is the data axis's
    process group (None: the whole world, or no group)."""

    def __init__(self, axes: Dict[str, int], device_mesh=None):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.device_mesh = device_mesh

    @property
    def data_axis(self) -> str:
        return next((a for a in self.axis_names if a in DATA_AXES),
                    DATA_AXIS)

    @property
    def group(self):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(self.data_axis)

    @property
    def data_size(self) -> int:
        return int(self.shape.get(self.data_axis, 1))

    def __repr__(self):
        return f"Mesh({self.shape})"


def _world() -> int:
    from ..distributed import parallel

    return parallel.process_count() if parallel.is_initialized() else 1


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices=None) -> Mesh:
    """A mesh over the group's ranks (`devices`, when given, stands for
    them by its length).  `axes` maps axis -> size; a -1 size takes the
    rest.  Default: every rank on the data axis."""
    n = len(list(devices)) if devices is not None else _world()
    if not axes:
        axes = {DATA_AXIS: n}
    names = list(axes)
    sizes = [int(axes[k]) for k in names]
    fixed = math.prod(s for s in sizes if s != -1)
    sizes = [n // max(fixed, 1) if s == -1 else s for s in sizes]
    other = {k: s for k, s in zip(names, sizes)
             if k not in DATA_AXES and s > 1}
    if other:
        raise NotImplementedError(f"mesh axes {other}: {LATER}")
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} ranks")
    dm = None
    if n > 1 and _world() == n:
        from torch.distributed.device_mesh import init_device_mesh

        from ..distributed import parallel

        dev = parallel.device()
        dm = init_device_mesh(dev.type if dev is not None else "cpu",
                              tuple(sizes), mesh_dim_names=tuple(names))
    return Mesh(dict(zip(names, sizes)), dm)


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    _current_mesh[0] = mesh


def current_mesh() -> Optional[Mesh]:
    return _current_mesh[0]


def global_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh over every rank of the group."""
    return make_mesh(axes)


def batch_spec(mesh: Mesh, nrows: int) -> tuple:
    """The axes a batch's leading dim splits over: the data axis when
    its size divides `nrows`, else () (every rank keeps the rows)."""
    size = mesh.data_size
    if size > 1 and nrows % size == 0:
        return (mesh.data_axis,)
    return ()


def _rank_in(mesh: Mesh) -> int:
    from ..distributed import comm

    return comm.rank(mesh.group)


def shard_host_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """This rank's rows of a global batch: each leaf (numpy array or
    tensor, or a dict / list / tuple of them) cut along dim 0 into the
    data axis's size, block `rank`.  The rows must split evenly."""
    n = mesh.data_size
    r = _rank_in(mesh) if n > 1 else 0

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if not isinstance(x, (np.ndarray, torch.Tensor)) or n == 1:
            return x
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} ranks")
        k = rows // n
        return x[r * k:(r + 1) * k]

    return cut(tree)
