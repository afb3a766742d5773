"""The device mesh of the port (counterpart of paddle_tpu/parallel/mesh.py).

The reference's mesh is a `jax.sharding.Mesh` over `jax.devices()` in one
process.  The port's is over the ranks of the process group: world size
stands in for device count, and the axes sit over
`torch.distributed.device_mesh.init_device_mesh` when a group of more
than one is running (ranks laid out row-major over the axes, in the
order the axes are named, as the reference reshapes its device list).

Axis names (the reference's): "data" (or "dp"), "fsdp", "tp" (or "mp",
the tensor axis of the BERT step), "model", "pipe", "seq".  A mesh may
give data, fsdp, tp, mp and other axes any size; "seq" / "sp" above 1
waits for ROADMAP queue 1 item 10b (iii), "pipe" / "pp" and "model" for
item 10b (iv), and raise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .spec_layout import P

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"

DATA_AXES = (DATA_AXIS, "dp")
# axes of size above 1 that wait for a later step of ROADMAP queue 1
# item 10b
LATER = {SEQ_AXIS: "(iii), sequence parallelism",
         "sp": "(iii), sequence parallelism",
         PIPE_AXIS: "(iv), the pipeline",
         "pp": "(iv), the pipeline",
         MODEL_AXIS: "(iv), with the collective rules' model rings"}

_current_mesh = [None]


class Mesh:
    """Named axes over the group's ranks.  `device_mesh` is the
    `DeviceMesh` over them (None without a group of that many ranks);
    `group` is the data axis's process group."""

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
        """The data axis's group (None: no group, or a mesh without a
        data axis)."""
        return axis_group(self, self.data_axis)

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
    for k, s in zip(names, sizes):
        if k in LATER and s > 1:
            raise NotImplementedError(
                f"mesh axis {k!r} of size {s}: waits for ROADMAP queue 1 "
                f"item 10b {LATER[k]}")
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


def axis_group(mesh: Mesh, axis: str):
    """The process group of this rank's line along `axis` (the ranks
    that differ from it only in that axis), through
    `DeviceMesh.get_group`; None without a device mesh or for an axis
    the mesh lacks."""
    if mesh.device_mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.device_mesh.get_group(axis)


def axis_rank(mesh: Mesh, axis: str) -> int:
    """This rank's index along `axis` (0 without a device mesh or for an
    axis the mesh lacks)."""
    if mesh.device_mesh is None or axis not in mesh.axis_names:
        return 0
    return int(mesh.device_mesh.get_local_rank(axis))


def batch_axes(mesh: Mesh, nrows: Optional[int]) -> Tuple[str, ...]:
    """The axes a batch's leading dim splits over: the data axis composed
    with fsdp when present (fsdp ranks take their own rows too),
    degrading to whatever prefix divides `nrows`, else none; `nrows`
    None assumes the whole composition divides (spec_rules
    .batch_entries)."""
    axes = [a for a in (mesh.data_axis, FSDP_AXIS) if a in mesh.shape]
    while axes:
        size = math.prod(int(mesh.shape[a]) for a in axes)
        if size > 1 and (nrows is None or (nrows > 0 and nrows % size == 0)):
            return tuple(axes)
        axes.pop()
    return ()


def batch_spec(mesh: Mesh, nrows: int) -> P:
    """PartitionSpec of a batch's leading dim (the reference's
    `batch_spec`): P("data", "fsdp") composed when both are present and
    divide, P("data") (or the axis left) when only that divides, P()
    else."""
    axes = batch_axes(mesh, nrows)
    if not axes:
        return P()
    return P(axes if len(axes) > 1 else axes[0])


def block_index(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's block, number of blocks) of a dim split over `axes`,
    the first the major one."""
    idx, n = 0, 1
    for a in axes:
        size = int(mesh.shape[a])
        idx, n = idx * size + axis_rank(mesh, a), n * size
    return idx, n


def shard_host_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """This rank's rows of a global batch: each leaf (numpy array or
    tensor, or a dict / list / tuple of them) cut along dim 0 over the
    batch axes (`batch_axes`: data x fsdp where both divide the rows),
    block `block_index` over them; the tp (or mp) ranks of one batch
    index get the same rows.  `axis` is the reference's argument, the
    data axis's name; the data axis the mesh names is used.  The rows
    must split over the data axis at least."""
    del axis

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        rows = x.shape[0]
        axes = batch_axes(mesh, rows)
        if mesh.data_size > 1 and mesh.data_axis not in axes:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{mesh.data_size} ranks")
        r, n = block_index(mesh, axes)
        if n == 1:
            return x
        k = rows // n
        return x[r * k:(r + 1) * k]

    return cut(tree)
