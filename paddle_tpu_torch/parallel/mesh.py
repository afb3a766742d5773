"""The device mesh of the port (counterpart of paddle_tpu/parallel/mesh.py).

The reference's mesh is a `jax.sharding.Mesh` over `jax.devices()` in one
process.  The port's is over the ranks of the process group: world size
stands in for device count, and the axes sit over
`torch.distributed.device_mesh.init_device_mesh` when a group of more
than one is running (ranks laid out row-major over the axes, in the
order the axes are named, as the reference reshapes its device list).

Axis names (the reference's): "data" (or "dp"), "fsdp", "tp" (or "mp",
the tensor axis of the BERT step), "seq" (or "sp", the sequence axis of
ring and Ulysses attention), "model", "pipe".  A mesh may give data,
fsdp, tp, mp, seq, sp and other axes any size; "pipe" / "pp" and "model"
above 1 wait for ROADMAP queue 1 item 10b (iv), and raise.  A batch's
leading dim splits over data x fsdp (`batch_spec`), and a sequence
leaf's dim 1 over the sequence axis (`batch_spec(..., seq=True)`;
`shard_host_batch` cuts the leaves its caller names).
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
SEQ_AXES = (SEQ_AXIS, "sp")
# axes of size above 1 that wait for a later step of ROADMAP queue 1
# item 10b
LATER = {PIPE_AXIS: "(iv), the pipeline",
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
        self._axes_groups = {}  # axes -> group (axes_group)

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


def axes_group(mesh: Mesh, axes):
    """The process group of this rank's ranks along several axes at once
    (those that differ from it only in `axes`): `axis_group` for one
    axis above 1, else a group made once a mesh by
    `torch.distributed.new_group` over every such line (each rank makes
    all of them, in one order).  None without a device mesh or with no
    axis above 1."""
    axes = tuple(a for a in mesh.axis_names
                 if a in axes and int(mesh.shape[a]) > 1)
    if mesh.device_mesh is None or not axes:
        return None
    if len(axes) == 1:
        return axis_group(mesh, axes[0])
    cache = mesh._axes_groups
    if axes not in cache:
        names = list(mesh.axis_names)
        inner = [names.index(a) for a in axes]
        outer = [i for i in range(len(names)) if i not in inner]
        ranks = mesh.device_mesh.mesh.cpu().numpy().transpose(
            outer + inner).reshape(-1, math.prod(int(mesh.shape[a])
                                                 for a in axes))
        me = torch.distributed.get_rank()
        for line in ranks:
            g = torch.distributed.new_group([int(r) for r in line])
            if me in line:
                cache[axes] = g
    return cache[axes]


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


def seq_axis(mesh: Mesh) -> Optional[str]:
    """The mesh's sequence axis ("seq" or "sp") above 1, else None."""
    return next((a for a in mesh.axis_names
                 if a in SEQ_AXES and int(mesh.shape[a]) > 1), None)


def batch_spec(mesh: Mesh, nrows: int, seq: bool = False) -> P:
    """PartitionSpec of a batch's leading dim (the reference's
    `batch_spec`): P("data", "fsdp") composed when both are present and
    divide, P("data") (or the axis left) when only that divides, P()
    else.  With `seq`, the spec of a sequence leaf (B, S, ...): dim 1 over
    the mesh's sequence axis too, where it has one (the reference's
    P(dp, sp) of the BERT step's ids and masks)."""
    axes = batch_axes(mesh, nrows)
    lead = (axes if len(axes) > 1 else axes[0]) if axes else None
    sa = seq_axis(mesh) if seq else None
    if sa is not None:
        return P(lead, sa)
    return P(lead) if lead is not None else P()


def block_index(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's block, number of blocks) of a dim split over `axes`,
    the first the major one."""
    idx, n = 0, 1
    for a in axes:
        size = int(mesh.shape[a])
        idx, n = idx * size + axis_rank(mesh, a), n * size
    return idx, n


def shard_host_batch(mesh: Mesh, tree, axis: str = DATA_AXIS,
                     seq_keys=()):
    """This rank's piece of a global batch: each leaf (numpy array or
    tensor, or a dict / list / tuple of them) cut along dim 0 over the
    batch axes (`batch_axes`: data x fsdp where both divide the rows),
    block `block_index` over them; the tp (or mp) ranks of one batch
    index get the same rows.  On a mesh with a sequence axis, a dict's
    leaves under `seq_keys` (the caller's sequence leaves, (B, S, ...):
    `models.bert.SEQ_KEYS` for the BERT step) are cut along dim 1 over it
    too (rank j of n takes tokens [j S/n, (j + 1) S/n)), the others only
    by rows.  `axis` is the reference's argument, the data axis's name;
    the data axis the mesh names is used.  The rows must split over the
    data axis at least, and a sequence leaf over the sequence axis."""
    del axis
    sa = seq_axis(mesh)

    def cut(x, key=None):
        if isinstance(x, dict):
            return {k: cut(v, k) for k, v in x.items()}
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
        if n > 1:
            k = rows // n
            x = x[r * k:(r + 1) * k]
        if sa is not None and key in seq_keys:
            j, m = axis_rank(mesh, sa), int(mesh.shape[sa])
            if x.shape[1] % m:
                raise ValueError(f"{key}: a sequence of {x.shape[1]} does "
                                 f"not split over {m} ranks")
            k = x.shape[1] // m
            x = x[:, j * k:(j + 1) * k]
        return x

    return cut(tree)
