"""PartitionSpec rule engine, stdlib-only: the port's own copy of
paddle_tpu/parallel/spec_rules.py, the same rules over the same plain
data, so both packages resolve one layout for one name, shape and mesh.

* a **spec** is a tuple of entries, one per dim, each entry
  ``None | str | tuple[str, ...]`` (exactly ``tuple(PartitionSpec)``);
* a **mesh** is a plain ``{axis_name: size}`` dict.

`spec_layout` is the adapter over this module (tuples in, its
`PartitionSpec` out), and the compiler's SPMD arm cuts each rank's shard
by what it returns.

`fit_entries` is the clamp seam: it returns the clamp REASONS next to
the fitted spec, so callers can count and log what a misfit spec lost
(the `spec_clamped` stat).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"

# spec entry: None (replicated dim) | axis name | tuple of axis names
Entry = object
Entries = Tuple[Entry, ...]
MeshAxes = Dict[str, int]

# name fragments that mark replicated-by-design variables: norm/bn
# stats and scales, biases, scalar bookkeeping (Adam pow accumulators,
# learning rate).
REPLICATED_PAT = re.compile(
    r"(batch_norm|layer_norm|\bnorm\b|_norm|\bln_|\.b_0|_bias|\bbias"
    r"|scale|beta|gamma|_mean|_variance|pow_acc|learning_rate)")

EMBEDDING_PAT = re.compile(r"(embedding|emb_|word_emb|pos_emb|_emb\b)")


def entry_names(entry) -> Tuple[str, ...]:
    """The mesh axis names one spec entry binds (empty for None)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def axis_extent(mesh_axes: MeshAxes, entry) -> int:
    """Product extent of one entry's axes over the mesh (1 for None;
    absent axes count 1 so callers can extent-check fitted specs)."""
    size = 1
    for n in entry_names(entry):
        size *= int(mesh_axes.get(n, 1))
    return size


def trim_entries(entries: Sequence) -> Entries:
    """Drop trailing None entries — the canonical PartitionSpec form."""
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def sharded_extent(entries: Optional[Sequence],
                   mesh_axes: MeshAxes) -> int:
    """Total ways a var is split: product extent over every entry."""
    size = 1
    for e in entries or ():
        size *= axis_extent(mesh_axes, e)
    return size


def duplicate_axis_problems(entries: Sequence) -> List[str]:
    """A mesh axis may appear at most once across a spec's entries —
    GSPMD cannot shard two dims (or one dim twice) over the same axis.
    Returns one problem string per reused axis."""
    seen: Dict[str, int] = {}
    problems = []
    for dim, entry in enumerate(entries or ()):
        for n in entry_names(entry):
            if n in seen:
                problems.append(
                    f"axis {n!r} used twice in one spec (dim "
                    f"{seen[n]} and dim {dim})")
            else:
                seen[n] = dim
    return problems


def validate_entries(entries: Sequence, shape: Sequence[int],
                     mesh_axes: MeshAxes,
                     spec_repr: Optional[str] = None) -> List[str]:
    """Problem strings for a spec against a shape+mesh; empty == fits."""
    problems = []
    entries = tuple(entries)
    if spec_repr is None:
        spec_repr = repr(entries)
    if len(entries) > len(shape):
        problems.append(
            f"spec {spec_repr} has {len(entries)} entries for rank-"
            f"{len(shape)} shape {tuple(shape)}")
    for dim, axis in enumerate(entries):
        if axis is None:
            continue
        names = entry_names(axis)
        for n in names:
            if n not in mesh_axes:
                problems.append(
                    f"axis {n!r} not in mesh axes {tuple(mesh_axes)}")
        if any(n not in mesh_axes for n in names):
            continue
        if dim < len(shape):
            size = axis_extent(mesh_axes, axis)
            if shape[dim] % size != 0:
                problems.append(
                    f"dim {dim} of size {shape[dim]} not divisible by "
                    f"{axis!r} extent {size}")
    return problems


def fit_entries(entries: Sequence, shape: Sequence[int],
                mesh_axes: MeshAxes) -> Tuple[Entries, List[str]]:
    """Clamp a spec to what the mesh+shape can actually carry: drop
    entries naming absent axes or not dividing their dim.  Returns
    (fitted entries, clamp reasons) — a non-empty second element means
    the requested layout degraded."""
    out = []
    clamps = []
    for dim, axis in enumerate(tuple(entries)):
        if axis is None or dim >= len(shape):
            out.append(None)
            continue
        names = entry_names(axis)
        missing = [n for n in names if n not in mesh_axes]
        if missing:
            clamps.append(
                f"dim {dim} entry {axis!r} dropped: axis "
                f"{missing[0]!r} absent from mesh axes "
                f"{tuple(mesh_axes)}")
            out.append(None)
            continue
        size = axis_extent(mesh_axes, axis)
        if shape[dim] % size == 0:
            out.append(axis)
        else:
            clamps.append(
                f"dim {dim} entry {axis!r} dropped: size "
                f"{shape[dim]} not divisible by extent {size}")
            out.append(None)
    return trim_entries(out), clamps


def annotation_entries(axes: Sequence[str], shape: Sequence[int],
                       mesh_axes: MeshAxes) -> Optional[Entries]:
    """ZeRO `_sharding_axes` annotation: dim 0 over the first annotated
    axis present in the mesh that divides it."""
    if not shape or len(shape) < 1 or shape[0] <= 1:
        return None
    for ax in axes:
        if ax in mesh_axes and shape[0] % int(mesh_axes[ax]) == 0:
            return (ax,)
    return None


def pattern_entries(name: str, shape: Sequence[int],
                    mesh_axes: MeshAxes,
                    fsdp_axis: str = FSDP_AXIS,
                    tp_axis: str = TP_AXIS) -> Entries:
    """Name-pattern rule table (SNIPPETS [1]): active only on meshes
    that carry an fsdp or tp axis."""
    fsdp, tp = fsdp_axis, tp_axis
    has_fsdp = fsdp in mesh_axes
    has_tp = tp in mesh_axes
    if not (has_fsdp or has_tp):
        return ()
    ndim = len(shape)
    if ndim == 0 or (ndim >= 1 and shape[0] <= 1 and ndim == 1):
        return ()
    if REPLICATED_PAT.search(name):
        return ()
    if ndim == 4:
        # conv kernels: replicated (spatial dims don't shard usefully
        # at these sizes; the batch dim carries the parallelism)
        return ()
    if ndim == 2:
        if EMBEDDING_PAT.search(name):
            # vocab dim over fsdp×tp when both divide; degrade to fsdp
            if has_fsdp and has_tp:
                fitted, _ = fit_entries(((fsdp, tp),), shape, mesh_axes)
                if fitted:
                    return fitted
            fitted, _ = fit_entries((fsdp if has_fsdp else tp,),
                                    shape, mesh_axes)
            return fitted
        # dense weights: row-split (dim 0) over fsdp, col-split (dim 1)
        # over tp — the qkv/ffn layout; the fit drops whichever doesn't
        # divide
        fitted, _ = fit_entries((fsdp if has_fsdp else None,
                                 tp if has_tp else None),
                                shape, mesh_axes)
        return fitted
    # rank-1 / rank-3+: dim-0 over fsdp when it divides
    if has_fsdp:
        fitted, _ = fit_entries((fsdp,), shape, mesh_axes)
        return fitted
    return ()


def resolve_entries(name: str, shape: Sequence[int],
                    mesh_axes: MeshAxes,
                    override: Optional[Sequence] = None,
                    annotation: Optional[Sequence[str]] = None,
                    fsdp_axis: str = FSDP_AXIS,
                    tp_axis: str = TP_AXIS) \
        -> Tuple[Entries, List[str]]:
    """Full registry resolution over plain data — the stdlib twin of
    `spec_layout.spec_for`.  Returns (fitted entries, clamp reasons);
    clamps are reported only for the EXPLICIT paths (override /
    annotation): pattern-rule degradation is by-design and silent."""
    shape = tuple(int(s) for s in (shape or ()))
    if override is not None:
        return fit_entries(tuple(override), shape, mesh_axes)
    clamps: List[str] = []
    if annotation:
        entries = annotation_entries(annotation, shape, mesh_axes)
        if entries is not None:
            return entries, []
        if shape and shape[0] > 1:
            # annotation didn't fit: report the degrade, then fall
            # through to the pattern rules (historical behavior)
            clamps.append(
                f"_sharding_axes {tuple(annotation)} dropped: no "
                f"annotated axis both present in mesh "
                f"{dict(mesh_axes)} and dividing dim 0 of {shape}")
    return pattern_entries(name, shape, mesh_axes,
                           fsdp_axis=fsdp_axis, tp_axis=tp_axis), clamps


def batch_entries(mesh_axes: MeshAxes,
                  nrows: Optional[int] = None,
                  data_axis: str = DATA_AXIS,
                  fsdp_axis: str = FSDP_AXIS) -> Entries:
    """Leading-(batch-)dim spec — the stdlib twin of `mesh.batch_spec`:
    sharded over "data" composed with "fsdp" when present, degrading to
    whatever subset divides `nrows`, else replicated.  `nrows=None`
    (symbolic batch) optimistically assumes the full composition
    divides — the runtime picks divisible batches on the happy path."""
    axes = [ax for ax in (data_axis, fsdp_axis) if ax in mesh_axes]
    while axes:
        size = 1
        for ax in axes:
            size *= int(mesh_axes[ax])
        if size > 1 and (nrows is None
                         or (nrows > 0 and nrows % size == 0)):
            return ((tuple(axes) if len(axes) > 1 else axes[0]),)
        axes.pop()
    return ()
