"""Per-variable PartitionSpec registry (counterpart of
paddle_tpu/parallel/spec_layout.py): how each variable is laid out over
the `data x fsdp x tp` mesh, for the compiler's SPMD arm, ShardingOptimizer
and the tensor-parallel BERT step.

Resolution order, as the reference's:
  1. explicit per-var override (`register_spec`), always first;
  2. a `_sharding_axes` annotation left by fleet's ShardingOptimizer
     (ZeRO): dim 0 over the first annotated axis present in the mesh
     that divides it;
  3. name-pattern rules (only on a mesh with an `fsdp` or `tp` axis):
     embedding tables over fsdp x tp, 2-D weights row-split over fsdp
     and column-split over tp, conv / norm / bias / scalars replicated.

On a pure `{data: N}` mesh with no annotation every var resolves to
`P()`.  Optimizer accumulators are named `<param>_<acc>_<n>`
(`fc_0.w_0_moment1_0`), so the pattern rules give Adam's moments their
parameter's layout.  The rules live in `spec_rules.py`, the port's copy of
the reference's; this module adapts them to the port's `PartitionSpec`
and mesh.  An explicit spec the mesh cannot carry is clamped, counted
in the `spec_clamped` stat and logged once a name.

torch has no PartitionSpec: `PartitionSpec` (`P`) here is an immutable
tuple of entries, each None, an axis name or a tuple of names, whose
`tuple()` is the reference's for the same entries.  `placements` maps a
spec onto DTensor placements over the mesh's `DeviceMesh`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from . import spec_rules

DATA_AXIS = spec_rules.DATA_AXIS
FSDP_AXIS = spec_rules.FSDP_AXIS
TP_AXIS = spec_rules.TP_AXIS

logger = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a
    tuple of axis names (the first the major one).  Immutable; equal to
    another spec with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


@dataclass(frozen=True)
class SpecLayout:
    """Axis-name binding for the rule table: a custom layout renames the
    logical roles without touching the rules."""

    data_axis: str = DATA_AXIS
    fsdp_axis: str = FSDP_AXIS
    tp_axis: str = TP_AXIS


DEFAULT_LAYOUT = SpecLayout()

# explicit per-var overrides: name -> PartitionSpec, consulted first
_OVERRIDES: Dict[str, P] = {}

# var names whose clamped spec has been logged (once a name a process;
# the stat counts every clamp)
_CLAMP_LOGGED: Set[str] = set()


def register_spec(var_name: str, spec) -> None:
    """Explicit per-var override: `register_spec("w_qkv", P("fsdp",
    "tp"))`.  None clears one name."""
    if spec is None:
        _OVERRIDES.pop(var_name, None)
    else:
        _OVERRIDES[var_name] = spec if isinstance(spec, P) else P(*spec)
    _CLAMP_LOGGED.discard(var_name)


def clear_specs() -> None:
    _OVERRIDES.clear()
    _CLAMP_LOGGED.clear()


def registered_specs() -> Dict[str, P]:
    return dict(_OVERRIDES)


def mesh_axes_dict(mesh) -> Dict[str, int]:
    """`{axis_name: size}` of a mesh (or of such a dict): the
    spec_rules currency."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(n): int(mesh.shape[n]) for n in mesh.axis_names}


def validate_spec(spec, shape: Sequence[int], mesh) -> List[str]:
    """Problem strings for a spec against a shape and mesh; empty when it
    fits."""
    return spec_rules.validate_entries(
        tuple(spec), shape, mesh_axes_dict(mesh), spec_repr=str(spec))


def _note_clamps(name: str, clamps: Sequence[str], mesh) -> None:
    """Book one explicit spec's clamp: the `spec_clamped` stat a clamp,
    one log line a var name."""
    if not clamps:
        return
    from ..profiler import stat_add

    stat_add("spec_clamped", len(clamps))
    if name not in _CLAMP_LOGGED:
        _CLAMP_LOGGED.add(name)
        logger.warning("partition spec for %r clamped on mesh %s: %s",
                       name, mesh_axes_dict(mesh), "; ".join(clamps))


def spec_for(name: str, shape: Sequence[int], mesh, var=None,
             layout: SpecLayout = DEFAULT_LAYOUT) -> P:
    """The PartitionSpec of one variable: the override, else the
    `_sharding_axes` annotation of `var` (a framework Variable), else
    the name patterns.  The spec returned always fits the mesh and
    shape."""
    shape = tuple(int(s) for s in (shape or ()))
    axes = getattr(var, "_sharding_axes", None) if var is not None else None
    entries, clamps = spec_rules.resolve_entries(
        name, shape, mesh_axes_dict(mesh),
        override=(tuple(_OVERRIDES[name]) if name in _OVERRIDES else None),
        annotation=tuple(axes) if axes else None,
        fsdp_axis=layout.fsdp_axis, tp_axis=layout.tp_axis)
    _note_clamps(name, clamps, mesh)
    return P(*entries)


def spec_to_json(spec) -> Optional[list]:
    """PartitionSpec -> a JSON-able list (entries None | str | [str...]);
    None for no spec."""
    if spec is None:
        return None
    return [list(e) if isinstance(e, (tuple, list)) else e
            for e in tuple(spec)]


def spec_from_json(doc) -> P:
    if not doc:
        return P()
    return P(*[tuple(e) if isinstance(e, list) else e for e in doc])


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` over `mesh`, one a mesh dim in the
    mesh's axis order: `Shard(d)` where the axis splits tensor dim d,
    else `Replicate()`.  DTensor splits a dim sharded over several mesh
    dims in mesh-dim order, so a tuple entry must name its axes in the
    mesh's order (the reference's major-to-minor order of that entry)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    where: Dict[str, int] = {}
    for dim, entry in enumerate(tuple(spec)):
        axes = spec_rules.entry_names(entry)
        for n in axes:
            if n not in names:
                raise ValueError(f"spec {spec}: axis {n!r} is not an axis "
                                 f"of mesh {names}")
            where[n] = dim
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(
                f"spec {spec}: dim {dim} names {axes}, out of the mesh's "
                f"axis order {names}; DTensor would place its shards on "
                "other ranks than the spec")
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)
