"""Op semantic versions (copy of paddle_tpu/fluid/op_version_registry.py).

Programs serialize an `op_version_map` of the ops they use; loading one
compares it with this registry: newer than the runtime raises, older
warns with the change notes in between.  The registered changes are the
reference's, so a Program's JSON is the same from either package.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

_REGISTRY: Dict[str, List[Tuple[int, str]]] = {}


def register_op_version(op_type: str, version: int, note: str = ""):
    """Record that `op_type` changed at `version` (monotonic per op)."""
    entries = _REGISTRY.setdefault(op_type, [])
    if entries and version <= entries[-1][0]:
        raise ValueError(
            f"op_version_registry: {op_type} version {version} is not "
            f"greater than the last registered {entries[-1][0]}")
    entries.append((version, note))


def op_version(op_type: str) -> int:
    """Current semantic version of an op (1 = never bumped)."""
    entries = _REGISTRY.get(op_type)
    return entries[-1][0] if entries else 1


def version_map(op_types) -> Dict[str, int]:
    """{op_type: version} for `op_types`."""
    return {t: op_version(t) for t in sorted(op_types)}


def change_notes(op_type: str) -> List[Tuple[int, str]]:
    return list(_REGISTRY.get(op_type, []))


def check_compatibility(saved_map: Dict[str, int]):
    """Raise on an op saved at a newer version than this runtime's; warn
    on an older one."""
    problems, notes = [], []
    for op_type, saved_v in (saved_map or {}).items():
        cur = op_version(op_type)
        if saved_v > cur:
            problems.append(f"{op_type}: saved v{saved_v} > runtime "
                            f"v{cur}")
        elif saved_v < cur:
            changes = [f"v{v}: {n}" for v, n in change_notes(op_type)
                       if v > saved_v]
            notes.append(f"{op_type}: v{saved_v} -> v{cur} "
                         f"({'; '.join(changes) or 'no notes'})")
    if problems:
        raise RuntimeError(
            "program was saved by a NEWER framework: " + "; ".join(problems))
    if notes:
        warnings.warn(
            "program uses older op semantics; behavior may have "
            "changed: " + "; ".join(notes), UserWarning, stacklevel=2)


register_op_version(
    "softmax_with_cross_entropy", 2,
    "ignore_index/weighted mean follow sum(w*l)/sum(w) semantics (r3)")
register_op_version(
    "recv_v2", 2,
    "unpaired recv raises instead of returning zeros (r3)")
register_op_version(
    "beam_search", 2, "honors is_accumulated (r3)")
