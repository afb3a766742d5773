"""The collective bucket's first rule (counterpart of
paddle_tpu/ops/collective_ops.py): c_allreduce_sum, which
DGCMomentumOptimizer appends.  In one process it is the identity, as the
reference's rule is outside a mesh.  Under a process group of more than
one it raises: the all-reduce comes with the parallel package and the
other 22 rules (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import torch

from .registry import first, register_op


def check_single_process(what: str) -> None:
    """Raise when a `torch.distributed` group of more than one is live:
    `what` would need its collective, which is not ported yet."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"{what} under a process group of {dist.get_world_size()} "
            f"waits for the collective ops (ROADMAP queue 1 item 10)")


@register_op("c_allreduce_sum")
def _c_allreduce_sum(ctx, op, ins):
    check_single_process("c_allreduce_sum")
    return {"Out": [first(ins, "X")]}
