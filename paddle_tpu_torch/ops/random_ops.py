"""Random rules (counterpart of paddle_tpu/ops/random_ops.py):
gaussian_random and uniform_random.

Each op draws from its own `torch.Generator` on the run's device, seeded
from its `seed` attr or from the step seed mixed with its op id
(`LowerCtx.generator`), so a run is deterministic in its seed.  The bits
are torch's, not JAX's: the same seed gives other values than the
reference, from the same distribution.
"""

from __future__ import annotations

import torch

from .registry import first, register_op, tdt


def _shape(op, ins):
    shape = first(ins, "ShapeTensor", op.attr("shape", []))
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return tuple(int(s) for s in shape)


@register_op("gaussian_random")
def _gaussian_random(ctx, op, ins):
    shape, dt = _shape(op, ins), tdt(op.attr("dtype", "float32"))
    if ctx.abstract:
        return {"Out": [torch.empty(shape, dtype=dt, device=ctx.device)]}
    x = torch.randn(shape, generator=ctx.generator(op), dtype=dt,
                    device=ctx.device)
    return {"Out": [x * op.attr("std", 1.0) + op.attr("mean", 0.0)]}


@register_op("uniform_random")
def _uniform_random(ctx, op, ins):
    shape, dt = _shape(op, ins), tdt(op.attr("dtype", "float32"))
    x = torch.empty(shape, dtype=dt, device=ctx.device)
    if not ctx.abstract:
        x.uniform_(op.attr("min", -1.0), op.attr("max", 1.0),
                   generator=ctx.generator(op))
    return {"Out": [x]}
