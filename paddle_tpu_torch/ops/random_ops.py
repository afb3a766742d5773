"""Random rules (counterpart of paddle_tpu/ops/random_ops.py):
gaussian_random, uniform_random, uniform_random_batch_size_like,
truncated_gaussian_random, randint, randperm, bernoulli, multinomial, and
the deterministic shuffle_channel.

Each op draws from its own `torch.Generator` on the run's device, seeded
from its `seed` attr or from the step seed mixed with its op id
(`LowerCtx.generator`), so a run is deterministic in its seed.  The bits
are torch's, not JAX's: the same seed gives other values than the
reference, from the same distribution.
"""

from __future__ import annotations

import math

import torch

from .registry import first, register_op, tdt


def _out(ctx, shape, dt):
    return torch.empty(shape, dtype=dt, device=ctx.device)


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


@register_op("uniform_random_batch_size_like")
def _uniform_random_bsl(ctx, op, ins):
    """random_ops.py:51-59: `shape` with its output_dim_idx dim taken
    from Input's input_dim_idx dim."""
    shape = list(op.attr("shape", []))
    shape[op.attr("output_dim_idx", 0)] = \
        first(ins, "Input").shape[op.attr("input_dim_idx", 0)]
    x = _out(ctx, tuple(shape), tdt(op.attr("dtype", "float32")))
    if not ctx.abstract:
        x.uniform_(op.attr("min", -1.0), op.attr("max", 1.0),
                   generator=ctx.generator(op))
    return {"Out": [x]}


@register_op("truncated_gaussian_random")
def _truncated_gaussian(ctx, op, ins):
    """random_ops.py:62-69: a standard normal truncated to [-2, 2]
    (`jax.random.truncated_normal`'s bounds), then std and mean.  Drawn
    by the inverse CDF of a uniform over the truncated mass, in float64
    for float32 and narrower outputs."""
    shape = tuple(int(s) for s in op.attr("shape", []))
    dt = tdt(op.attr("dtype", "float32"))
    if ctx.abstract:
        return {"Out": [_out(ctx, shape, dt)]}
    wide = torch.float64 if dt != torch.float64 else dt
    u = torch.empty(shape, dtype=wide, device=ctx.device)
    u.uniform_(generator=ctx.generator(op))
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # Phi(-2) = 1 - Phi(2)
    z = torch.special.ndtri(lo + u * (1.0 - 2.0 * lo))
    z = torch.clamp(z, -2.0, 2.0)
    return {"Out": [(z * op.attr("std", 1.0)
                     + op.attr("mean", 0.0)).to(dt)]}


@register_op("randint")
def _randint(ctx, op, ins):
    """Integers uniform on [low, high)."""
    shape, dt = _shape(op, ins), tdt(op.attr("dtype", "int64"))
    if ctx.abstract:
        return {"Out": [_out(ctx, shape, dt)]}
    return {"Out": [torch.randint(op.attr("low", 0), op.attr("high", 1),
                                  shape, generator=ctx.generator(op),
                                  dtype=dt, device=ctx.device)]}


@register_op("randperm")
def _randperm(ctx, op, ins):
    n, dt = op.attr("n", 1), tdt(op.attr("dtype", "int64"))
    if ctx.abstract:
        return {"Out": [_out(ctx, (n,), dt)]}
    return {"Out": [torch.randperm(n, generator=ctx.generator(op),
                                   device=ctx.device).to(dt)]}


@register_op("bernoulli")
def _bernoulli(ctx, op, ins):
    """1 with probability X, in X's dtype."""
    x = first(ins, "X")
    if ctx.abstract:
        return {"Out": [torch.empty_like(x)]}
    return {"Out": [torch.bernoulli(x, generator=ctx.generator(op))]}


@register_op("multinomial")
def _multinomial(ctx, op, ins):
    """random_ops.py:95-110: num_samples category ids a row of X (the
    rows' weights need not sum to 1), with or without replacement;
    int64 ids (the reference narrows them to int32 with 64-bit types
    off)."""
    x = first(ins, "X")
    n = op.attr("num_samples", 1)
    shape = tuple(x.shape[:-1]) + (n,)
    if ctx.abstract:
        return {"Out": [_out(ctx, shape, torch.int64)]}
    w = torch.clamp(x, min=1e-30).reshape(-1, x.shape[-1])
    out = torch.multinomial(w, n, replacement=bool(
        op.attr("replacement", False)), generator=ctx.generator(op))
    return {"Out": [out.reshape(shape)]}


@register_op("shuffle_channel")
def _shuffle_channel(ctx, op, ins):
    """The channels of (N, C, H, W) regrouped: C as (group, C/group),
    transposed."""
    x = first(ins, "X")
    group = op.attr("group", 1)
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, group, c // group, h, w).transpose(1, 2)
                    .reshape(x.shape)]}
