"""Tensor creation and manipulation rules (counterpart of
paddle_tpu/ops/tensor_ops.py): fill_constant, assign, reshape2, concat and
top_k_v2."""

from __future__ import annotations

import torch

from .registry import first, register_op, tdt, xshape


def _int_list(v):
    """A shape given as a tensor input (read to the host) or a list."""
    return [int(s) for s in (v.tolist() if isinstance(v, torch.Tensor)
                             else v)]


@register_op("fill_constant")
def _fill_constant(ctx, op, ins):
    shape = _int_list(first(ins, "ShapeTensor", op.attr("shape", [])))
    value = op.attr("value", 0.0)
    sv = op.attr("str_value", "")
    if sv:
        value = float(sv)
    return {"Out": [torch.full(tuple(shape), value,
                               dtype=tdt(op.attr("dtype", "float32")),
                               device=ctx.device)]}


@register_op("assign")
def _assign(ctx, op, ins):
    return {"Out": [first(ins, "X")]}


@register_op("reshape2")
def _reshape2(ctx, op, ins):
    """A 0 in the target shape copies the input's dim there; one -1 is
    inferred."""
    x = first(ins, "X")
    shape = first(ins, "Shape", None)
    shape = _int_list(shape if shape is not None else op.attr("shape", []))
    out = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [x.reshape(out)], "XShape": [xshape(x)]}


@register_op("concat")
def _concat(ctx, op, ins):
    xs = [v for v in ins.get("X", []) if v is not None]
    axis = first(ins, "AxisTensor", op.attr("axis", 0))
    return {"Out": [torch.cat(xs, dim=int(axis))]}


@register_op("top_k_v2")
def _top_k(ctx, op, ins):
    """The k largest (or smallest) along `axis`, ties in index order, as
    `jax.lax.top_k` orders them: a stable sort keeps equal values in the
    order they came."""
    x = first(ins, "X")
    k = int(first(ins, "K", op.attr("k", 1)))
    axis = op.attr("axis", -1)
    largest = op.attr("largest", True)
    last = axis in (-1, x.ndim - 1)
    xm = x if last else x.movedim(axis, -1)
    vals, idx = torch.sort(xm, dim=-1, descending=largest, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if not last:
        vals, idx = vals.movedim(-1, axis), idx.movedim(-1, axis)
    return {"Out": [vals], "Indices": [idx]}
