"""Math, elementwise, reduction and activation rules (counterpart of
paddle_tpu/ops/math_ops.py): elementwise_add/_sub with Paddle's axis
broadcast, scale, sum, mean, mul, reduce_mean, relu, sigmoid, tanh,
square and softmax."""

from __future__ import annotations

import torch

from .registry import first, register_op


def _bcast_y(x, y, axis):
    """Paddle elementwise broadcast (math_ops.py:30-43): align y's shape to
    x starting at `axis`; -1 is right-aligned numpy broadcasting.  Trailing
    1-dims of y past x's rank at that alignment are stripped first."""
    if axis == -1:
        return y
    axis = axis if axis >= 0 else x.ndim - y.ndim
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and axis + len(yshape) > x.ndim:
        yshape.pop()
    new_shape = [1] * axis + yshape + [1] * (x.ndim - axis - len(yshape))
    return y.reshape(new_shape)


def _elementwise(fn):
    def lower(ctx, op, ins):
        x, y = first(ins, "X"), first(ins, "Y")
        return {"Out": [fn(x, _bcast_y(x, y, op.attr("axis", -1)))]}

    return lower


register_op("elementwise_add")(_elementwise(torch.add))
register_op("elementwise_sub")(_elementwise(torch.sub))


@register_op("scale")
def _scale(ctx, op, ins):
    """math_ops.py:65-83 (the data-parallel `divide_by_axis_size` attr
    waits for the collective ops)."""
    x = first(ins, "X")
    scale = first(ins, "ScaleTensor", op.attr("scale", 1.0))
    if isinstance(scale, torch.Tensor):
        scale = scale.to(x.dtype)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("sum")
def _sum(ctx, op, ins):
    xs = [v for v in ins.get("X", []) if v is not None]
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    return {"Out": [out]}


@register_op("mean")
def _mean(ctx, op, ins):
    return {"Out": [torch.mean(first(ins, "X"))]}


def _prod(t):
    p = 1
    for v in t:
        p *= int(v)
    return p


@register_op("mul")
def _mul(ctx, op, ins):
    """x flattened to 2-D at x_num_col_dims, y at y_num_col_dims, one
    matmul, the result reshaped to x.shape[:xn] + y.shape[yn:]
    (math_ops.py:124-133)."""
    x, y = first(ins, "X"), first(ins, "Y")
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    xm = x.reshape((-1, _prod(x.shape[xn:])))
    ym = y.reshape((_prod(y.shape[:yn]), -1))
    out = torch.matmul(xm, ym)
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


@register_op("reduce_mean")
def _reduce_mean(ctx, op, ins):
    x = first(ins, "X")
    keep = op.attr("keep_dim", False)
    if op.attr("reduce_all", False):
        axis = tuple(range(x.ndim))
    else:
        axis = tuple(int(a) if a >= 0 else int(a) + x.ndim
                     for a in op.attr("dim", [0]))
    return {"Out": [torch.mean(x, dim=axis, keepdim=keep)]}


def _unary(fn):
    def lower(ctx, op, ins):
        return {"Out": [fn(first(ins, "X"))]}

    return lower


register_op("relu")(_unary(torch.relu))
register_op("sigmoid")(_unary(torch.sigmoid))
register_op("tanh")(_unary(torch.tanh))
register_op("square")(_unary(torch.square))


@register_op("softmax")
def _softmax(ctx, op, ins):
    return {"Out": [torch.softmax(first(ins, "X"), dim=op.attr("axis", -1))]}
