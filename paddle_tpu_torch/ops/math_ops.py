"""Math, elementwise, reduction and activation rules (counterpart of
paddle_tpu/ops/math_ops.py): the elementwise binary ops with Paddle's
axis broadcast, scale, sum, mean, the products (mul, matmul_v2, bmm,
dot, mv, addmm), the reductions, logsumexp, frobenius_norm, the unary
ops of the 2.x tensor API, pow, stanh, clip, cast, cumsum, cumprod,
kron, trace, logical_not, the isfinite/isinf/isnan tests, cholesky,
histogram, relu, sigmoid and softmax; then the rest of the reference
module: the comparisons and the logical ops, maximum / minimum, matmul
(v1), isfinite (v1), log_softmax, squared_l2_norm, p_norm,
clip_by_norm, dist, cross, and the activations.

Integer results keep Paddle's int64 where the reference, which runs
with 64-bit types off, gives int32; the values are the same."""

from __future__ import annotations

import torch

from .registry import first, register_op, tdt


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


def _floordiv(x, y):
    return torch.div(x, y, rounding_mode="floor")


register_op("elementwise_add")(_elementwise(torch.add))
register_op("elementwise_sub")(_elementwise(torch.sub))
register_op("elementwise_mul")(_elementwise(torch.mul))
register_op("elementwise_div")(_elementwise(torch.div))
register_op("elementwise_min")(_elementwise(torch.minimum))
register_op("elementwise_max")(_elementwise(torch.maximum))
register_op("elementwise_pow")(_elementwise(torch.pow))
# floored, as jnp.mod / jnp.floor_divide: the result takes y's sign
register_op("elementwise_mod")(_elementwise(torch.remainder))
register_op("elementwise_floordiv")(_elementwise(_floordiv))


@register_op("scale")
def _scale(ctx, op, ins):
    """math_ops.py:65-83; a `divide_by_axis_size` attr divides the scale
    by the size of the data axis's group, as the reference divides by
    its mesh axis (nothing with no group)."""
    x = first(ins, "X")
    scale = first(ins, "ScaleTensor", op.attr("scale", 1.0))
    bias = op.attr("bias", 0.0)
    if op.attr("divide_by_axis_size", None) is not None \
            and not ctx.abstract:
        from ..distributed import comm, parallel

        if parallel.is_initialized():
            scale = scale / comm.world(comm.group_for_ring(0))
    if isinstance(scale, torch.Tensor):
        scale = scale.to(x.dtype)
    elif not x.is_floating_point():
        # integers stay integers: the reference casts both to x's dtype
        scale, bias = int(scale), int(bias)
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


def _axes(op, x, key="dim", default=(0,)):
    """The reduced axes, non-negative; every axis under `reduce_all`."""
    if op.attr("reduce_all", False):
        return tuple(range(x.ndim))
    return tuple(int(a) if a >= 0 else int(a) + x.ndim
                 for a in op.attr(key, list(default)))


def _one_axis_at_a_time(fn):
    """A reduction that takes one dim (prod, any, all) over many: the
    highest axis first, so the lower ones keep their place."""
    def reduce(x, axes, keep):
        for a in sorted(axes, reverse=True):
            x = fn(x, a, keepdim=keep)
        return x

    return reduce


def _mean(x, axes, keep):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()  # jnp.mean of integers is a float mean
    return torch.mean(x, dim=axes, keepdim=keep)


def _reduce(fn):
    def lower(ctx, op, ins):
        x = first(ins, "X")
        return {"Out": [fn(x, _axes(op, x), op.attr("keep_dim", False))]}

    return lower


register_op("reduce_sum")(_reduce(
    lambda x, a, k: torch.sum(x, dim=a, keepdim=k)))
register_op("reduce_mean")(_reduce(_mean))
register_op("reduce_max")(_reduce(
    lambda x, a, k: torch.amax(x, dim=a, keepdim=k)))
register_op("reduce_min")(_reduce(
    lambda x, a, k: torch.amin(x, dim=a, keepdim=k)))
register_op("reduce_prod")(_reduce(_one_axis_at_a_time(torch.prod)))
register_op("reduce_any")(_reduce(_one_axis_at_a_time(torch.any)))
register_op("reduce_all")(_reduce(_one_axis_at_a_time(torch.all)))


@register_op("logsumexp")
def _logsumexp(ctx, op, ins):
    """math_ops.py:177-185: every axis under `reduce_all` or without an
    `axis` attr; an empty list reduces none."""
    x = first(ins, "X")
    axis = op.attr("axis", None)
    keep = op.attr("keepdim", False)
    if op.attr("reduce_all", False) or axis is None:
        axes = tuple(range(x.ndim))
    else:
        axes = tuple(int(a) for a in axis)
    if not axes and x.ndim:
        return {"Out": [x.clone()]}
    return {"Out": [torch.logsumexp(x, dim=axes, keepdim=keep)]}


@register_op("frobenius_norm")
def _frobenius_norm(ctx, op, ins):
    """sqrt(sum(x^2)) over the `dim` attr (math_ops.py:207-211).  The
    reference reads `dim` alone and ignores `reduce_all`: with
    reduce_all and a `dim` that leaves an axis out it reduces only
    `dim` (with `dim=[]`, none: paddle.norm(x) comes back as |x|).  The
    port raises there rather than differ (ROADMAP queue 3)."""
    x = first(ins, "X")
    dims = [int(a) if a >= 0 else int(a) + x.ndim
            for a in op.attr("dim", [-2, -1])]
    if op.attr("reduce_all", False) and set(dims) != set(range(x.ndim)):
        raise NotImplementedError(
            "frobenius_norm with reduce_all over a dim list that leaves "
            "an axis out: the reference ignores reduce_all and reduces "
            f"only dim={dims}")
    keep = op.attr("keep_dim", False)
    sq = torch.square(x)
    out = torch.sum(sq, dim=tuple(dims), keepdim=keep) if dims else sq
    return {"Out": [torch.sqrt(out)]}


def _unary(fn):
    def lower(ctx, op, ins):
        return {"Out": [fn(first(ins, "X"))]}

    return lower


register_op("relu")(_unary(torch.relu))
register_op("sigmoid")(_unary(torch.sigmoid))
register_op("tanh")(_unary(torch.tanh))
register_op("square")(_unary(torch.square))
for _name, _fn in [
        ("exp", torch.exp), ("expm1", torch.expm1), ("log", torch.log),
        ("log2", torch.log2), ("log10", torch.log10),
        ("log1p", torch.log1p), ("sqrt", torch.sqrt),
        ("rsqrt", torch.rsqrt), ("abs", torch.abs), ("ceil", torch.ceil),
        ("floor", torch.floor), ("round", torch.round),  # half to even
        ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
        ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
        ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("reciprocal", torch.reciprocal), ("sign", torch.sign),
        ("erf", torch.erf), ("logical_not", torch.logical_not),
        ("isfinite_v2", torch.isfinite), ("isinf_v2", torch.isinf),
        ("isnan_v2", torch.isnan)]:
    register_op(_name)(_unary(_fn))


@register_op("softmax")
def _softmax(ctx, op, ins):
    return {"Out": [torch.softmax(first(ins, "X"), dim=op.attr("axis", -1))]}


@register_op("matmul")
def _matmul(ctx, op, ins):
    """The v1 product (math_ops.py:100-111): `transpose_X` / `transpose_Y`
    on operands of more than one axis, then `alpha` when it is not 1."""
    x, y = first(ins, "X"), first(ins, "Y")
    if op.attr("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("matmul_v2")
def _matmul_v2(ctx, op, ins):
    """math_ops.py:100-107: bf16 operands accumulate in f32 and round
    once, as torch.matmul does."""
    x, y = first(ins, "X"), first(ins, "Y")
    if op.attr("trans_x", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if op.attr("trans_y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    return {"Out": [torch.matmul(x, y)]}


@register_op("bmm")
def _bmm(ctx, op, ins):
    return {"Out": [torch.matmul(first(ins, "X"), first(ins, "Y"))]}


@register_op("dot")
def _dot(ctx, op, ins):
    return {"Out": [torch.sum(first(ins, "X") * first(ins, "Y"), dim=-1)]}


@register_op("mv")
def _mv(ctx, op, ins):
    return {"Out": [torch.matmul(first(ins, "X"), first(ins, "Vec"))]}


@register_op("addmm")
def _addmm(ctx, op, ins):
    inp, x, y = first(ins, "Input"), first(ins, "X"), first(ins, "Y")
    return {"Out": [op.attr("Beta", 1.0) * inp
                    + op.attr("Alpha", 1.0) * torch.matmul(x, y)]}


@register_op("pow")
def _pow(ctx, op, ins):
    """x ** factor, the factor in x's dtype (math_ops.py:337-341)."""
    x = first(ins, "X")
    factor = first(ins, "FactorTensor", op.attr("factor", 1.0))
    factor = torch.as_tensor(factor, device=x.device).to(x.dtype)
    return {"Out": [torch.pow(x, factor)]}


@register_op("stanh")
def _stanh(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [op.attr("scale_b", 1.7159)
                    * torch.tanh(op.attr("scale_a", 0.67) * x)]}


@register_op("clip")
def _clip(ctx, op, ins):
    """Bounds from the Min / Max inputs, else the attrs."""
    x = first(ins, "X")
    lo = first(ins, "Min", op.attr("min", 0.0))
    hi = first(ins, "Max", op.attr("max", 0.0))
    return {"Out": [torch.clamp(x, lo, hi)]}


@register_op("cast")
def _cast(ctx, op, ins):
    return {"Out": [first(ins, "X").to(tdt(op.attr("out_dtype",
                                                   "float32")))]}


@register_op("cumsum")
def _cumsum(ctx, op, ins):
    """math_ops.py:378-392: `flatten` first; `reverse` sums from the end;
    `exclusive` takes x off the inclusive sum."""
    x = first(ins, "X")
    axis = op.attr("axis", -1)
    if op.attr("flatten", False):
        x, axis = x.reshape(-1), 0
    rev = op.attr("reverse", False)
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if op.attr("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    return {"Out": [out]}


@register_op("cumprod")
def _cumprod(ctx, op, ins):
    return {"Out": [torch.cumprod(first(ins, "X"), dim=op.attr("dim", -1))]}


@register_op("kron")
def _kron(ctx, op, ins):
    return {"Out": [torch.kron(first(ins, "X"), first(ins, "Y"))]}


@register_op("trace")
def _trace(ctx, op, ins):
    x = first(ins, "Input")
    d = torch.diagonal(x, offset=op.attr("offset", 0),
                       dim1=op.attr("axis1", 0), dim2=op.attr("axis2", 1))
    return {"Out": [torch.sum(d, dim=-1)]}


@register_op("cholesky")
def _cholesky(ctx, op, ins):
    """The lower factor of (x + x^T) / 2, as jnp.linalg.cholesky
    symmetrizes its input (so its gradient is symmetric too); the upper
    one is its transpose."""
    x = first(ins, "X")
    low = torch.linalg.cholesky((x + x.transpose(-1, -2)) / 2)
    return {"Out": [low.transpose(-1, -2) if op.attr("upper", False)
                    else low]}


@register_op("histogram")
def _histogram(ctx, op, ins):
    """math_ops.py:510-542: `bins` equal bins over [min, max]; with both
    0, over the data's range (computed on the device); an empty range
    widens to [v - 1, v + 1].  Values outside the range are dropped; the
    top edge falls in the last bin.  Counts are int64."""
    x = first(ins, "X").reshape(-1)
    bins = int(op.attr("bins", 100))
    mn, mx = float(op.attr("min", 0)), float(op.attr("max", 0))
    xf = x.float()
    if mn == 0 and mx == 0:
        lo, hi = torch.amin(xf), torch.amax(xf)
        same = hi <= lo
        lo, hi = torch.where(same, lo - 1.0, lo), torch.where(same, hi + 1.0,
                                                               hi)
    else:
        if mn == mx:
            mn, mx = mn - 1.0, mx + 1.0
        lo = torch.tensor(mn, dtype=torch.float32, device=x.device)
        hi = torch.tensor(mx, dtype=torch.float32, device=x.device)
    idx = torch.floor((xf - lo) / (hi - lo) * bins).to(torch.int64)
    idx = torch.clamp(idx, 0, bins - 1)
    inside = (xf >= lo) & (xf <= hi)
    counts = torch.zeros(bins + 1, dtype=torch.int64, device=x.device)
    counts.index_add_(0, torch.where(inside, idx, bins),
                      torch.ones_like(idx))
    return {"Out": [counts[:bins]]}


# -- comparisons, logical ops, maximum / minimum (math_ops.py:428-449) ---------

def _compare(fn):
    """x against y aligned by Paddle's `axis` broadcast."""
    def lower(ctx, op, ins):
        x, y = first(ins, "X"), first(ins, "Y")
        return {"Out": [fn(x, _bcast_y(x, y, op.attr("axis", -1)))]}

    return lower


for _name, _fn in [
        ("equal", torch.eq), ("not_equal", torch.ne),
        ("less_than", torch.lt), ("less_equal", torch.le),
        ("greater_than", torch.gt), ("greater_equal", torch.ge),
        ("logical_and", torch.logical_and),
        ("logical_or", torch.logical_or),
        ("logical_xor", torch.logical_xor),
        ("maximum", torch.maximum), ("minimum", torch.minimum)]:
    register_op(_name)(_compare(_fn))


@register_op("isfinite")
def _isfinite(ctx, op, ins):
    """The v1 test (math_ops.py:470-475): one bool, True when X holds an
    inf or a nan anywhere, as the reference computes it."""
    return {"Out": [torch.logical_not(torch.all(torch.isfinite(
        first(ins, "X"))))]}


# -- norms ------------------------------------------------------------------------

@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, op, ins):
    return {"Out": [torch.sum(torch.square(first(ins, "X")))]}


@register_op("p_norm")
def _p_norm(ctx, op, ins):
    """The vector p-norm along `axis` (math_ops.py:210-217)."""
    x = first(ins, "X")
    out = torch.linalg.vector_norm(x, ord=op.attr("porder", 2.0),
                                   dim=op.attr("axis", -1),
                                   keepdim=op.attr("keepdim", False))
    return {"Out": [out.to(x.dtype)]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, op, ins):
    """x * max_norm / |x|_2 where the norm passes max_norm (math_ops.py:
    367-373)."""
    x = first(ins, "X")
    max_norm = op.attr("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": [x * scale.to(x.dtype)]}


@register_op("dist")
def _dist(ctx, op, ins):
    """The p-norm of the flattened x - y (math_ops.py:478-484)."""
    x, y = first(ins, "X"), first(ins, "Y")
    return {"Out": [torch.linalg.vector_norm((x - y).reshape(-1),
                                             ord=op.attr("p", 2.0))]}


@register_op("cross")
def _cross(ctx, op, ins):
    """The cross product along `dim`; without one, along the first axis
    of size 3 (math_ops.py:487-498)."""
    x, y = first(ins, "X"), first(ins, "Y")
    dim = op.attr("dim", None)
    if dim is None:
        dim = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if dim is None:
            raise ValueError(f"cross: no dimension of size 3 in shape "
                             f"{tuple(x.shape)}; pass dim explicitly")
    return {"Out": [torch.linalg.cross(x, y, dim=int(dim))]}


@register_op("log_softmax")
def _log_softmax(ctx, op, ins):
    return {"Out": [torch.log_softmax(first(ins, "X"),
                                      dim=op.attr("axis", -1))]}


# -- activations (math_ops.py:237-341) ----------------------------------------------

def _softplus0(x):
    """jax.nn.softplus: log(1 + e^x) as logaddexp(x, 0), with no
    threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


for _name, _fn in [
        ("logsigmoid", torch.nn.functional.logsigmoid),
        ("tanh_shrink", lambda x: x - torch.tanh(x)),
        ("asinh", torch.asinh), ("acosh", torch.acosh),
        ("atanh", torch.atanh),
        ("softsign", lambda x: x / (1 + torch.abs(x))),
        ("silu", lambda x: x * torch.sigmoid(x)),
        ("mish", lambda x: x * torch.tanh(_softplus0(x)))]:
    register_op(_name)(_unary(_fn))


@register_op("gelu")
def _gelu(ctx, op, ins):
    return {"Out": [torch.nn.functional.gelu(
        first(ins, "X"),
        approximate="tanh" if op.attr("approximate", False) else "none")]}


@register_op("leaky_relu")
def _leaky_relu(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [torch.where(x >= 0, x, x * op.attr("alpha", 0.02))]}


@register_op("relu6")
def _relu6(ctx, op, ins):
    return {"Out": [torch.clamp(first(ins, "X"), 0.0,
                                op.attr("threshold", 6.0))]}


@register_op("elu")
def _elu(ctx, op, ins):
    """x where x > 0, else alpha (e^x - 1) (jax.nn.elu)."""
    x = first(ins, "X")
    neg = torch.where(x > 0, torch.zeros_like(x), x)
    return {"Out": [torch.where(x > 0, x, op.attr("alpha", 1.0)
                                * torch.expm1(neg))]}


@register_op("softplus")
def _softplus(ctx, op, ins):
    """x where beta x passes `threshold`, else log(1 + e^(beta x)) /
    beta."""
    x = first(ins, "X")
    beta = op.attr("beta", 1.0)
    return {"Out": [torch.where(x * beta > op.attr("threshold", 20.0), x,
                                _softplus0(x * beta) / beta)]}


@register_op("swish")
def _swish(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [x * torch.sigmoid(op.attr("beta", 1.0) * x)]}


@register_op("hard_sigmoid")
def _hard_sigmoid(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [torch.clamp(op.attr("slope", 0.2) * x
                                + op.attr("offset", 0.5), 0.0, 1.0)]}


@register_op("hard_swish")
def _hard_swish(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [x * torch.clamp(x + op.attr("offset", 3.0), 0.0,
                                    op.attr("threshold", 6.0))
                    / op.attr("scale", 6.0)]}


@register_op("hard_shrink")
def _hard_shrink(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [torch.where(torch.abs(x) > op.attr("threshold", 0.5), x,
                                torch.zeros_like(x))]}


@register_op("softshrink")
def _softshrink(ctx, op, ins):
    x = first(ins, "X")
    lam = op.attr("lambda", 0.5)
    return {"Out": [torch.where(x > lam, x - lam, torch.where(
        x < -lam, x + lam, torch.zeros_like(x)))]}
