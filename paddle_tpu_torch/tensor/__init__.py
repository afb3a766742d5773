"""The 2.x tensor API (counterpart of paddle_tpu/tensor/__init__.py):
creation, random, math, logic, manipulation, search, stat and linalg.

Every function takes and returns `torch.Tensor`s.  Those the reference
sends through `trace_op` run the port's registered op rule of the same
type (`_run`: `registry.forward_rule`, with `amp.auto_cast`'s lists
applied by op type, as the reference's tracer applies them), so the
static Executor and the eager API share one implementation of each op.
Those it writes over `jnp` are plain torch here.  Autograd is torch's.

Creation without a device puts the tensor on the current device (that
of `device.get_device()`: cuda unless set otherwise); every other
function works on its inputs' device, and a Python number given as an
operand lands there.  Float creation without a dtype uses the default
float type (`set_default_dtype`, float32 at first); `arange` and the
integer draws give int64.  Integer results are int64 where the
reference's come back int32 (it runs with 64-bit types off); the values
are the same.  Random draws use torch's generators, which `seed` seeds;
their values differ from the JAX package's, whose keys are its own.

Where a reference function ignores one of its arguments and the answer
would change, the port raises NotImplementedError rather than differ
(ROADMAP queue 3): `mode`'s `axis` and `keepdim`, `cumsum`'s and
`cumprod`'s `dtype`, `scale`'s `act`, `argmin` with no axis on a tensor
of more than one axis, `unique` along an axis, `unstack`'s `num`, and
`norm`'s Frobenius form over every axis.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import amp as _amp
from .. import device as _device
from ..fluid import core
from ..ops import registry as _registry

# the float type that float creation without a dtype resolves to
# (reference framework.py set_default_dtype)
_DEFAULT_DTYPE = ["float32"]


def _dt(dtype, default=None):
    return core.torch_dtype(dtype or default or _DEFAULT_DTYPE[0])


def _dev(place=None):
    return _device.resolve(place)


# -- one op rule, eagerly -----------------------------------------------------

class _EagerOp:
    """What a rule reads of its op: the type, the attrs, the declared
    output slots and an id."""

    id = 0

    def __init__(self, op_type, attrs, outputs):
        self.type = op_type
        self.attrs = attrs
        self.outputs = {s: [s] for s in outputs}

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _slot_list(v):
    if v is None:
        return []
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _as_tensor(v, dev):
    if v is None or isinstance(v, torch.Tensor):
        return v
    return to_tensor(v, place=dev)


def _run(op_type, ins, attrs=None, outputs=("Out",)):
    """Run the registered rule of `op_type` on `ins` (slot -> tensor, a
    list of them, numpy or a Python number) and `attrs`, as the
    reference's trace_op does (tracer.py:251-279).  Returns the rule's
    {slot: [tensors]}.  The rule runs on the first input tensor's
    device (the current device when there is none); under
    `amp.auto_cast`, each float32 input is cast as the lists say for
    `op_type`."""
    lists = {s: _slot_list(v) for s, v in ins.items()}
    dev = next((t.device for vs in lists.values() for t in vs
                if isinstance(t, torch.Tensor)), None)
    if dev is None:
        dev = _device.get_device()
    slots = {s: [_as_tensor(t, dev) for t in vs] for s, vs in lists.items()}
    if _amp.amp_state() is not None:
        slots = {s: list(_amp.cast_inputs(op_type, *vs))
                 for s, vs in slots.items()}
    op = _EagerOp(op_type, dict(attrs or {}), outputs)
    ctx = _registry.LowerCtx(device=dev)
    return _registry.forward_rule(op_type)(ctx, op, slots)


def _one(op_type, ins, attrs=None, slot="Out"):
    return _run(op_type, ins, attrs, (slot,))[slot][0]


def _axes(axis):
    return [axis] if isinstance(axis, int) else list(axis)


# -- creation -----------------------------------------------------------------

def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """data (numpy, a list, a scalar or a tensor) as a tensor on `place`
    (default: the current device).  Python floats take the default
    float type and arrays keep their dtype, as in the reference;
    `stop_gradient=False` makes a leaf that requires grad."""
    if isinstance(data, torch.Tensor):
        out = data.detach().to(_dev(place))
    else:
        arr = np.asarray(data)
        if dtype is None and not hasattr(data, "dtype") \
                and arr.dtype.kind == "f":
            dtype = _DEFAULT_DTYPE[0]
            if dtype == "float32":
                arr = arr.astype(np.float32)
        out = torch.as_tensor(arr, device=_dev(place))
    if dtype is not None:
        out = out.to(_dt(dtype))
    if not stop_gradient:
        out = out.clone().requires_grad_(True)
    return out


def zeros(shape, dtype=None, name=None):
    return torch.zeros(list(shape), dtype=_dt(dtype), device=_dev())


def ones(shape, dtype=None, name=None):
    return torch.ones(list(shape), dtype=_dt(dtype), device=_dev())


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(list(shape), float(fill_value), dtype=_dt(dtype),
                      device=_dev())


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=None if dtype is None else _dt(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=None if dtype is None else _dt(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, float(fill_value),
                           dtype=None if dtype is None else _dt(dtype))


def arange(start=0, end=None, step=1, dtype="int64", name=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dt(dtype), device=_dev())


def linspace(start, stop, num, dtype="float32", name=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=_dev())


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    return torch.eye(num_rows, num_columns or num_rows, dtype=_dt(dtype),
                     device=_dev())


def diag(x, offset=0, padding_value=0, name=None):
    return _one("diag_v2", {"X": x},
                {"offset": offset, "padding_value": padding_value})


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def assign(x, output=None):
    """A copy of x (numpy or a list too); with `output`, written into it
    (outside autograd, as the reference's set_value) and returned."""
    out = _one("assign", {"X": x}).clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return assign(x)


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def tril(x, diagonal=0, name=None):
    return _one("tril_triu", {"X": x}, {"diagonal": diagonal, "lower": True})


def triu(x, diagonal=0, name=None):
    return _one("tril_triu", {"X": x}, {"diagonal": diagonal,
                                        "lower": False})


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return _run("meshgrid", {"X": list(args)})["Out"]


# -- random -------------------------------------------------------------------

def rand(shape, dtype="float32", name=None):
    return torch.rand(list(shape), dtype=_dt(dtype), device=_dev())


def randn(shape, dtype="float32", name=None):
    return torch.randn(list(shape), dtype=_dt(dtype), device=_dev())


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    gen = None
    if seed:
        gen = torch.Generator(device=_dev()).manual_seed(int(seed))
    out = torch.empty(list(shape), dtype=_dt(dtype), device=_dev())
    return out.uniform_(float(min), float(max), generator=gen)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    out = torch.empty(list(shape), dtype=torch.float32, device=_dev())
    return out.normal_(float(mean), float(std))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, list(shape), dtype=_dt(dtype),
                         device=_dev())


def randperm(n, dtype="int64", name=None):
    return torch.randperm(n, dtype=_dt(dtype), device=_dev())


def bernoulli(x, name=None):
    """1 with probability x, else 0, in x's dtype."""
    return torch.bernoulli(x)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category ids (int64) drawn from each row's weights."""
    return torch.multinomial(x, num_samples, replacement)


def seed(value):
    """Seed torch's generators (every device's), which the draws above
    and layers made without a generator of their own use."""
    torch.manual_seed(int(value))


# -- math ---------------------------------------------------------------------

def _binop(op_type):
    def fn(x, y, name=None):
        return _one(op_type, {"X": x, "Y": y})

    fn.__name__ = op_type
    return fn


add = _binop("elementwise_add")
subtract = _binop("elementwise_sub")
multiply = _binop("elementwise_mul")
divide = _binop("elementwise_div")
remainder = mod = floor_mod = _binop("elementwise_mod")  # floored
floor_divide = _binop("elementwise_floordiv")
minimum = _binop("elementwise_min")
maximum = _binop("elementwise_max")
pow_ = _binop("elementwise_pow")


def pow(x, y, name=None):  # noqa: A001 - Paddle's name
    if isinstance(y, (int, float)):
        return _one("pow", {"X": x}, {"factor": float(y)})
    return pow_(x, y)


def _unop(op_type):
    def fn(x, name=None):
        return _one(op_type, {"X": x})

    fn.__name__ = op_type
    return fn


for _name in ["exp", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
              "abs", "ceil", "floor", "round", "sin", "cos", "tan", "asin",
              "acos", "atan", "sinh", "cosh", "tanh", "reciprocal", "square",
              "sign", "erf", "expm1"]:
    globals()[_name] = _unop(_name)


def _make_reduce(op_type):
    def fn(x, axis=None, keepdim=False, name=None):
        if axis is None:
            attrs = {"dim": [], "keep_dim": keepdim, "reduce_all": True}
        else:
            attrs = {"dim": _axes(axis), "keep_dim": keepdim,
                     "reduce_all": False}
        return _one(op_type, {"X": x}, attrs)

    fn.__name__ = op_type
    return fn


sum = _make_reduce("reduce_sum")  # noqa: A001 - Paddle's names
mean = _make_reduce("reduce_mean")
max = _make_reduce("reduce_max")  # noqa: A001
min = _make_reduce("reduce_min")  # noqa: A001
prod = _make_reduce("reduce_prod")
any = _make_reduce("reduce_any")  # noqa: A001
all = _make_reduce("reduce_all")  # noqa: A001


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(a % x.ndim if x.ndim else a for a in _axes(axis))


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(x, dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(x, dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def median(x, axis=None, keepdim=False, name=None):
    """numpy's median (jnp.median's): over the given axes, the middle
    value, or the mean of the two middle ones for an even count;
    integers give float32."""
    if not x.is_floating_point():
        x = x.float()
    dims = _dims(x, axis)
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(*rest, *dims).reshape(
        *[x.shape[d] for d in rest], -1)
    srt = torch.sort(moved, dim=-1).values
    n = srt.shape[-1]
    out = (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5
    if keepdim:
        out = out.reshape([1 if d in dims else s
                           for d, s in enumerate(x.shape)])
    return out


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _one("logsumexp", {"X": x},
                {"axis": [] if axis is None else _axes(axis),
                 "keepdim": keepdim, "reduce_all": axis is None})


def clip(x, min=None, max=None, name=None):  # noqa: A002
    lo = -3.4e38 if min is None else float(min)
    hi = 3.4e38 if max is None else float(max)
    return _one("clip", {"X": x}, {"min": lo, "max": hi})


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _one("matmul_v2", {"X": x, "Y": y},
                {"trans_x": transpose_x, "trans_y": transpose_y})


def mm(input, mat2, name=None):  # noqa: A002
    return _one("matmul_v2", {"X": input, "Y": mat2})


def bmm(x, y, name=None):
    return _one("bmm", {"X": x, "Y": y})


def dot(x, y, name=None):
    return _one("dot", {"X": x, "Y": y})


def mv(x, vec, name=None):
    return _one("mv", {"X": x, "Vec": vec})


def t(x, name=None):
    return transpose(x, list(range(x.ndim))[::-1])


def kron(x, y, name=None):
    return _one("kron", {"X": x, "Y": y})


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return _one("addmm", {"Input": input, "X": x, "Y": y},
                {"Beta": beta, "Alpha": alpha})


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _one("trace", {"Input": x},
                {"offset": offset, "axis1": axis1, "axis2": axis2})


def _no_cast(fn, x, dtype):
    if dtype is not None and core.convert_dtype(dtype) != \
            core.convert_dtype(x.dtype):
        raise NotImplementedError(
            f"{fn} with dtype={dtype} on a {x.dtype} tensor: the reference "
            "ignores dtype")


def cumsum(x, axis=None, dtype=None, name=None):
    """The running sum along `axis` (of the flattened x without one).
    The reference ignores `dtype`; the port raises where it would cast."""
    _no_cast("cumsum", x, dtype)
    return _one("cumsum", {"X": x}, {"axis": -1 if axis is None else axis,
                                     "flatten": axis is None})


def cumprod(x, dim=None, dtype=None, name=None):
    """The running product along `dim` (0 without one).  The reference
    ignores `dtype`; the port raises where it would cast."""
    _no_cast("cumprod", x, dtype)
    return _one("cumprod", {"X": x}, {"dim": dim if dim is not None else 0})


def cross(x, y, axis=None, name=None):
    """The cross product along `axis` (the last axis without one, as
    the reference's jnp.cross)."""
    return torch.linalg.cross(x, y, dim=-1 if axis is None else axis)


def multiply_no_nan(x, y):
    return torch.where(y == 0, 0.0, x * y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """x * scale + bias (or (x + bias) * scale).  The reference ignores
    `act`; the port raises when one is given."""
    if act is not None:
        raise NotImplementedError("scale(act=...): the reference ignores "
                                  "act")
    return _one("scale", {"X": x}, {"scale": float(scale),
                                    "bias": float(bias),
                                    "bias_after_scale": bias_after_scale})


def increment(x, value=1.0, name=None):
    return _one("increment", {"X": x}, {"step": float(value)})


def isnan(x, name=None):
    return _one("isnan_v2", {"X": x})


def isinf(x, name=None):
    return _one("isinf_v2", {"X": x})


def isfinite(x, name=None):
    return _one("isfinite_v2", {"X": x})


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The Frobenius norm over every axis goes through the
    frobenius_norm rule, which raises (the reference's rule reduces no
    axis there and returns |x|); any other form is numpy's
    `linalg.norm` (a matrix norm for a 2-D x with a numeric `p`), as
    the reference's."""
    if p == "fro" and axis is None:
        return _one("frobenius_norm", {"X": x},
                    {"dim": [], "keep_dim": keepdim, "reduce_all": True})
    return torch.linalg.norm(x, ord=None if p == "fro" else p,
                             dim=axis if axis is None or isinstance(
                                 axis, int) else tuple(axis),
                             keepdim=keepdim)


def dist(x, y, p=2, name=None):
    """The p-norm of the flattened x - y."""
    return torch.linalg.vector_norm((x - y).reshape(-1), ord=p)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _one("stanh", {"X": x}, {"scale_a": scale_a, "scale_b": scale_b})


# -- logic --------------------------------------------------------------------

def _cmp(torch_fn):
    def fn(x, y, name=None):
        return torch_fn(x, y)

    fn.__name__ = torch_fn.__name__
    return fn


equal = _cmp(torch.eq)
not_equal = _cmp(torch.ne)
greater_than = _cmp(torch.gt)
greater_equal = _cmp(torch.ge)
less_than = _cmp(torch.lt)
less_equal = _cmp(torch.le)
logical_and = _cmp(torch.logical_and)
logical_or = _cmp(torch.logical_or)
logical_xor = _cmp(torch.logical_xor)


def logical_not(x, name=None):
    return _one("logical_not", {"X": x})


def equal_all(x, y, name=None):
    """True when the shapes and every element agree (a 0-d bool)."""
    if tuple(x.shape) != tuple(y.shape):
        return torch.tensor(False, device=x.device)
    return torch.all(x == y)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return torch.all(torch.isclose(x, y, rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


# -- manipulation -------------------------------------------------------------

def reshape(x, shape, name=None):
    return _one("reshape2", {"X": x}, {"shape": [int(s) for s in shape]})


def transpose(x, perm, name=None):
    return _one("transpose2", {"X": x}, {"axis": list(perm)})


def concat(x, axis=0, name=None):
    return _one("concat", {"X": list(x)}, {"axis": axis})


def stack(x, axis=0, name=None):
    return _one("stack", {"X": list(x)}, {"axis": axis}, slot="Y")


def unstack(x, axis=0, num=None, name=None):
    """The slices along `axis`.  The reference ignores `num`; the port
    raises when it is not that axis's size."""
    if num is not None and num != x.shape[axis]:
        raise NotImplementedError(
            f"unstack(num={num}) of an axis of size {x.shape[axis]}: the "
            "reference ignores num")
    return _run("unstack", {"X": x}, {"axis": axis, "num": x.shape[axis]},
                ("Y",))["Y"]


def split(x, num_or_sections, axis=0, name=None):
    attrs = {"axis": axis}
    if isinstance(num_or_sections, int):
        attrs["num"] = num_or_sections
    else:
        attrs["sections"] = list(num_or_sections)
    return _run("split", {"X": x}, attrs)["Out"]


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def squeeze(x, axis=None, name=None):
    axes = [] if axis is None else _axes(axis)
    return _one("squeeze2", {"X": x}, {"axes": axes})


def unsqueeze(x, axis, name=None):
    return _one("unsqueeze2", {"X": x}, {"axes": _axes(axis)})


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _one("flatten_contiguous_range", {"X": x},
                {"start_axis": start_axis, "stop_axis": stop_axis})


def gather(x, index, axis=None, name=None):
    return _one("gather", {"X": x, "Index": index},
                {"axis": axis if axis is not None else 0})


def gather_nd(x, index, name=None):
    return _one("gather_nd", {"X": x, "Index": index})


def scatter(x, index, updates, overwrite=True, name=None):
    return _one("scatter", {"X": x, "Ids": index, "Updates": updates},
                {"overwrite": overwrite})


def scatter_nd_add(x, index, updates, name=None):
    return _one("scatter_nd_add", {"X": x, "Index": index,
                                   "Updates": updates})


def scatter_nd(index, updates, shape, name=None):
    """Zeros of `shape` with `updates` added at `index`'s coordinates."""
    z = torch.zeros(tuple(shape), dtype=updates.dtype,
                    device=updates.device)
    return z.index_put(tuple(index.long().movedim(-1, 0)), updates,
                       accumulate=True)


def index_select(x, index, axis=0, name=None):
    return _one("index_select", {"X": x, "Index": index}, {"dim": axis})


def index_sample(x, index):
    return _one("index_sample", {"X": x, "Index": index})


def masked_select(x, mask, name=None):
    """The elements where `mask` holds, flattened (a dynamic size: one
    host sync)."""
    return x[mask]


def where(condition, x=None, y=None, name=None):
    return _one("where", {"Condition": condition, "X": x, "Y": y})


def nonzero(x, as_tuple=False):
    """(N, ndim) int64 coordinates of the non-zero elements (one host
    sync), or one column each with `as_tuple`."""
    out = torch.nonzero(x)
    if as_tuple:
        return tuple(out[:, i] for i in range(x.ndim))
    return out


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Without an optional output, the unique rule (its static-shape
    form: sorted values padded to x's size); with any, numpy's
    `np.unique` on the host, whose order and counts the reference's
    eager path returns (one host read)."""
    if not (return_index or return_inverse or return_counts):
        return _one("unique", {"X": x},
                    {"axis": [] if axis is None else [axis]})
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    dev = x.device if isinstance(x, torch.Tensor) else _dev()
    vals, idx, inv, cnt = np.unique(arr, return_index=True,
                                    return_inverse=True, return_counts=True,
                                    axis=axis)
    result = [torch.as_tensor(vals, device=dev)]
    for want, a in ((return_index, idx), (return_inverse, inv),
                    (return_counts, cnt)):
        if want:
            result.append(torch.as_tensor(a, device=dev).to(_dt(dtype)))
    return tuple(result)


def flip(x, axis, name=None):
    return _one("flip", {"X": x}, {"axis": _axes(axis)})


def roll(x, shifts, axis=None, name=None):
    return _one("roll", {"X": x}, {"shifts": _axes(shifts),
                                   "axis": [] if axis is None
                                   else _axes(axis)})


def tile(x, repeat_times, name=None):
    return _one("tile", {"X": x}, {"repeat_times": list(repeat_times)})


def expand(x, shape, name=None):
    return _one("expand_v2", {"X": x}, {"shape": [int(s) for s in shape]})


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return _one("expand_as_v2", {"X": x}, {"target_shape": list(y.shape)})


def cast(x, dtype):
    return _one("cast", {"X": x}, {"out_dtype": core.convert_dtype(dtype)})


def slice(input, axes, starts, ends):  # noqa: A001,A002 - Paddle's names
    return _one("slice", {"Input": input},
                {"axes": list(axes), "starts": [int(s) for s in starts],
                 "ends": [int(e) for e in ends]})


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _one("strided_slice", {"Input": x},
                {"axes": list(axes), "starts": [int(s) for s in starts],
                 "ends": [int(e) for e in ends],
                 "strides": [int(s) for s in strides]})


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    """An index's place inside shard `shard_id` of `nshards` equal
    shards of `index_num`, or `ignore_value` outside it."""
    size = (index_num + nshards - 1) // nshards
    shard = torch.div(input, size, rounding_mode="floor")
    return torch.where(shard == shard_id, torch.remainder(input, size),
                       ignore_value)


def unbind(input, axis=0):  # noqa: A002
    return _run("unbind", {"X": input}, {"axis": axis})["Out"]


def multiplex(inputs, index, name=None):
    return _one("multiplex", {"X": list(inputs), "Ids": index})


# -- search -------------------------------------------------------------------

def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _one("arg_max", {"X": x},
                {"axis": axis if axis is not None else -1,
                 "keepdims": keepdim, "flatten": axis is None,
                 "dtype": dtype})


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _one("arg_min", {"X": x},
                {"axis": axis if axis is not None else -1,
                 "keepdims": keepdim, "flatten": axis is None,
                 "dtype": dtype})


def argsort(x, axis=-1, descending=False, name=None):
    return _run("argsort", {"X": x}, {"axis": axis,
                                      "descending": descending},
                ("Out", "Indices"))["Indices"][0]


def sort(x, axis=-1, descending=False, name=None):
    return _run("argsort", {"X": x}, {"axis": axis,
                                      "descending": descending},
                ("Out", "Indices"))["Out"][0]


def topk(x, k, axis=None, largest=True, sorted=True,  # noqa: A002
         name=None):
    outs = _run("top_k_v2", {"X": x},
                {"k": k, "axis": axis if axis is not None else -1,
                 "largest": largest, "sorted": sorted},
                ("Out", "Indices"))
    return outs["Out"][0], outs["Indices"][0]


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value (the smallest among equally frequent
    ones), as the reference returns it: of the whole tensor, without
    its index.  The reference ignores `axis` and `keepdim`, which gives
    the answer along the axis only for a 1-D x without keepdim; the
    port raises for the others rather than differ."""
    if x.ndim > 1 or keepdim:
        raise NotImplementedError(
            "mode along an axis of a tensor of more than one axis, or "
            "with keepdim: the reference ignores axis and keepdim")
    vals, counts = torch.unique(x.reshape(-1), return_counts=True)
    return vals[torch.argmax(counts)]


def cholesky(x, upper=False, name=None):
    return _one("cholesky", {"X": x}, {"upper": upper})


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    return _one("histogram", {"X": input}, {"bins": bins, "min": min,
                                            "max": max})


# -- the 2.x top-level tail (reference python/paddle/__init__.py) -------------

def add_n(inputs, name=None):
    """The sum of a list of tensors (a tensor alone comes back)."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for x in inputs[1:]:
        out = _one("elementwise_add", {"X": out, "Y": x})
    return out


def addcmul(input, tensor1, tensor2, value=1.0, name=None):  # noqa: A002
    return input + value * tensor1 * tensor2


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


def has_inf(x, name=None):
    return torch.any(torch.isinf(x))


def has_nan(x, name=None):
    return torch.any(torch.isnan(x))


def inverse(x, name=None):
    return torch.linalg.inv(x)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def rank(input):  # noqa: A002
    return torch.tensor(input.ndim, dtype=torch.int32, device=input.device)


def shape(input):  # noqa: A002
    """The shape as an int32 tensor on the input's device."""
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def set_default_dtype(d):
    """The float type of float creation without a dtype: float16,
    bfloat16, float32 or float64."""
    name = core.convert_dtype(d)
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise TypeError(f"set_default_dtype only accepts float types, got "
                        f"{d}")
    _DEFAULT_DTYPE[0] = name


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor printing (torch's repr) options, by Paddle's names."""
    kw = {k: v for k, v in dict(precision=precision, threshold=threshold,
                                edgeitems=edgeitems, sci_mode=sci_mode,
                                linewidth=linewidth).items()
          if v is not None}
    torch.set_printoptions(**kw)


def get_tensor_from_selected_rows(x, name=None):
    """The port's gradients are dense: a tensor passes through, anything
    else raises."""
    if isinstance(x, torch.Tensor):
        return x
    raise TypeError("get_tensor_from_selected_rows: the port has no "
                    f"SelectedRows; got {type(x).__name__}")


__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("annotations", "np", "torch", "core")]
