"""Tensor creation, manipulation and search rules (counterpart of
paddle_tpu/ops/tensor_ops.py): fill_constant, fill_any_like, eye, range,
linspace, assign, increment, reshape2, transpose2, squeeze2, unsqueeze2,
flatten_contiguous_range, concat, stack, unstack, unbind, split, slice,
strided_slice, expand_v2, expand_as_v2, tile, flip, roll, tril_triu,
diag_v2, meshgrid, gather, gather_nd, index_select, index_sample,
scatter, scatter_nd_add, where, multiplex, arg_max, arg_min, argsort,
top_k_v2 and unique; then the rest of the reference module: the v1
shape ops (reshape, transpose, squeeze, unsqueeze, flatten, flatten2,
expand, top_k), broadcast_to, reverse, pad, pad2d, pad3d, one_hot,
one_hot_v2, masked_fill, masked_select, assign_value, shape, size,
fill_constant_batch_size_like, fill_zeros_like, inverse, shuffle_batch
and segment_pool.

Ties keep the reference's order: `jnp.argsort` and `lax.top_k` are
stable (equal values in index order), and so are the sorts here.
Integer outputs are int64 where the reference's come back int32."""

from __future__ import annotations

import numpy as np
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


@register_op("top_k")
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


def _with_xshape(op, x, out):
    """{"Out": [out]}, and the empty XShape when the op declares one."""
    outs = {"Out": [out]}
    if "XShape" in op.outputs:
        outs["XShape"] = [xshape(x)]
    return outs


def _axis(a, ndim):
    a = int(a)
    return a + ndim if a < 0 else a


@register_op("fill_any_like")
def _fill_any_like(ctx, op, ins):
    x = first(ins, "X")
    dt = op.attr("dtype", None)
    dt = x.dtype if dt in (None, -1) else tdt(dt)
    return {"Out": [torch.full(tuple(x.shape), op.attr("value", 0.0),
                               dtype=dt, device=x.device)]}


@register_op("eye")
def _eye(ctx, op, ins):
    n = int(op.attr("num_rows", 1))
    m = op.attr("num_columns", -1)
    m = n if m in (-1, None) else int(m)
    return {"Out": [torch.eye(n, m, dtype=tdt(op.attr("dtype", "float32")),
                              device=ctx.device)]}


def _scalar(v):
    """An attr, or a one-element input read to the host (one sync, as
    the reference's float() of it)."""
    return float(v) if isinstance(v, torch.Tensor) else v


@register_op("range")
def _range(ctx, op, ins):
    """Start / End / Step from the attrs, else the inputs (read to the
    host)."""
    vals = []
    for name, slot in (("start", "Start"), ("end", "End"),
                       ("step", "Step")):
        v = op.attr(name, None)
        vals.append(_scalar(first(ins, slot)) if v is None else v)
    dev = next((t.device for t in (first(ins, s) for s in
                                   ("Start", "End", "Step"))
                if isinstance(t, torch.Tensor)), ctx.device)
    return {"Out": [torch.arange(*vals, dtype=tdt(op.attr("dtype", "int64")),
                                 device=dev)]}


@register_op("linspace")
def _linspace(ctx, op, ins):
    start = op.attr("start", _scalar(first(ins, "Start", 0.0)))
    stop = op.attr("stop", _scalar(first(ins, "Stop", 1.0)))
    num = op.attr("num", _scalar(first(ins, "Num", 1)))
    return {"Out": [torch.linspace(float(start), float(stop), int(num),
                                   dtype=tdt(op.attr("dtype", "float32")),
                                   device=ctx.device)]}


@register_op("increment")
def _increment(ctx, op, ins):
    x = first(ins, "X")
    step = op.attr("step", 1.0)
    # a Python number: a device tensor made from it would be a host copy
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}


@register_op("transpose")
@register_op("transpose2")
def _transpose2(ctx, op, ins):
    x = first(ins, "X")
    perm = op.attr("axis", list(range(x.ndim))[::-1])
    return _with_xshape(op, x, x.permute(*[int(p) for p in perm]))


@register_op("squeeze")
@register_op("squeeze2")
def _squeeze2(ctx, op, ins):
    """The given axes that have size 1 (every size-1 axis when none are
    given); the others stay."""
    x = first(ins, "X")
    axes = op.attr("axes", []) or [i for i, s in enumerate(x.shape)
                                   if s == 1]
    axes = [a for a in (_axis(a, x.ndim) for a in axes) if x.shape[a] == 1]
    out = x
    for a in sorted(set(axes), reverse=True):
        out = out.squeeze(a)
    return _with_xshape(op, x, out)


@register_op("unsqueeze")
@register_op("unsqueeze2")
def _unsqueeze2(ctx, op, ins):
    """New size-1 axes at the given positions of the output."""
    x = first(ins, "X")
    axes = list(op.attr("axes", []))
    n = x.ndim + len(axes)
    out = x
    for a in sorted(_axis(a, n) for a in axes):
        out = out.unsqueeze(a)
    return _with_xshape(op, x, out)


@register_op("flatten_contiguous_range")
def _flatten_range(ctx, op, ins):
    x = first(ins, "X")
    start = _axis(op.attr("start_axis", 1), x.ndim)
    stop = _axis(op.attr("stop_axis", -1), x.ndim)
    shape = tuple(x.shape[:start]) + (-1,) + tuple(x.shape[stop + 1:])
    return _with_xshape(op, x, x.reshape(shape))


@register_op("stack")
def _stack(ctx, op, ins):
    xs = [v for v in ins.get("X", []) if v is not None]
    return {"Y": [torch.stack(xs, dim=op.attr("axis", 0))]}


@register_op("unstack")
def _unstack(ctx, op, ins):
    """Every slice along `axis` (the `num` attr is not read)."""
    return {"Y": list(torch.unbind(first(ins, "X"),
                                   dim=op.attr("axis", 0)))}


@register_op("unbind")
def _unbind(ctx, op, ins):
    return {"Out": list(torch.unbind(first(ins, "X"),
                                     dim=int(op.attr("axis", 0))))}


@register_op("split")
def _split(ctx, op, ins):
    """`sections` (one of them may be -1: the rest), else `num` equal
    parts."""
    x = first(ins, "X")
    axis = _axis(op.attr("axis", 0), x.ndim)
    sections = list(op.attr("sections", []))
    if sections:
        if -1 in sections:
            i = sections.index(-1)
            sections[i] = x.shape[axis] - sum(s for j, s in
                                              enumerate(sections) if j != i)
    else:
        num = int(op.attr("num", 0))
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {x.shape[axis]} is not divisible "
                             f"into {num} parts")
        sections = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, sections, dim=axis))}


@register_op("slice")
def _slice(ctx, op, ins):
    """[start, end) on each axis, negative bounds from the end, clamped
    to the dim; then `decrease_axis` squeezed."""
    x = first(ins, "Input")
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(op.attr("axes", []), op.attr("starts", []),
                       op.attr("ends", [])):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(int(s), int(e))
    out = x[tuple(idx)]
    dec = op.attr("decrease_axis", [])
    if dec:
        out = out.squeeze(tuple(int(d) for d in dec))
    return {"Out": [out]}


@register_op("strided_slice")
def _strided_slice(ctx, op, ins):
    """Python's slice(start, end, stride) on each axis; a negative
    stride (which torch's views do not take) as an index_select of the
    positions Python's slice picks."""
    x = first(ins, "Input")
    axes = op.attr("axes", [])
    strides = op.attr("strides", [1] * len(axes))
    out = x
    for a, s, e, st in zip(axes, op.attr("starts", []), op.attr("ends", []),
                           strides):
        sl = slice(int(s), int(e), int(st))
        if st > 0:
            idx = [slice(None)] * x.ndim
            idx[a] = sl
            out = out[tuple(idx)]
        else:
            pos = list(range(x.shape[a]))[sl]
            out = out.index_select(a, torch.tensor(pos, dtype=torch.int64,
                                                   device=x.device))
    return {"Out": [out]}


@register_op("expand_v2")
def _expand_v2(ctx, op, ins):
    """Broadcast to `shape`; -1 keeps the input's dim."""
    x = first(ins, "X")
    shape = list(op.attr("shape", []))
    nd = len(shape) - x.ndim
    full = [(x.shape[i - nd] if i >= nd else 1) if s == -1 else int(s)
            for i, s in enumerate(shape)]
    return {"Out": [torch.broadcast_to(x, tuple(full))]}


@register_op("expand_as_v2")
def _expand_as_v2(ctx, op, ins):
    return {"Out": [torch.broadcast_to(
        first(ins, "X"), tuple(int(s) for s in op.attr("target_shape",
                                                       [])))]}


@register_op("tile")
def _tile(ctx, op, ins):
    return {"Out": [torch.tile(first(ins, "X"), tuple(
        int(t) for t in op.attr("repeat_times", [1])))]}


@register_op("flip")
def _flip(ctx, op, ins):
    return {"Out": [torch.flip(first(ins, "X"),
                               tuple(op.attr("axis", [0])))]}


@register_op("roll")
def _roll(ctx, op, ins):
    """Along `axis`; with none, over the flattened tensor by the first
    shift."""
    x = first(ins, "X")
    shifts = op.attr("shifts", [0])
    axis = op.attr("axis", [])
    if not axis:
        return {"Out": [torch.roll(x.reshape(-1),
                                   int(shifts[0])).reshape(x.shape)]}
    return {"Out": [torch.roll(x, tuple(int(s) for s in shifts),
                               tuple(int(a) for a in axis))]}


@register_op("tril_triu")
def _tril_triu(ctx, op, ins):
    x, d = first(ins, "X"), op.attr("diagonal", 0)
    return {"Out": [torch.tril(x, d) if op.attr("lower", True)
                    else torch.triu(x, d)]}


@register_op("diag_v2")
def _diag_v2(ctx, op, ins):
    """A vector to a matrix with it on diagonal `offset` (the rest
    `padding_value`), a matrix to its diagonal."""
    x = first(ins, "X")
    offset = op.attr("offset", 0)
    if x.ndim != 1:
        return {"Out": [torch.diagonal(x, offset)]}
    out = torch.diag(x, offset)
    pv = op.attr("padding_value", 0.0)
    if pv:
        on = torch.diag(torch.ones_like(x), offset) > 0
        out = torch.where(on, out, torch.full_like(out, pv))
    return {"Out": [out]}


@register_op("meshgrid")
def _meshgrid(ctx, op, ins):
    xs = [v for v in ins.get("X", []) if v is not None]
    return {"Out": list(torch.meshgrid(*xs, indexing="ij"))}


@register_op("gather")
def _gather(ctx, op, ins):
    """jnp.take along `axis` (an (N, 1) index is read as (N,)): the
    index's shape takes the axis's place."""
    x, index = first(ins, "X"), first(ins, "Index")
    axis = _axis(_scalar(first(ins, "Axis", op.attr("axis", 0))), x.ndim)
    if index.ndim == 2 and index.shape[1] == 1:
        index = index[:, 0]
    out = x.index_select(axis, index.reshape(-1).long())
    shape = tuple(x.shape[:axis]) + tuple(index.shape) \
        + tuple(x.shape[axis + 1:])
    return {"Out": [out.reshape(shape)]}


@register_op("gather_nd")
def _gather_nd(ctx, op, ins):
    """x at the index's last-dim coordinates."""
    x, index = first(ins, "X"), first(ins, "Index")
    return {"Out": [x[tuple(index.long().movedim(-1, 0))]]}


@register_op("index_select")
def _index_select(ctx, op, ins):
    x, index = first(ins, "X"), first(ins, "Index")
    axis = _axis(op.attr("dim", 0), x.ndim)
    out = x.index_select(axis, index.reshape(-1).long())
    shape = tuple(x.shape[:axis]) + tuple(index.shape) \
        + tuple(x.shape[axis + 1:])
    return {"Out": [out.reshape(shape)]}


@register_op("index_sample")
def _index_sample(ctx, op, ins):
    return {"Out": [torch.gather(first(ins, "X"), 1,
                                 first(ins, "Index").long())]}


@register_op("scatter")
def _scatter(ctx, op, ins):
    """Rows `Ids` of x replaced by `Updates`; without `overwrite`, the
    rows are zeroed and every update added (repeated ids sum)."""
    x, ids, upd = first(ins, "X"), first(ins, "Ids"), first(ins, "Updates")
    if ids.ndim == 2 and ids.shape[1] == 1:
        ids = ids[:, 0]
    ids = (ids.long(),)
    if op.attr("overwrite", True):
        return {"Out": [x.index_put(ids, upd)]}
    zeroed = x.index_put(ids, torch.zeros_like(upd))
    return {"Out": [zeroed.index_put(ids, upd, accumulate=True)]}


@register_op("scatter_nd_add")
def _scatter_nd_add(ctx, op, ins):
    x, index, upd = (first(ins, "X"), first(ins, "Index"),
                     first(ins, "Updates"))
    return {"Out": [x.index_put(tuple(index.long().movedim(-1, 0)), upd,
                                accumulate=True)]}


@register_op("where")
def _where(ctx, op, ins):
    return {"Out": [torch.where(first(ins, "Condition"), first(ins, "X"),
                                first(ins, "Y"))]}


@register_op("multiplex")
def _multiplex(ctx, op, ins):
    """Row i from candidate X[ids[i]]."""
    stack = torch.stack([v for v in ins.get("X", []) if v is not None])
    ids = first(ins, "Ids").reshape(-1).long()
    rows = torch.arange(stack.shape[1], device=stack.device)
    return {"Out": [stack[ids, rows]]}


@register_op("arg_max")
def _arg_max(ctx, op, ins):
    """The first largest element's index along `axis`, or in the
    flattened tensor under `flatten`."""
    x = first(ins, "X")
    axis = op.attr("axis", -1)
    flat = op.attr("flatten", False)
    out = torch.argmax(x) if flat else torch.argmax(x, dim=axis)
    if op.attr("keepdims", False) and not flat:
        out = out.unsqueeze(axis)
    dt = op.attr("dtype", "int64")
    return {"Out": [out.to(tdt("int64" if dt in (-1, None) else dt))]}


@register_op("arg_min")
def _arg_min(ctx, op, ins):
    """The first smallest element's index along `axis`.  The reference
    reads neither `flatten` nor `dtype` (tensor_ops.py:492-499): under
    `flatten` it still reduces `axis` alone, which is the flattened
    answer only for a 1-D input.  The port raises for the others rather
    than differ (ROADMAP queue 3); its indices are int64."""
    x = first(ins, "X")
    axis = op.attr("axis", -1)
    if op.attr("flatten", False) and x.ndim > 1:
        raise NotImplementedError(
            "arg_min with flatten over a tensor of more than one axis: "
            "the reference ignores flatten and reduces one axis")
    out = torch.argmin(x, dim=axis)
    if op.attr("keepdims", False):
        out = out.unsqueeze(axis)
    return {"Out": [out]}


@register_op("argsort")
def _argsort(ctx, op, ins):
    """A stable sort along `axis`: equal values keep their index order,
    descending too (the reference sorts -x stably)."""
    x = first(ins, "X")
    out, idx = torch.sort(x, dim=op.attr("axis", -1),
                          descending=op.attr("descending", False),
                          stable=True)
    return {"Out": [out], "Indices": [idx]}


@register_op("unique")
def _unique(ctx, op, ins):
    """tensor_ops.py:605-628, the static-shape form: the sorted distinct
    values of the flattened x, padded to x's size with the smallest
    value (jnp.unique's fill); `Index` (the inverse map) and `Counts`
    (0 for the padding) only when the op declares them, in the `dtype`
    attr.  The reference reads no `axis` attr: it always flattens, which
    is the answer along an axis only for a 1-D input; the port raises
    for the others rather than differ (ROADMAP queue 3)."""
    x = first(ins, "X")
    if op.attr("axis", []) and x.ndim > 1:
        raise NotImplementedError(
            "unique along an axis of a tensor of more than one axis: the "
            "reference ignores the axis and flattens")
    x = x.reshape(-1)
    n = x.numel()
    want_index, want_counts = "Index" in op.outputs, "Counts" in op.outputs
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True)
    pad = n - vals.numel()
    outs = {"Out": [torch.cat([vals, vals[:1].expand(pad)])]}
    dt = tdt(op.attr("dtype", "int32"))
    if want_index:
        outs["Index"] = [inv.reshape(-1).to(dt)]
    if want_counts:
        outs["Counts"] = [torch.cat([counts, counts.new_zeros(pad)]).to(dt)]
    return outs


# -- the rest of the reference module (tensor_ops.py) ----------------------------

@register_op("reshape")
def _reshape(ctx, op, ins):
    """The v1 reshape: the `shape` attr (a 0 copies the input's dim), no
    XShape."""
    x = first(ins, "X")
    shape = [x.shape[i] if s == 0 else int(s)
             for i, s in enumerate(op.attr("shape", []))]
    return {"Out": [x.reshape(shape)]}


@register_op("flatten")
@register_op("flatten2")
def _flatten2(ctx, op, ins):
    """(prod of the dims before `axis`, the rest)."""
    x = first(ins, "X")
    lead = 1
    for s in x.shape[:op.attr("axis", 1)]:
        lead *= int(s)
    return _with_xshape(op, x, x.reshape(lead, -1))


@register_op("expand")
def _expand(ctx, op, ins):
    """The v1 expand: tiles by `expand_times`."""
    x = first(ins, "X")
    times = op.attr("expand_times", [1] * x.ndim)
    return {"Out": [torch.tile(x, tuple(int(t) for t in times))]}


@register_op("broadcast_to")
def _broadcast_to(ctx, op, ins):
    return {"Out": [torch.broadcast_to(
        first(ins, "X"), tuple(int(s) for s in op.attr("shape", [])))]}


@register_op("reverse")
def _reverse(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [torch.flip(x, tuple(_axis(a, x.ndim)
                                        for a in op.attr("axis", [0])))]}


def _pad_mode(x, pads, mode, value):
    """torch's pad of the trailing axes, `pads` as (last lo, last hi,
    next lo, ...); "edge" and "replicate" repeat the border, "wrap" and
    "circular" wrap around."""
    mode = {"edge": "replicate", "wrap": "circular"}.get(mode, mode)
    if mode == "constant":
        return torch.nn.functional.pad(x, pads, value=value)
    return torch.nn.functional.pad(x, pads, mode=mode)


@register_op("pad")
def _pad(ctx, op, ins):
    """`paddings` as (lo, hi) pairs for every axis from the first."""
    x = first(ins, "X")
    p = [int(v) for v in op.attr("paddings", [])]
    pads = []
    for i in reversed(range(x.ndim)):
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": [torch.nn.functional.pad(
        x, pads, value=op.attr("pad_value", 0.0))]}


@register_op("pad2d")
def _pad2d(ctx, op, ins):
    """[top, bottom, left, right] on H and W, NCHW or NHWC; "constant",
    "reflect", or else the border repeated (tensor_ops.py:474-492)."""
    x = first(ins, "X")
    t, b, l, r = (int(v) for v in op.attr("paddings", [0, 0, 0, 0]))
    mode = op.attr("mode", "constant")
    mode = mode if mode in ("constant", "reflect") else "edge"
    nhwc = op.attr("data_format", "NCHW") != "NCHW"
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    out = _pad_mode(xc, [l, r, t, b], mode, op.attr("pad_value", 0.0))
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


@register_op("pad3d")
def _pad3d(ctx, op, ins):
    """[left, right, top, bottom, front, back] on W, H and D, NCDHW or
    NDHWC; "constant" (the `value` attr), "reflect", "replicate" or
    else circular (tensor_ops.py:495-515)."""
    x = first(ins, "X")
    p = [int(v) for v in op.attr("paddings", [0] * 6)]
    mode = op.attr("mode", "constant")
    if mode not in ("constant", "reflect", "replicate"):
        mode = "circular"
    last = op.attr("data_format", "NCDHW") != "NCDHW"
    xc = x.permute(0, 4, 1, 2, 3) if last else x
    out = _pad_mode(xc, p, mode, op.attr("value", 0.0))
    return {"Out": [out.permute(0, 2, 3, 4, 1) if last else out]}


@register_op("one_hot")
@register_op("one_hot_v2")
def _one_hot(ctx, op, ins):
    """float32 rows of `depth` (from the depth_tensor input, else the
    attr) with a 1 at each id; a trailing dim of 1 is dropped first; an
    id outside [0, depth) gives a row of zeros, as jax.nn.one_hot."""
    x = first(ins, "X")
    depth = int(_scalar(first(ins, "depth_tensor", op.attr("depth", 1))))
    if x.ndim >= 1 and x.shape[-1] == 1:
        x = x[..., 0]
    cols = torch.arange(depth, device=x.device)
    return {"Out": [(x[..., None] == cols).to(torch.float32)]}


@register_op("masked_fill")
def _masked_fill(ctx, op, ins):
    x, mask = first(ins, "X"), first(ins, "Mask")
    return {"Out": [torch.where(mask, torch.full_like(
        x, op.attr("value", 0.0)), x)]}


@register_op("masked_select")
def _masked_select(ctx, op, ins):
    """The static-shape form (tensor_ops.py:604-622): the selected
    elements front-packed into x.size slots, the rest 0, and their count
    (int32) when the op declares Count."""
    x, mask = first(ins, "X"), first(ins, "Mask")
    flat = x.reshape(-1)
    m = torch.broadcast_to(mask, x.shape).reshape(-1)
    order = torch.sort((~m).to(torch.uint8), stable=True).indices
    n = torch.sum(m, dtype=torch.int32)
    keep = torch.arange(flat.shape[0], device=x.device) < n
    outs = {"Y": [torch.where(keep, flat[order], torch.zeros_like(flat))]}
    if "Count" in op.outputs:
        outs["Count"] = [n]
    return outs


@register_op("assign_value")
def _assign_value(ctx, op, ins):
    """The `values` attr in the `shape` attr's shape (its own without
    one), as `dtype`."""
    vals = np.asarray(op.attr("values"))
    shape = op.attr("shape", None) or vals.shape
    return {"Out": [torch.as_tensor(vals.reshape(shape),
                                    dtype=tdt(op.attr("dtype", "float32")),
                                    device=ctx.device)]}


@register_op("shape")
def _shape(ctx, op, ins):
    """The input's shape as int32, as the reference gives it."""
    x = first(ins, "Input")
    return {"Out": [torch.tensor(list(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register_op("size")
def _size(ctx, op, ins):
    x = first(ins, "Input")
    return {"Out": [torch.tensor(x.numel(), dtype=torch.int64,
                                 device=x.device)]}


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, op, ins):
    """`shape` with dim output_dim_idx taken from the input's dim
    input_dim_idx, filled with `value`."""
    x = first(ins, "Input")
    shape = [int(s) for s in op.attr("shape", [])]
    shape[op.attr("output_dim_idx", 0)] = x.shape[op.attr("input_dim_idx",
                                                           0)]
    return {"Out": [torch.full(tuple(shape), op.attr("value", 0.0),
                               dtype=tdt(op.attr("dtype", "float32")),
                               device=x.device)]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, op, ins):
    return {"Out": [torch.zeros_like(first(ins, "X"))]}


@register_op("inverse")
def _inverse(ctx, op, ins):
    return {"Output": [torch.linalg.inv(first(ins, "Input"))]}


@register_op("shuffle_batch")
def _shuffle_batch(ctx, op, ins):
    """A permutation of the rows (every dim but the last flattened into
    the row index), drawn from the op's generator; ShuffleIdx records it
    and SeedOut passes the Seed input on (tensor_ops.py:671-684).  The
    draw is torch's, not JAX's: the same seed gives another
    permutation."""
    x, seed = first(ins, "X"), first(ins, "Seed")
    rows = x.numel() // x.shape[-1]
    perm = torch.randperm(rows, generator=ctx.generator(op),
                          device=x.device)
    out = x.reshape(rows, x.shape[-1])[perm].reshape(x.shape)
    return {"Out": [out], "ShuffleIdx": [perm], "SeedOut": [seed]}


@register_op("segment_pool")
def _segment_pool(ctx, op, ins):
    """Rows sharing a segment id pooled (SUM, MEAN, MAX, MIN) into row id
    of an output of N rows (the static bound; rows past the last id are
    0, and so is an empty segment's MAX or MIN), with SummedIds, the
    rows a segment, when declared (tensor_ops.py:687-717)."""
    x = first(ins, "X")
    ids = first(ins, "SegmentIds").reshape(-1).long()
    pool = op.attr("pooltype", "SUM").upper()
    n = x.shape[0]
    cnt = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
        0, ids, torch.ones(n, dtype=x.dtype, device=x.device))
    total = torch.zeros_like(x).index_add(0, ids, x)
    if pool == "SUM":
        out = total
    elif pool == "MEAN":
        out = total / torch.clamp(cnt, min=1.0)[:, None]
    elif pool in ("MAX", "MIN"):
        out = torch.zeros_like(x).scatter_reduce(
            0, ids[:, None].expand_as(x), x,
            "amax" if pool == "MAX" else "amin", include_self=False)
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        raise NotImplementedError(f"segment_pool: pooltype {pool}")
    outs = {"Out": [out]}
    if "SummedIds" in op.outputs:
        outs["SummedIds"] = [cnt.reshape(-1, 1)]
    return outs
