"""Vision rules (counterpart of paddle_tpu/ops/vision_ops.py): grid
sampling and affine grids, affine_channel, pixel_shuffle, space_to_depth,
temporal_shift, crop, pad_constant_like, expand_as, the max pools with
indices and unpool, the transposed 3-D and depthwise convolutions and
deformable convolution.

Like the reference's, each rule is a composition of tensor operations:
gathers at coordinates computed from the attrs and the grid, strided
slices over the window taps, one scatter for unpool, and for deformable
convolution a bilinear gather followed by one grouped GEMM.  The
reference has no Pallas kernel for any of them.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..nn import functional as F
from .nn_ops import _transpose_pairs
from .registry import first, register_op


# -- grid sampling (vision_ops.py:39-148) --------------------------------------

def _gs_unnormalize(g, max_val, align_corners):
    if align_corners:
        return (g + 1.0) * (max_val * 0.5)
    return (g + 1.0) * ((max_val + 1) * 0.5) - 0.5


def _gs_clip(g, max_val, align_corners, padding_mode):
    """Border and reflection folding of pixel coordinates; 'zeros' leaves
    them, and out-of-bounds taps read 0."""
    if padding_mode == "border":
        return torch.clamp(g, 0.0, float(max_val))
    if padding_mode == "reflection":
        if align_corners:
            dr = float(max_val * 2) if max_val > 0 else 1.0
            ga = torch.abs(g)
            extra = ga - torch.floor(ga / dr) * dr
            return torch.minimum(extra, dr - extra)
        dr = float((max_val + 1) * 2)
        ga = torch.abs(g + 0.5)
        extra = ga - torch.floor(ga / dr) * dr
        return torch.clamp(torch.minimum(extra, dr - extra) - 0.5, 0.0,
                           float(max_val))
    return g


def _gs_fetch(x, xi, yi):
    """x (N, C, H, W) at float pixel coordinates xi, yi (N, Ho, Wo),
    rounded -> (N, C, Ho, Wo); 0 where the coordinate is out of bounds."""
    h, w = x.shape[-2:]
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    xc = torch.clamp(torch.round(xi).long(), 0, w - 1)
    yc = torch.clamp(torch.round(yi).long(), 0, h - 1)
    n, c = x.shape[:2]
    flat = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
    got = torch.gather(x.reshape(n, c, h * w), 2, flat).reshape(
        (n, c) + tuple(xi.shape[1:]))
    return got * inb[:, None].to(x.dtype)


@register_op("grid_sampler")
def _grid_sampler(ctx, op, ins):
    """Bilinear or nearest sampling of X (N, C, H, W) at Grid (N, Ho, Wo,
    2) in [-1, 1], with zeros, border or reflection padding."""
    x, grid = first(ins, "X"), first(ins, "Grid")
    align = bool(op.attr("align_corners", True))
    pad = op.attr("padding_mode", "zeros")
    h, w = x.shape[2], x.shape[3]
    gx = _gs_clip(_gs_unnormalize(grid[..., 0], w - 1, align), w - 1, align,
                  pad)
    gy = _gs_clip(_gs_unnormalize(grid[..., 1], h - 1, align), h - 1, align,
                  pad)
    if op.attr("mode", "bilinear") == "nearest":
        return {"Output": [_gs_fetch(x, torch.round(gx), torch.round(gy))]}
    xw, yn = torch.floor(gx), torch.floor(gy)
    dw, dn = gx - xw, gy - yn
    de, ds = 1.0 - dw, 1.0 - dn
    out = (_gs_fetch(x, xw, yn) * (de * ds)[:, None]
           + _gs_fetch(x, xw + 1, yn) * (dw * ds)[:, None]
           + _gs_fetch(x, xw, yn + 1) * (de * dn)[:, None]
           + _gs_fetch(x, xw + 1, yn + 1) * (dw * dn)[:, None])
    return {"Output": [out]}


@register_op("affine_grid")
def _affine_grid(ctx, op, ins):
    """The (N, H, W, 2) grid Theta (N, 2, 3) maps the (x, y, 1) linspaces
    over [-1, 1] to (scaled by (n - 1) / n without align_corners)."""
    theta = first(ins, "Theta")
    if first(ins, "OutputShape") is not None:
        raise NotImplementedError(
            "affine_grid: a tensor-valued OutputShape is a dynamic shape; "
            "pass the output_shape attr")
    oshape = [int(v) for v in op.attr("output_shape", [])]
    if len(oshape) != 4:
        raise ValueError("affine_grid needs output_shape [N, C, H, W]")
    _, _, h, w = oshape
    align = bool(op.attr("align_corners", True))

    def linspace(count):
        if align:
            return np.linspace(-1.0, 1.0, count)
        return -1.0 * (count - 1) / count + np.arange(count) * (2.0 / count)

    base = np.stack([np.broadcast_to(linspace(w)[None, :], (h, w)),
                     np.broadcast_to(linspace(h)[:, None], (h, w)),
                     np.ones((h, w))], axis=-1)
    base = torch.as_tensor(base, dtype=theta.dtype, device=theta.device)
    return {"Output": [torch.einsum("hwk,njk->nhwj", base, theta)]}


@register_op("affine_channel")
def _affine_channel(ctx, op, ins):
    x = first(ins, "X")
    scale = first(ins, "Scale").reshape(-1)
    bias = first(ins, "Bias").reshape(-1)
    shape = ((1,) * (x.ndim - 1) + (-1,)
             if op.attr("data_layout", "NCHW") == "NHWC"
             else (1, -1) + (1,) * (x.ndim - 2))
    return {"Out": [x * scale.reshape(shape) + bias.reshape(shape)]}


@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, op, ins):
    """(N, C r^2, H, W) -> (N, C, H r, W r), channel blocks (c, rh, rw)."""
    x = first(ins, "X")
    r = int(op.attr("upscale_factor", 1))
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3) \
        .reshape(n, c // (r * r), h * r, w * r)
    return {"Out": [out.permute(0, 2, 3, 1) if nhwc else out]}


@register_op("space_to_depth")
def _space_to_depth(ctx, op, ins):
    """The reference kernel's permutation (vision_ops.py:182-200): a
    depth-to-space write of X read back as (B, C bs^2, H / bs, W / bs)."""
    x = first(ins, "X")
    bs = int(op.attr("blocksize", 2))
    n, c, h, w = x.shape
    buf = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    return {"Out": [buf.reshape(n, c * bs * bs, h // bs, w // bs)]}


@register_op("temporal_shift")
def _temporal_shift(ctx, op, ins):
    """X (N T, C, H, W): the first C ratio channels read from t - 1, the
    next C ratio from t + 1, zeros past the ends; the rest stay."""
    x = first(ins, "X")
    t = int(op.attr("seg_num", 1))
    ratio = op.attr("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    v = x.reshape(nt // t, t, c, h, w)
    zeros = torch.zeros_like(v[:, :1])
    fwd = torch.cat([zeros[:, :, :c1], v[:, :-1, :c1]], dim=1)
    bwd = torch.cat([v[:, 1:, c1:c2], zeros[:, :, c1:c2]], dim=1)
    return {"Out": [torch.cat([fwd, bwd, v[:, :, c2:]], dim=2)
                    .reshape(nt, c, h, w)]}


@register_op("crop")
@register_op("crop_tensor")
def _crop(ctx, op, ins):
    """The `shape`-sized window (Y's shape, when given; a size <= 0 keeps
    the dim) at `offsets` (the Offsets tensor's values, when given: read
    to the host)."""
    x, y = first(ins, "X"), first(ins, "Y")
    shape = list(y.shape) if y is not None else \
        [int(s) for s in (op.attr("shape", []) or [])]
    if not shape:
        raise ValueError(f"{op.type}: need a static shape attr or Y input")
    shape = [x.shape[i] if s <= 0 else s for i, s in enumerate(shape)]
    off_t = first(ins, "Offsets")
    if off_t is not None and ctx.abstract:
        off_t = torch.zeros(x.ndim, dtype=torch.long)
    offsets = ([int(o) for o in off_t.tolist()] if off_t is not None else
               [int(o) for o in (op.attr("offsets", []) or [0] * x.ndim)])
    if off_t is not None:
        # lax.dynamic_slice's rule: a start is clamped into the range
        offsets = [min(max(o, 0), x.shape[i] - s)
                   for i, (o, s) in enumerate(zip(offsets, shape))]
    return {"Out": [x[tuple(slice(o, o + s)
                            for o, s in zip(offsets, shape))]]}


@register_op("pad_constant_like")
def _pad_constant_like(ctx, op, ins):
    """Y padded at the high ends to X's shape with pad_value."""
    x, y = first(ins, "X"), first(ins, "Y")
    flat = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        flat += [0, int(xs - ys)]
    return {"Out": [torch.nn.functional.pad(
        y, flat, value=float(op.attr("pad_value", 0.0)))]}


@register_op("expand_as")
def _expand_as(ctx, op, ins):
    """X tiled to target_tensor's shape (whole multiples a dim)."""
    x, tgt = first(ins, "X"), first(ins, "target_tensor")
    return {"Out": [x.repeat([int(t // s)
                              for t, s in zip(tgt.shape, x.shape)])]}


# -- max pooling with indices and unpool (vision_ops.py:268-406) --------------

def _pool_with_index(x, ksize, strides, paddings, adaptive):
    """Max pooling over the trailing len(ksize) dims with the flat index
    (in each (n, c) map) of the first maximum of each window, in
    row-major window order, as the reference's strict `<` scan."""
    nd = len(ksize)
    spatial = list(x.shape[2:])
    flat_strides = [math.prod(spatial[i + 1:]) for i in range(nd)]
    if adaptive:
        outs = [int(k) for k in ksize]
        cells = []
        for pos in itertools.product(*[range(o) for o in outs]):
            bounds = [((p * spatial[i]) // outs[i],
                       -(-((p + 1) * spatial[i]) // outs[i]))
                      for i, p in enumerate(pos)]
            win = x[(slice(None), slice(None)) + tuple(
                slice(a, b) for a, b in bounds)].reshape(
                    x.shape[0], x.shape[1], -1)
            grids = np.meshgrid(*[np.arange(a, b) for a, b in bounds],
                                indexing="ij")
            flat = sum(g * s for g, s in zip(grids, flat_strides)).reshape(-1)
            am = torch.argmax(win, dim=-1)
            cells.append((torch.amax(win, dim=-1), torch.as_tensor(
                flat, device=x.device)[am]))
        shape = (x.shape[0], x.shape[1]) + tuple(outs)
        return (torch.stack([v for v, _ in cells], -1).reshape(shape),
                torch.stack([i for _, i in cells], -1).reshape(shape))
    outs = [(spatial[i] + 2 * paddings[i] - ksize[i]) // strides[i] + 1
            for i in range(nd)]
    flat_pad = []
    for i in reversed(range(nd)):
        flat_pad += [paddings[i], paddings[i] + ksize[i]]
    xp = torch.nn.functional.pad(x, flat_pad, value=float("-inf"))
    vals, idxs = [], []
    for tap in itertools.product(*[range(k) for k in ksize]):
        v = xp[(slice(None), slice(None)) + tuple(
            slice(d, d + outs[i] * strides[i], strides[i])
            for i, d in enumerate(tap))]
        coord = np.zeros(outs, np.int64)
        ok = np.ones(outs, bool)
        for i, d in enumerate(tap):
            c = np.arange(outs[i]) * strides[i] + d - paddings[i]
            shape = [1] * nd
            shape[i] = outs[i]
            c = c.reshape(shape)
            ok = ok & (c >= 0) & (c < spatial[i])
            coord = coord + c * flat_strides[i]
        okt = torch.as_tensor(ok, device=x.device)
        vals.append(torch.where(okt, v, torch.full_like(v, float("-inf"))))
        idxs.append(torch.as_tensor(coord, device=x.device).expand(v.shape))
    stack_v, stack_i = torch.stack(vals), torch.stack(idxs)
    am = torch.argmax(stack_v, dim=0, keepdim=True)
    return (torch.gather(stack_v, 0, am)[0],
            torch.gather(stack_i, 0, am)[0])


def _pool_index(op, ins, nd):
    x = first(ins, "X")
    ks = [int(k) for k in op.attr("ksize", [1] * nd)]
    st = [int(s) for s in op.attr("strides", [1] * nd)]
    pd = [int(p) for p in op.attr("paddings", [0] * nd)]
    if op.attr("global_pooling", False):
        ks, pd = list(x.shape[2:]), [0] * nd
    out, msk = _pool_with_index(x, ks, st, pd,
                                bool(op.attr("adaptive", False)))
    return {"Out": [out], "Mask": [msk.to(torch.int32)]}


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, op, ins):
    return _pool_index(op, ins, 2)


@register_op("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, op, ins):
    return _pool_index(op, ins, 3)


@register_op("unpool")
def _unpool(ctx, op, ins):
    """X scattered into a zero map of ((h - 1) s - 2 p + k) a side at
    each (n, c) map's flat Indices; an index out of range is dropped."""
    x, idx = first(ins, "X"), first(ins, "Indices").long()
    n, c, h, w = x.shape
    ks = [int(k) for k in op.attr("ksize", [2, 2])]
    st = [int(s) for s in op.attr("strides", ks)]
    pd = [int(p) for p in op.attr("paddings", [0, 0])]
    oh = (h - 1) * st[0] - 2 * pd[0] + ks[0]
    ow = (w - 1) * st[1] - 2 * pd[1] + ks[1]
    flat_i = idx.reshape(n * c, h * w)
    keep = (flat_i >= 0) & (flat_i < oh * ow)
    # dropped indices write into one extra column that is cut off
    flat_i = torch.where(keep, flat_i, torch.full_like(flat_i, oh * ow))
    canvas = torch.zeros((n * c, oh * ow + 1), dtype=x.dtype,
                         device=x.device)
    out = canvas.scatter(1, flat_i, x.reshape(n * c, h * w))
    return {"Out": [out[:, :oh * ow].reshape(n, c, oh, ow)]}


# -- transposed convolutions (vision_ops.py:413-472) ---------------------------

@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, op, ins):
    """The 3-D form of conv2d_transpose's scatter (NCDHW, weights (in,
    out / groups, kd, kh, kw)); `output_padding` as conv2d_transpose
    takes it (the reference zero-fills, ROADMAP queue 3)."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    dil = [int(d) for d in op.attr("dilations", [1, 1, 1])]
    pads = _transpose_pairs(op, w.shape[-3:], dil)
    return {"Output": [F._conv_transpose_core(
        x, w, [int(s) for s in op.attr("strides", [1, 1, 1])], pads, dil,
        int(op.attr("groups", 1) or 1), op.attr("output_padding", []) or [])]}


@register_op("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ctx, op, ins):
    """conv2d_transpose with one group a channel (groups 0: the input's
    channels).  The reference reads no `output_padding` here: the rule
    raises on a nonzero one."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    if any(int(p) for p in (op.attr("output_padding", []) or [])):
        raise NotImplementedError(
            "depthwise_conv2d_transpose: the reference reads no "
            "output_padding")
    dil = [int(d) for d in op.attr("dilations", [1, 1])]
    pads = _transpose_pairs(op, w.shape[-2:], dil)
    return {"Output": [F._conv_transpose_core(
        x, w, [int(s) for s in op.attr("strides", [1, 1])], pads, dil,
        int(op.attr("groups", 0) or x.shape[1]), [])]}


# -- deformable convolution (vision_ops.py:479-566) ----------------------------

def _dcn_bilinear(x, y, xx):
    """x (N, C, H, W) at absolute sample coordinates y, xx (N, K, Ho, Wo)
    -> (N, C, K, Ho, Wo); taps outside the map read 0."""
    n, c, h, w = x.shape
    y0, x0 = torch.floor(y), torch.floor(xx)
    dy, dx = y - y0, xx - x0
    flat_x = x.reshape(n, c, h * w)

    def fetch(yy, xq):
        inb = (yy >= 0) & (yy <= h - 1) & (xq >= 0) & (xq <= w - 1)
        yc = torch.clamp(yy.long(), 0, h - 1)
        xc = torch.clamp(xq.long(), 0, w - 1)
        flat = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        got = torch.gather(flat_x, 2, flat).reshape((n, c) + tuple(y.shape[1:]))
        return got * inb[:, None].to(x.dtype)

    return (fetch(y0, x0) * ((1 - dy) * (1 - dx))[:, None]
            + fetch(y0, x0 + 1) * ((1 - dy) * dx)[:, None]
            + fetch(y0 + 1, x0) * (dy * (1 - dx))[:, None]
            + fetch(y0 + 1, x0 + 1) * (dy * dx)[:, None])


@register_op("deformable_conv")
@register_op("deformable_conv_v1")
def _deformable_conv(ctx, op, ins):
    """For each kernel tap and deformable group, X sampled bilinearly at
    the base grid plus the learned offset (channel 2 (g K + k) is dy, the
    next dx), times the modulation Mask (v2 only), then one grouped GEMM
    of the sampled columns with the filter (Cout, Cin / g, kh, kw)."""
    x, offset = first(ins, "Input"), first(ins, "Offset")
    mask = first(ins, "Mask") if op.type == "deformable_conv" else None
    w = first(ins, "Filter")
    strides = [int(s) for s in op.attr("strides", [1, 1])]
    pads = [int(p) for p in op.attr("paddings", [0, 0])]
    dils = [int(d) for d in op.attr("dilations", [1, 1])]
    groups = int(op.attr("groups", 1) or 1)
    dg = int(op.attr("deformable_groups", 1) or 1)
    n, cin, h, ww = x.shape
    cout, _, kh, kw = w.shape
    k = kh * kw
    ho = (h + 2 * pads[0] - (dils[0] * (kh - 1) + 1)) // strides[0] + 1
    wo = (ww + 2 * pads[1] - (dils[1] * (kw - 1) + 1)) // strides[1] + 1
    base_y = np.zeros((k, ho, wo))
    base_x = np.zeros((k, ho, wo))
    for ki in range(kh):
        for kj in range(kw):
            base_y[ki * kw + kj] = (np.arange(ho) * strides[0] - pads[0]
                                    + ki * dils[0])[:, None]
            base_x[ki * kw + kj] = (np.arange(wo) * strides[1] - pads[1]
                                    + kj * dils[1])[None, :]
    base_y = torch.as_tensor(base_y, dtype=x.dtype, device=x.device)
    base_x = torch.as_tensor(base_x, dtype=x.dtype, device=x.device)
    cpg = cin // dg
    cols = []
    for g in range(dg):
        oy = offset[:, 2 * g * k:2 * (g + 1) * k:2]
        ox = offset[:, 2 * g * k + 1:2 * (g + 1) * k:2]
        col = _dcn_bilinear(x[:, g * cpg:(g + 1) * cpg], base_y + oy,
                            base_x + ox)
        if mask is not None:
            col = col * mask[:, g * k:(g + 1) * k][:, None]
        cols.append(col)
    col = torch.cat(cols, dim=1)                  # (N, Cin, K, Ho, Wo)
    cg = cin // groups
    colg = col.reshape(n, groups, cg * k, ho * wo)
    wg = w.reshape(groups, cout // groups, cg * k)
    out = torch.einsum("ngkp,gok->ngop", colg, wg)
    return {"Output": [out.reshape(n, cout, ho, wo)]}

