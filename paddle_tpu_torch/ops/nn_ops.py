"""Neural-network rules (counterpart of paddle_tpu/ops/nn_ops.py): the
convolutions (conv2d, depthwise_conv2d, conv2d_transpose, conv3d),
pool2d and pool3d, the norms (batch_norm, sync_batch_norm, layer_norm,
instance_norm, group_norm, lrn, norm, spectral_norm, data_norm),
dropout, the embeddings, the interpolations, the activations prelu,
maxout and selu, unfold and spp, accuracy, label_smooth and every loss
of the bucket (softmax_with_cross_entropy, cross_entropy(2), the losses
of fluid.layers.loss, nll_loss, hinge, log, rank, margin-rank, bpr,
center, hierarchical sigmoid, nce and sample_logits) and cos_sim.

The convolution, pooling and batch-norm rules run the port's
`nn.functional` (cuDNN and ATen on the card), which keeps the reference
lowering's semantics: Paddle's padding forms, -inf max-pool padding,
exclusive average pooling, and batch norm's running statistics as
running * momentum + batch * (1 - momentum) with the biased batch variance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..nn import functional as F
from .registry import first, register_op, xshape


def _paddings(algorithm, paddings):
    """The padding the functional ops take, from the op's attrs
    (nn_ops.py:62-71): "SAME", "VALID", or the explicit [h, w] or
    [top, bottom, left, right] list."""
    if algorithm in ("SAME", "VALID"):
        return algorithm
    return [int(p) for p in paddings]


def _fmt(fmt):
    return "NCHW" if fmt in ("NCHW", "AnyLayout") else "NHWC"


@register_op("conv2d")
@register_op("depthwise_conv2d")
def _conv2d(ctx, op, ins):
    """nn_ops.py:77-103: OIHW weights whatever the data format.
    `depthwise_conv2d` with groups <= 1 takes one group a channel."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    fmt = _fmt(op.attr("data_format", "NCHW"))
    groups = op.attr("groups", 1)
    if op.type == "depthwise_conv2d" and groups <= 1:
        groups = x.shape[-1] if fmt == "NHWC" else x.shape[1]
    out = F._conv2d_core(
        x, w, stride=tuple(op.attr("strides", [1, 1])),
        padding=_paddings(op.attr("padding_algorithm", "EXPLICIT"),
                          op.attr("paddings", [0, 0])),
        dilation=tuple(op.attr("dilations", [1, 1])), groups=groups,
        data_format=fmt)
    return {"Output": [out]}


def _pairs(algorithm, paddings, ksize, dilations, sizes=None,
           strides=None):
    """(low, high) pads a spatial dim (nn_ops.py:65-74): VALID is none,
    SAME XLA's rule over `sizes` and `strides`, an explicit list one
    value a dim or (before, after) pairs."""
    n = len(ksize)
    if algorithm == "VALID":
        return [(0, 0)] * n
    if algorithm == "SAME":
        return [F._same_pads(sz, k, s, d) for sz, k, s, d in
                zip(sizes, ksize, strides, dilations)]
    p = [int(v) for v in paddings]
    if len(p) == n:
        return [(v, v) for v in p]
    return [(p[2 * i], p[2 * i + 1]) for i in range(n)]


def _transpose_pairs(op, ksize, dilations):
    """The pads of a transposed convolution (nn_ops.py:114-118): SAME is
    ((k - 1) // 2, k // 2) a dim, whatever the stride and dilation."""
    if op.attr("padding_algorithm", "EXPLICIT") == "SAME":
        return [((k - 1) // 2, k // 2) for k in ksize]
    return _pairs(op.attr("padding_algorithm", "EXPLICIT"),
                  op.attr("paddings", [0] * len(ksize)), ksize, dilations)


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, op, ins):
    """nn_ops.py:106-130: x[i, j] W[ki, kj] lands at [i s + ki d - pad,
    j s + kj d - pad] (the scatter its comment defines).  `output_padding`
    adds rows and columns at the high end that take the contributions
    the scatter puts there, as torch's conv_transpose2d gives them; the
    reference zero-fills them instead (ROADMAP queue 3)."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    dil = [int(d) for d in op.attr("dilations", [1, 1])]
    pads = _transpose_pairs(op, w.shape[-2:], dil)
    out = F._conv_transpose_core(
        x, w, [int(s) for s in op.attr("strides", [1, 1])], pads, dil,
        op.attr("groups", 1) or 1, op.attr("output_padding", []) or [],
        nhwc=op.attr("data_format", "NCHW") == "NHWC")
    return {"Output": [out]}


@register_op("conv3d")
def _conv3d(ctx, op, ins):
    """nn_ops.py:159-171: NCDHW, OIDHW weights."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = [int(s) for s in op.attr("strides", [1, 1, 1])]
    dil = [int(d) for d in op.attr("dilations", [1, 1, 1])]
    pads = _pairs(op.attr("padding_algorithm", "EXPLICIT"),
                  op.attr("paddings", [0, 0, 0]), w.shape[-3:], dil,
                  x.shape[2:], strides)
    return {"Output": [F._conv3d_core(x, w, strides, pads, dil,
                                      op.attr("groups", 1) or 1)]}


@register_op("pool2d")
def _pool2d(ctx, op, ins):
    """nn_ops.py:190-250.  Global pooling, and adaptive pooling to 1 x 1,
    reduce over the spatial axes; other adaptive sizes pool the windows
    [floor(i S / out), ceil((i + 1) S / out)).  Like the reference, the
    rule never reads `ceil_mode`: the output size is floored."""
    x = first(ins, "X")
    fmt = _fmt(op.attr("data_format", "NCHW"))
    ptype = op.attr("pooling_type", "max")
    sp_axes = (1, 2) if fmt == "NHWC" else (2, 3)
    ksize = list(op.attr("ksize", [2, 2]))
    if op.attr("global_pooling", False) or (
            op.attr("adaptive", False) and ksize == [1, 1]):
        if ptype == "max":
            return {"Out": [torch.amax(x, dim=sp_axes, keepdim=True)]}
        return {"Out": [torch.mean(x, dim=sp_axes, keepdim=True)]}
    if op.attr("adaptive", False):
        xc = x.permute(0, 3, 1, 2) if fmt == "NHWC" else x
        pool = F.adaptive_max_pool2d if ptype == "max" \
            else F.adaptive_avg_pool2d
        out = pool(xc, tuple(ksize))
        return {"Out": [out.permute(0, 2, 3, 1) if fmt == "NHWC" else out]}
    pads = _paddings(op.attr("padding_algorithm", "EXPLICIT"),
                     op.attr("paddings", [0, 0]))
    strides = tuple(op.attr("strides", [1, 1]))
    if ptype == "max":
        out = F.max_pool2d(x, tuple(ksize), strides, pads, data_format=fmt)
    else:
        out = F.avg_pool2d(x, tuple(ksize), strides, pads,
                           exclusive=op.attr("exclusive", True),
                           data_format=fmt)
    return {"Out": [out]}


@register_op("batch_norm")
def _batch_norm(ctx, op, ins):
    """nn_ops.py:253-299.  Training: y from the batch statistics; MeanOut
    = Mean * momentum + batch mean * (1 - momentum), VarianceOut likewise
    with the biased batch variance; SavedMean is the batch mean and
    SavedVariance the inverse std 1/sqrt(var + eps).  `is_test` or
    `use_global_stats`: y from the running statistics, which pass through,
    and zero saved statistics."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    mean, var = first(ins, "Mean"), first(ins, "Variance")
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    c_axis = 1 if op.attr("data_layout", "NCHW") in ("NCHW", "AnyLayout") \
        else x.ndim - 1
    if op.attr("is_test", False) or op.attr("use_global_stats", False):
        bshape = [1] * x.ndim
        bshape[c_axis] = x.shape[c_axis]
        inv_std = torch.rsqrt(var + eps)
        y = (x - mean.reshape(bshape)) * inv_std.reshape(bshape)
        y = y * scale.reshape(bshape) + bias.reshape(bshape)
        mean_out, var_out = mean, var
        saved_mean, saved_inv_std = torch.zeros_like(mean), \
            torch.zeros_like(var)
    else:
        y, bm, bv, saved_inv_std = F.batch_norm_train(x, scale, bias, eps,
                                                      c_axis)
        mean_out = mean * momentum + bm.to(mean.dtype) * (1 - momentum)
        var_out = var * momentum + bv.to(var.dtype) * (1 - momentum)
        saved_mean = bm
    return {
        "Y": [y],
        "MeanOut": [mean_out],
        "VarianceOut": [var_out],
        "SavedMean": [saved_mean],
        "SavedVariance": [saved_inv_std],
        "ReserveSpace": [torch.empty((0,), dtype=x.dtype, device=x.device)],
    }


register_op("sync_batch_norm")(_batch_norm)  # one card: batch_norm itself


@register_op("layer_norm")
def _layer_norm(ctx, op, ins):
    """nn_ops.py:305-327 over the trailing dims from `begin_norm_axis`;
    Mean and Variance flattened to the leading dims' count.  The body is
    `F.layer_norm`'s."""
    x = first(ins, "X")
    y, mean, var = F._layer_norm_body(
        x, op.attr("begin_norm_axis", 1), first(ins, "Scale"),
        first(ins, "Bias"), op.attr("epsilon", 1e-5))
    lead = math.prod(x.shape[:op.attr("begin_norm_axis", 1)])
    return {"Y": [y], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


def _channel(v, ndim):
    return v.reshape((1, -1) + (1,) * (ndim - 2))


@register_op("instance_norm")
def _instance_norm(ctx, op, ins):
    """nn_ops.py:330-346: each (sample, channel) normalised over its
    spatial dims with the biased variance; SavedMean and SavedVariance
    (the inverse std) a (sample, channel).  ATen's batch norm over the
    (1, N C, ...) view gives the statistics it normalised with."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    n, c = x.shape[0], x.shape[1]
    y, mean, invstd = torch.ops.aten.native_batch_norm(
        x.reshape((1, n * c) + tuple(x.shape[2:])), None, None, None, None,
        True, 0.0, op.attr("epsilon", 1e-5))
    y = y.reshape(x.shape)
    if scale is not None:
        y = y * _channel(scale, x.ndim)
    if bias is not None:
        y = y + _channel(bias, x.ndim)
    return {"Y": [y], "SavedMean": [mean], "SavedVariance": [invstd]}


@register_op("group_norm")
def _group_norm(ctx, op, ins):
    """nn_ops.py:349-367: NCHW channels in `groups` groups, each
    normalised with its biased variance; Mean and Variance (N, groups)."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    g = op.attr("groups", 1)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape(n, g, -1)
    mean = xg.mean(dim=2, keepdim=True)
    var = torch.square(xg - mean).mean(dim=2, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + op.attr("epsilon", 1e-5))
         ).reshape(x.shape)
    if scale is not None:
        y = y * _channel(scale, x.ndim)
    if bias is not None:
        y = y + _channel(bias, x.ndim)
    return {"Y": [y], "Mean": [mean.reshape(n, g)],
            "Variance": [var.reshape(n, g)]}


@register_op("dropout")
def _dropout(ctx, op, ins):
    """nn_ops.py:389-406, the body of `F.dropout`: in test mode (or at
    p 0) x, times 1 - p for `downgrade_in_infer`; in training a kept
    element is x / (1 - p) (`upscale_in_train`) or x, a dropped one 0.
    The mask comes from the op's generator on the run's device (torch's
    bits, not JAX's); Mask is the uint8 keep mask."""
    x = first(ins, "X")
    p = op.attr("dropout_prob", 0.5)
    training = not op.attr("is_test", False)
    upscale = op.attr("dropout_implementation",
                      "downgrade_in_infer") == "upscale_in_train"
    if training and p != 0.0 and ctx.abstract:
        return {"Out": [torch.empty_like(x)],
                "Mask": [torch.empty(x.shape, dtype=torch.uint8,
                                     device=x.device)]}
    gen = ctx.generator(op) if training and p != 0.0 else None
    out, keep = F._dropout_body(x, p, training, upscale, gen)
    mask = (torch.ones(x.shape, dtype=torch.uint8, device=x.device)
            if keep is None else keep.to(torch.uint8))
    return {"Out": [out], "Mask": [mask]}


@register_op("lookup_table_v2")
@register_op("lookup_table")
def _lookup_table(ctx, op, ins):
    """Rows of W at Ids; rows at `padding_idx` read as zeros
    (nn_ops.py:409-421).  `lookup_table` takes ids with a trailing dim
    of 1."""
    w, ids = first(ins, "W"), first(ins, "Ids")
    if op.type == "lookup_table" and ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return {"Out": [F._lookup_body(w, ids, op.attr("padding_idx", -1))]}


def _picked(values, label, axis, ignore_index):
    """values at the hard label along `axis` (a label dim of 1 there is
    squeezed first), the label that was ignored, and the label's axis."""
    axis = axis if axis >= 0 else axis + values.ndim
    lab = label
    if lab.ndim == values.ndim and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    ignored = (lab == ignore_index).unsqueeze(axis)
    safe = torch.where(lab == ignore_index, torch.zeros_like(lab), lab)
    return torch.gather(values, axis, safe.unsqueeze(axis).long()), ignored


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, op, ins):
    """nn_ops.py:424-446: Softmax = exp(log_softmax), Loss = -log p at the
    label (0 at ignore_index), or -sum(label * log p) with soft labels."""
    logits, label = first(ins, "Logits"), first(ins, "Label")
    axis = op.attr("axis", -1)
    logp = torch.log_softmax(logits, dim=axis)
    if op.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        picked, ignored = _picked(logp, label, axis,
                                  op.attr("ignore_index", -100))
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}


@register_op("cross_entropy")
@register_op("cross_entropy2")
def _cross_entropy(ctx, op, ins):
    """nn_ops.py:449-473: X holds probabilities; Y = -log(p + 1e-12) at
    the label (0 at ignore_index), or -sum(label * log(x + 1e-12))."""
    x, label = first(ins, "X"), first(ins, "Label")
    eps = 1e-12
    if op.attr("soft_label", False):
        loss = -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        picked, ignored = _picked(x, label, -1,
                                  op.attr("ignore_index", -100))
        loss = torch.where(ignored, torch.zeros_like(picked),
                           -torch.log(picked + eps))
    out = {"Y": [loss]}
    if "XShape" in op.outputs:
        out["XShape"] = [xshape(x)]
    if "MatchX" in op.outputs:
        out["MatchX"] = [torch.zeros_like(loss)]
    return out


@register_op("accuracy")
def _accuracy(ctx, op, ins):
    """nn_ops.py:553-565: the share of rows whose label is among Indices;
    Correct and Total as int32, all on the device (no host read)."""
    indices, label = first(ins, "Indices"), first(ins, "Label")
    lab = label[:, 0] if label.ndim == 2 and label.shape[1] == 1 else label
    correct = torch.any(indices == lab[:, None].to(indices.dtype), dim=1)
    num_correct = torch.sum(correct.to(torch.int32), dtype=torch.int32)
    total = torch.full((), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    acc = num_correct.to(torch.float32) / total.to(torch.float32)
    return {"Accuracy": [acc], "Correct": [num_correct], "Total": [total]}


# -- the losses of fluid.layers.loss (nn_ops.py:476-537) ------------------------

@register_op("sigmoid_cross_entropy_with_logits")
def _sce_logits(ctx, op, ins):
    """max(x, 0) - x y + log(1 + e^-|x|), 0 where the label is
    `ignore_index`; with `normalize`, over the count of the others."""
    x, label = first(ins, "X"), first(ins, "Label")
    loss = (torch.clamp(x, min=0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    mask = label == op.attr("ignore_index", -100)
    loss = torch.where(mask, torch.zeros_like(loss), loss)
    if op.attr("normalize", False):
        kept = torch.sum(1.0 - mask.to(x.dtype))
        loss = loss / torch.clamp(kept, min=1.0)
    return {"Out": [loss]}


@register_op("bce_loss")
def _bce_loss(ctx, op, ins):
    x, label = first(ins, "X"), first(ins, "Label")
    eps = 1e-12
    return {"Out": [-(label * torch.log(x + eps)
                      + (1 - label) * torch.log(1 - x + eps))]}


@register_op("huber_loss")
def _huber_loss(ctx, op, ins):
    """0.5 r^2 where |r| <= delta, else delta (|r| - delta / 2), r = y -
    x; Residual is r."""
    x, y = first(ins, "X"), first(ins, "Y")
    delta = op.attr("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    return {"Out": [torch.where(ar <= delta, 0.5 * torch.square(r),
                                delta * (ar - 0.5 * delta))],
            "Residual": [r]}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, op, ins):
    """Per row, the sum of 0.5 sigma^2 d^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2 (d = x - y), as (N, 1); Diff is d."""
    x, y = first(ins, "X"), first(ins, "Y")
    s2 = op.attr("sigma", 1.0) ** 2
    diff = x - y
    ad = torch.abs(diff)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * torch.square(diff),
                       ad - 0.5 / s2)
    return {"Out": [torch.sum(elem.reshape(x.shape[0], -1), dim=1,
                              keepdim=True)],
            "Diff": [diff]}


@register_op("kldiv_loss")
def _kldiv(ctx, op, ins):
    """target (log target - x) where target > 0, else 0; reduced by
    `reduction` (mean, sum, batchmean over the first dim, or none)."""
    x, target = first(ins, "X"), first(ins, "Target")
    loss = torch.where(target > 0, target * (torch.log(target) - x),
                       torch.zeros_like(target))
    red = op.attr("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": [loss]}


@register_op("cos_sim")
def _cos_sim(ctx, op, ins):
    """The cosine of each row of X with Y's row (or Y's one row), (N, 1),
    with the rows' norms (nn_ops.py:1009-1023)."""
    x, y = first(ins, "X"), first(ins, "Y")
    xf, yf = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    xn = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(yf * yf, dim=1, keepdim=True))
    prod = torch.sum(xf * yf, dim=1, keepdim=True)
    return {"Out": [prod / (xn * yn)], "XNorm": [xn], "YNorm": [yn]}


@register_op("label_smooth")
def _label_smooth(ctx, op, ins):
    """(1 - eps) x + eps * PriorDist, or eps / K without one."""
    x, dist = first(ins, "X"), first(ins, "PriorDist")
    eps = op.attr("epsilon", 0.0)
    if dist is not None:
        return {"Out": [(1 - eps) * x + eps * dist]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


# -- pooling in 3-D, spatial pyramid ------------------------------------------

def _pool_nd(x, ptype, ksize, strides, pads, exclusive):
    """Max (padding -inf) or average (exclusive: over the window's real
    elements) pooling of an NC... tensor over its trailing len(ksize)
    dims, with (low, high) pads a dim."""
    nd = len(ksize)
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    pool = {2: (torch.nn.functional.max_pool2d,
                torch.nn.functional.avg_pool2d),
            3: (torch.nn.functional.max_pool3d,
                torch.nn.functional.avg_pool3d)}[nd]
    if ptype == "max":
        if any(flat):
            x = torch.nn.functional.pad(x, flat, value=float("-inf"))
        return pool[0](x, ksize, strides)
    if nd == 3 and x.device.type == "cpu" and x.dtype in (torch.bfloat16,
                                                         torch.float16):
        # ATen's CPU avg_pool3d has no half-precision kernel: the average
        # in f32, rounded once (its CUDA kernel accumulates in f32 too)
        return _pool_nd(x.float(), ptype, ksize, strides, pads,
                        exclusive).to(x.dtype)
    xp = torch.nn.functional.pad(x, flat) if any(flat) else x
    out = pool[1](xp, ksize, strides)
    if exclusive and any(flat):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = out / pool[1](torch.nn.functional.pad(ones, flat), ksize,
                            strides)
    return out


def _adaptive(x, ptype, sizes):
    """Adaptive pooling of the trailing len(sizes) dims over the windows
    [floor(i S / out), ceil((i + 1) S / out)) (nn_ops.py:174-187),
    torch's windows too."""
    f = {("max", 1): torch.nn.functional.adaptive_max_pool1d,
         ("avg", 1): torch.nn.functional.adaptive_avg_pool1d,
         ("max", 2): torch.nn.functional.adaptive_max_pool2d,
         ("avg", 2): torch.nn.functional.adaptive_avg_pool2d,
         ("max", 3): torch.nn.functional.adaptive_max_pool3d,
         ("avg", 3): torch.nn.functional.adaptive_avg_pool3d}
    return f[(ptype, len(sizes))](x, tuple(int(s) for s in sizes))


@register_op("pool3d")
def _pool3d(ctx, op, ins):
    """nn_ops.py:1161-1200: NCDHW max or average pooling (exclusive by
    default), global and adaptive forms; `ceil_mode` is not read, as in
    the reference."""
    x = first(ins, "X")
    ptype = op.attr("pooling_type", "max")
    ksize = [int(k) for k in op.attr("ksize", [2, 2, 2])]
    if op.attr("global_pooling", False) or (
            op.attr("adaptive", False) and ksize == [1, 1, 1]):
        red = torch.amax if ptype == "max" else torch.mean
        return {"Out": [red(x, dim=(2, 3, 4), keepdim=True)]}
    if op.attr("adaptive", False):
        return {"Out": [_adaptive(x, ptype, ksize)]}
    strides = [int(s) for s in op.attr("strides", [1, 1, 1])]
    pads = _pairs(op.attr("padding_algorithm", "EXPLICIT"),
                  op.attr("paddings", [0, 0, 0]), ksize, (1, 1, 1),
                  x.shape[2:], strides)
    return {"Out": [_pool_nd(x, ptype, ksize, strides, pads,
                             op.attr("exclusive", True))]}


@register_op("spp")
def _spp(ctx, op, ins):
    """nn_ops.py:804-817: adaptive pools at 1, 2, 4, ... bins a side,
    each flattened, concatenated."""
    x = first(ins, "X")
    ptype = op.attr("pooling_type", "max")
    outs = [_adaptive(x, ptype, (2 ** lv, 2 ** lv)).reshape(x.shape[0], -1)
            for lv in range(int(op.attr("pyramid_height", 3)))]
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("unfold")
def _unfold(ctx, op, ins):
    """nn_ops.py:747-765: im2col, NCHW -> (N, C kh kw, L); paddings [h,
    w] or [top, left, bottom, right]."""
    x = first(ins, "X")
    ks = [int(k) for k in op.attr("kernel_sizes", [3, 3])]
    st = [int(s) for s in op.attr("strides", [1, 1])]
    pd = [int(p) for p in op.attr("paddings", [0, 0])]
    dl = [int(d) for d in op.attr("dilations", [1, 1])]
    if len(pd) == 4:
        x = torch.nn.functional.pad(x, (pd[1], pd[3], pd[0], pd[2]))
        pd = [0, 0]
    return {"Y": [torch.nn.functional.unfold(x, ks, dl, pd, st)]}


# -- the interpolations (nn_ops.py:568-722) -----------------------------------

def _interp_taps(in_sz, out_sz, align_corners, align_mode, kind, scale=0.0):
    """[(index (out,), weight (out,))] a tap for one axis, the reference
    kernels' coordinate maps (nn_ops.py:579-630): ratio 0 for one output,
    (in - 1) / (out - 1) with align_corners, 1 / scale for a v2 op given
    a scale, else in / out; nearest truncates (+0.5 with align_corners),
    linear takes two taps (half-pixel when align_mode is 0 and corners
    are not aligned), cubic four with Keys' A = -0.75."""
    j = np.arange(out_sz, dtype=np.float64)
    if out_sz <= 1:
        ratio = 0.0
    elif align_corners:
        ratio = (in_sz - 1) / (out_sz - 1)
    elif scale > 0:
        ratio = 1.0 / scale
    else:
        ratio = in_sz / out_sz
    if kind == "nearest":
        src = ratio * j + (0.5 if align_corners else 0.0)
        return [(np.clip(np.trunc(src).astype(np.int64), 0, in_sz - 1),
                 np.ones(out_sz))]
    if kind == "linear":
        if align_mode == 0 and not align_corners:
            raw = ratio * (j + 0.5) - 0.5
            lo = np.maximum(np.trunc(raw).astype(np.int64), 0)
            d = np.maximum(raw, 0.0) - lo
        else:
            raw = ratio * j
            lo = np.trunc(raw).astype(np.int64)
            d = raw - lo
        return [(lo, 1.0 - d), (np.minimum(lo + 1, in_sz - 1), d)]
    src = ratio * j if align_corners else ratio * (j + 0.5) - 0.5
    base = np.floor(src).astype(np.int64)
    t = src - base
    a = -0.75

    def cc1(v):
        return ((a + 2) * v - (a + 3)) * v * v + 1

    def cc2(v):
        return ((a * v - 5 * a) * v + 8 * a) * v - 4 * a

    ws = [cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t)]
    return [(np.clip(base - 1 + k, 0, in_sz - 1), ws[k]) for k in range(4)]


def _interp(op, ins, kind, n_spatial):
    if first(ins, "OutSize") is not None or ins.get("SizeTensor") \
            or first(ins, "Scale") is not None:
        raise NotImplementedError(
            f"{op.type}: tensor-valued output sizes/scales are dynamic "
            "shapes; pass out_h/out_w/scale attrs")
    x = first(ins, "X")
    layout = op.attr("data_layout", "NCHW")
    sp_off = 1 if layout not in ("NCHW", "NCDHW", "AnyLayout", "NCW") \
        else x.ndim - n_spatial
    names = ["out_d", "out_h", "out_w"][3 - n_spatial:]
    sizes = [int(op.attr(n, -1) or -1) for n in names]
    scale = op.attr("scale", 0.0)
    if isinstance(scale, (list, tuple)) and scale:
        sc = list(scale) + [scale[-1]] * (n_spatial - len(scale))
    else:
        sc = [float(scale or 0.0)] * n_spatial
    if all(s > 0 for s in sizes):
        sc = [0.0] * n_spatial
    else:
        sizes = [s if s > 0 else int(i * f) for s, i, f in
                 zip(sizes, x.shape[sp_off:sp_off + n_spatial], sc)]
        if any(o <= 0 for o in sizes):
            raise ValueError(f"{op.type}: unresolved output size {sizes}")
    v2 = op.type.endswith("_v2")
    out = x
    for i, osz in enumerate(sizes):
        axis = sp_off + i
        taps = _interp_taps(x.shape[axis], int(osz),
                            bool(op.attr("align_corners", True)),
                            int(op.attr("align_mode", 1)), kind,
                            sc[i] if v2 else 0.0)
        acc = None
        for idx, w in taps:
            g = torch.index_select(out, axis, torch.as_tensor(
                idx, device=x.device))
            shape = [1] * x.ndim
            shape[axis] = len(w)
            g = g * torch.as_tensor(w, dtype=x.dtype,
                                    device=x.device).reshape(shape)
            acc = g if acc is None else acc + g
        out = acc
    return {"Out": [out]}


def _register_interp(kind, n_spatial, *names):
    def rule(ctx, op, ins):
        return _interp(op, ins, kind, n_spatial)

    for name in names:
        register_op(name)(rule)


_register_interp("nearest", 2, "nearest_interp", "nearest_interp_v2")
_register_interp("linear", 2, "bilinear_interp", "bilinear_interp_v2")
_register_interp("linear", 1, "linear_interp", "linear_interp_v2")
_register_interp("linear", 3, "trilinear_interp", "trilinear_interp_v2")
_register_interp("cubic", 2, "bicubic_interp", "bicubic_interp_v2")


# -- activations, norms --------------------------------------------------------

@register_op("prelu")
def _prelu(ctx, op, ins):
    """nn_ops.py:725-735: x where x >= 0, else alpha x; `mode` all (one
    alpha), channel (axis 1) or element."""
    x, alpha = first(ins, "X"), first(ins, "Alpha")
    mode = op.attr("mode", "all")
    if mode == "channel":
        a = _channel(alpha, x.ndim)
    elif mode == "element":
        a = alpha.reshape((1,) * (x.ndim - alpha.ndim) + tuple(alpha.shape))
    else:
        a = alpha.reshape(())
    return {"Out": [torch.where(x >= 0, x, a * x)]}


@register_op("maxout")
def _maxout(ctx, op, ins):
    """nn_ops.py:738-744: the max over each `groups` consecutive
    channels of axis 1.  The reference reads no `axis`: the rule raises
    on another one."""
    x = first(ins, "X")
    axis = op.attr("axis", 1)
    if axis is not None and axis % x.ndim != 1:
        raise NotImplementedError(
            f"maxout: axis {axis}: the reference reads no axis attr and "
            "takes axis 1")
    g = op.attr("groups", 1)
    n, c = x.shape[0], x.shape[1]
    return {"Out": [torch.amax(x.reshape((n, c // g, g) + tuple(
        x.shape[2:])), dim=2)]}


@register_op("selu")
def _selu(ctx, op, ins):
    x = first(ins, "X")
    scale = op.attr("scale", 1.0507009873554805)
    alpha = op.attr("alpha", 1.6732632423543772)
    return {"Out": [scale * torch.where(x > 0, x,
                                        alpha * torch.exp(x) - alpha)]}


@register_op("lrn")
def _lrn(ctx, op, ins):
    """nn_ops.py:1078-1099: mid = k + alpha * (the sum of x^2 over n
    channels around c, zero padded), out = x mid^-beta."""
    x = first(ins, "X")
    n = int(op.attr("n", 5))
    k, alpha = op.attr("k", 2.0), op.attr("alpha", 1e-4)
    beta = op.attr("beta", 0.75)
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    pre = (n - 1) // 2
    sq = torch.nn.functional.pad(x * x, (0, 0, 0, 0, pre, n - 1 - pre))
    acc = sq[:, 0:x.shape[1]]
    for i in range(1, n):
        acc = acc + sq[:, i:i + x.shape[1]]
    mid = k + alpha * acc
    out = x * torch.pow(mid, -beta)
    if nhwc:
        out, mid = out.permute(0, 2, 3, 1), mid.permute(0, 2, 3, 1)
    return {"Out": [out], "MidOut": [mid]}


@register_op("norm")
def _norm(ctx, op, ins):
    """x / sqrt(sum(x^2, axis) + eps); Norm is the divisor."""
    x = first(ins, "X")
    axis = int(op.attr("axis", 1)) % x.ndim
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True)
                      + op.attr("epsilon", 1e-10))
    return {"Out": [x / norm], "Norm": [norm]}


@register_op("spectral_norm")
def _spectral_norm(ctx, op, ins):
    """nn_ops.py:1125-1158: `power_iters` rounds of v = l2n(W^T u), u =
    l2n(W v) on the weight with `dim` first, sigma = u^T W v, Out = W /
    sigma; U and V, when the op declares them, are the refined
    vectors."""
    w = first(ins, "Weight")
    u, v = first(ins, "U").reshape(-1), first(ins, "V").reshape(-1)
    dim = int(op.attr("dim", 0))
    eps = op.attr("eps", 1e-12)
    perm = [dim] + [i for i in range(w.ndim) if i != dim]
    wm = w.permute(perm).reshape(w.shape[dim], -1)

    def l2n(a):
        return a / torch.sqrt(torch.sum(a * a) + eps)

    for _ in range(int(op.attr("power_iters", 1))):
        v = l2n(wm.T @ u)
        u = l2n(wm @ v)
    outs = {"Out": [w / (u @ wm @ v)]}
    if "U" in op.outputs:
        outs["U"] = [u]
    if "V" in op.outputs:
        outs["V"] = [v]
    return outs


@register_op("data_norm")
def _data_norm(ctx, op, ins):
    """nn_ops.py:778-801: (x - sum / size) sqrt(size / square_sum); the
    accumulators' updates when the op declares them."""
    x = first(ins, "X")
    bsize, bsum = first(ins, "BatchSize"), first(ins, "BatchSum")
    bsq = first(ins, "BatchSquareSum")
    means = bsum / bsize
    scales = torch.sqrt(bsize / bsq)
    outs = {"Y": [(x - means) * scales], "Means": [means],
            "Scales": [scales]}
    if "BatchSizeOut" in op.outputs:
        n = float(x.shape[0])
        outs["BatchSizeOut"] = [bsize + n]
        outs["BatchSumOut"] = [bsum + torch.sum(x, dim=0)]
        outs["BatchSquareSumOut"] = [
            bsq + torch.sum(torch.square(x - means), dim=0)
            + n * op.attr("epsilon", 1e-4)]
    return outs


# -- the loss tail (nn_ops.py:768-1071) ----------------------------------------

@register_op("hinge_loss")
def _hinge_loss(ctx, op, ins):
    logits = first(ins, "Logits")
    y = 2.0 * first(ins, "Labels").to(logits.dtype) - 1.0
    return {"Loss": [torch.clamp(1.0 - y * logits, min=0.0)]}


@register_op("nll_loss")
def _nll_loss(ctx, op, ins):
    """nn_ops.py:902-933: -x[label] weight[label], 0 at ignore_index;
    (N, C, H, W) inputs take (N, H, W) labels; 'mean' divides by the
    applied weights (when they are not 0)."""
    x = first(ins, "X")
    label = first(ins, "Label").long()
    weight = first(ins, "Weight")
    ignore = int(op.attr("ignore_index", -100))
    reduction = op.attr("reduction", "mean")
    xm = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1]) if x.ndim == 4 else x
    lab = label.reshape(-1)
    valid = lab != ignore
    safe = torch.clamp(lab, 0, x.shape[1] - 1)
    w = weight.reshape(-1)[safe] if weight is not None else \
        torch.ones(safe.shape, dtype=x.dtype, device=x.device)
    per = -torch.gather(xm, 1, safe[:, None])[:, 0] * w
    per = torch.where(valid, per, torch.zeros_like(per))
    tw = torch.sum(torch.where(valid, w, torch.zeros_like(w)))
    if reduction == "none":
        shape = label.shape if x.ndim == 4 else (x.shape[0],)
        return {"Out": [per.reshape(shape)],
                "Total_weight": [torch.zeros((), dtype=x.dtype,
                                             device=x.device)]}
    total = torch.sum(per)
    if reduction == "mean":
        total = torch.where(tw != 0, total / tw, total)
    return {"Out": [total.reshape(())], "Total_weight": [tw.reshape(())]}


@register_op("log_loss")
def _log_loss(ctx, op, ins):
    p, lab = first(ins, "Predicted"), first(ins, "Labels")
    eps = op.attr("epsilon", 1e-4)
    return {"Loss": [-(lab * torch.log(p + eps))
                     - (1.0 - lab) * torch.log(1.0 - p + eps)]}


@register_op("rank_loss")
def _rank_loss(ctx, op, ins):
    o = first(ins, "Left") - first(ins, "Right")
    return {"Out": [torch.log1p(torch.exp(o)) - first(ins, "Label") * o]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, op, ins):
    x1, x2 = first(ins, "X1"), first(ins, "X2")
    raw = -first(ins, "Label") * (x1 - x2) + op.attr("margin", 0.0)
    return {"Out": [torch.clamp(raw, min=0.0)],
            "Activated": [(raw > 0).to(x1.dtype)]}


@register_op("bpr_loss")
def _bpr_loss(ctx, op, ins):
    """nn_ops.py:969-981: per row, the mean of softplus(x_j - x_label)
    over the other classes."""
    x = first(ins, "X")
    label = first(ins, "Label").long().reshape(-1)
    c = x.shape[1]
    pos = torch.gather(x, 1, label[:, None])
    sp = torch.log1p(torch.exp(x - pos))
    mask = torch.nn.functional.one_hot(label, c).to(x.dtype)
    return {"Y": [torch.sum(sp * (1.0 - mask), dim=1, keepdim=True)
                  / (c - 1)]}


@register_op("center_loss")
def _center_loss(ctx, op, ins):
    """nn_ops.py:984-1007: diff = x - centers[label], loss = |diff|^2 / 2;
    with `need_update`, centers move by alpha times each class's summed
    diff over 1 + its count."""
    x = first(ins, "X")
    label = first(ins, "Label").long().reshape(-1)
    centers = first(ins, "Centers")
    alpha = first(ins, "CenterUpdateRate").reshape(-1)[0]
    diff = x - centers[label]
    outs = {"Loss": [0.5 * torch.sum(diff * diff, dim=1, keepdim=True)],
            "SampleCenterDiff": [diff]}
    if op.attr("need_update", True):
        c = centers.shape[0]
        acc = torch.zeros_like(centers).index_add(0, label, diff)
        cnt = 1.0 + torch.zeros(c, dtype=x.dtype, device=x.device) \
            .index_add(0, label, torch.ones_like(label, dtype=x.dtype))
        outs["CentersOut"] = [centers + alpha * acc / cnt[:, None]]
    else:
        outs["CentersOut"] = [centers]
    return outs


def _tree_paths(label, num_classes, dtype):
    """The complete binary tree's path of each label (nn_ops.py:834-849):
    node ids (pad -1) and 0/1 codes, root first."""
    depth = max(1, int(math.ceil(math.log2(max(num_classes, 2)))))
    node = label.reshape(-1).long() + (num_classes - 1)
    paths, codes = [], []
    for _ in range(depth):
        parent = torch.div(node - 1, 2, rounding_mode="floor")
        paths.append(torch.where(node > 0, parent, torch.full_like(node, -1)))
        codes.append((node % 2 == 0).to(dtype))
        node = parent
    return torch.stack(paths[::-1], dim=1), torch.stack(codes[::-1], dim=1)


@register_op("hierarchical_sigmoid")
def _hsigmoid(ctx, op, ins):
    """nn_ops.py:820-861: per sample, the sum over its tree path of the
    binary cross-entropy of w_node . x + b_node against the path code;
    PathTable/PathCode give a custom tree, else the complete binary tree
    over num_classes."""
    x, w = first(ins, "X"), first(ins, "W")
    bias = first(ins, "Bias")
    path, code = first(ins, "PathTable"), first(ins, "PathCode")
    if path is None:
        path, code = _tree_paths(first(ins, "Label"),
                                 int(op.attr("num_classes", 2)), x.dtype)
    p_idx = torch.clamp(path.long(), min=0)
    logits = torch.einsum("bpd,bd->bp", w[p_idx], x)
    if bias is not None:
        logits = logits + bias.reshape(-1)[p_idx]
    codef = code.to(logits.dtype)
    bce = (codef * -torch.nn.functional.logsigmoid(logits)
           + (1 - codef) * -torch.nn.functional.logsigmoid(-logits))
    bce = torch.where(path >= 0, bce, torch.zeros_like(bce))
    return {"Out": [torch.sum(bce, dim=1, keepdim=True)],
            "PreOut": [logits]}


@register_op("nce")
def _nce(ctx, op, ins):
    """nn_ops.py:864-895: the true classes against `num_neg_samples`
    classes drawn uniformly (from the op's generator: torch's bits);
    o = sigmoid(w . x + b), kq = K / total, cost = -sum log(o / (o + kq))
    over the true and -sum log(kq / (o + kq)) over the drawn."""
    x, label, w = first(ins, "Input"), first(ins, "Label"), \
        first(ins, "Weight")
    bias = first(ins, "Bias")
    total = int(op.attr("num_total_classes", w.shape[0]))
    k = int(op.attr("num_neg_samples", 10))
    b = x.shape[0]
    lab = label.long().reshape(b, -1)
    nt = lab.shape[1]
    if ctx.abstract:
        samples = torch.zeros((b, k), dtype=torch.long, device=x.device)
    else:
        samples = torch.randint(0, total, (b, k), generator=ctx.generator(op),
                                device=x.device)
    ids = torch.cat([lab, samples], dim=1)
    logits = torch.einsum("btd,bd->bt", w[ids], x)
    if bias is not None:
        logits = logits + bias.reshape(-1)[ids]
    o = torch.sigmoid(logits)
    kq = k / total
    pos = -torch.log(o[:, :nt] / (o[:, :nt] + kq)).sum(dim=1)
    neg = -torch.log(kq / (o[:, nt:] + kq)).sum(dim=1)
    return {"Cost": [(pos + neg).reshape(b, 1)], "SampleLogits": [o],
            "SampleLabels": [ids]}


@register_op("sample_logits")
def _sample_logits(ctx, op, ins):
    """nn_ops.py:1026-1071: the logits at the true and the sampled
    classes minus log q.  Without customized samples, `num_samples` ids
    are drawn log-uniformly with replacement (from the op's generator:
    torch's bits) and shared by the rows, q = 1 - (1 - p)^S for every
    column; accidental hits of a true label lose 1e20."""
    logits = first(ins, "Logits")
    labels = first(ins, "Labels").long()
    n, k = logits.shape
    if op.attr("use_customized_samples", False):
        samples = first(ins, "CustomizedSamples").long()
        probs = first(ins, "CustomizedProbabilities")
    else:
        s = int(op.attr("num_samples", 1))
        u = torch.rand((s,), generator=None if ctx.abstract
                       else ctx.generator(op), dtype=logits.dtype,
                       device=logits.device)
        neg = torch.clamp((torch.exp(u * math.log(k + 1.0)) - 1.0).long(),
                          0, k - 1)
        samples = torch.cat([labels, neg[None].expand(n, s)], dim=1)
        sf = samples.to(logits.dtype)
        p = (torch.log(sf + 2.0) - torch.log(sf + 1.0)) / math.log(k + 1.0)
        probs = -torch.expm1(s * torch.log1p(-p))
    sampled = torch.gather(logits, 1, samples)
    nt = labels.shape[1]
    if op.attr("remove_accidental_hits", True):
        hit = (samples[:, :, None] == labels[:, None, :]).any(-1)
        hit[:, :nt] = False
        sampled = sampled - 1e20 * hit.to(sampled.dtype)
    sampled = sampled - torch.log(probs)
    sampled_labels = torch.arange(nt, device=logits.device)[None].expand(
        n, nt)
    zeros2 = torch.zeros((2,), dtype=torch.int32, device=logits.device)
    return {"Samples": [samples], "Probabilities": [probs],
            "SampledLogits": [sampled], "SampledLabels": [sampled_labels],
            "LogitsDim": [zeros2], "LabelsDim": [zeros2.clone()]}
