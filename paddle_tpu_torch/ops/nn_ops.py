"""Neural-network rules (counterpart of paddle_tpu/ops/nn_ops.py): conv2d,
pool2d, batch_norm, lookup_table_v2, softmax_with_cross_entropy,
cross_entropy and accuracy; the losses of fluid.layers.loss
(sigmoid_cross_entropy_with_logits, bce_loss, huber_loss,
smooth_l1_loss, kldiv_loss) and cos_sim.

The convolution, pooling and batch-norm rules run the port's
`nn.functional` (cuDNN and ATen on the card), which keeps the reference
lowering's semantics: Paddle's padding forms, -inf max-pool padding,
exclusive average pooling, and batch norm's running statistics as
running * momentum + batch * (1 - momentum) with the biased batch variance.
"""

from __future__ import annotations

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
def _conv2d(ctx, op, ins):
    """nn_ops.py:77-103: OIHW weights whatever the data format."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    out = F.conv2d(
        x, w, None, stride=tuple(op.attr("strides", [1, 1])),
        padding=_paddings(op.attr("padding_algorithm", "EXPLICIT"),
                          op.attr("paddings", [0, 0])),
        dilation=tuple(op.attr("dilations", [1, 1])),
        groups=op.attr("groups", 1),
        data_format=_fmt(op.attr("data_format", "NCHW")))
    return {"Output": [out]}


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


@register_op("lookup_table_v2")
def _lookup_table(ctx, op, ins):
    """Rows of W at Ids; rows at `padding_idx` read as zeros
    (nn_ops.py:409-421)."""
    w, ids = first(ins, "W"), first(ins, "Ids")
    out = torch.nn.functional.embedding(ids, w)
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx != -1:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return {"Out": [out]}


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
