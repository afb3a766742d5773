"""Rules of the misc bucket (counterpart of paddle_tpu/ops/misc_ops.py):
auc, py_func, the long tail of framework and math ops
(add_position_encoding ... gaussian_random_batch_size_like),
average_accumulates (ModelAverage's windows) and the program io ops
save / save_combine / load / load_combine.

`run_program` waits for the jit port (ROADMAP queue 1 item 12).

Host work stays where the reference puts it: `py_func` calls its
registered Python function on host copies of its inputs (the reference's
`pure_callback`), and the io ops read and write files.  Every other rule
stays on the device; `random_crop` draws its offsets on a host generator
seeded as the op's device generator is, so slicing costs no sync.  The
random rules' bits are torch's, not JAX's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fluid import core
from .registry import first, register_op, tdt


def _declared(op, name, what):
    """(shape, torch dtype) of an output var whose shape the program
    fixes, as the reference's host-callback contract asks."""
    var = op.block._var_recursive(name)
    if var.shape is None or any(s is None or s < 0 for s in var.shape):
        raise ValueError(f"{what} output {name!r} needs a fully static "
                         "declared shape")
    return tuple(var.shape), core.torch_dtype(var.dtype)


@register_op("auc")
def _auc(ctx, op, ins):
    """misc_ops.py:19-72: scores of the positive class bucketed into
    num_thresholds + 1 bins, added to the persistable StatPos / StatNeg
    histograms (their updated values come out), and the ROC area by the
    trapezoid rule over the bins from the high threshold down.
    slide_steps > 0 raises, as in the reference."""
    predict, label = first(ins, "Predict"), first(ins, "Label")
    stat_pos, stat_neg = first(ins, "StatPos"), first(ins, "StatNeg")
    num_t = int(op.attr("num_thresholds", 4095))
    if int(op.attr("slide_steps", 0) or 0) != 0:
        raise NotImplementedError(
            "auc op: slide_steps>0 (windowed AUC) is not implemented; use "
            "the global accumulator (slide_steps=0)")
    pos_score = predict[:, 1] if predict.dim() == 2 and predict.shape[1] > 1 \
        else predict.reshape(-1)
    lab = label.reshape(-1).to(torch.int32)
    bucket = torch.clamp((pos_score * num_t).to(torch.int32), 0,
                         num_t).to(torch.int64)
    one = torch.ones(bucket.shape, dtype=stat_pos.dtype,
                     device=bucket.device)
    zero = torch.zeros_like(one)
    pos_new = stat_pos.reshape(-1).index_add(
        0, bucket, torch.where(lab == 1, one, zero))
    neg_new = stat_neg.reshape(-1).index_add(
        0, bucket, torch.where(lab == 0, one, zero))
    pos_r = pos_new.flip(0).to(torch.float32)
    neg_r = neg_new.flip(0).to(torch.float32)
    cum_pos = torch.cumsum(pos_r, 0)
    area = torch.sum(neg_r * (cum_pos + (cum_pos - pos_r)) / 2.0)
    tot = cum_pos[-1] * torch.sum(neg_r)
    auc = torch.where(tot > 0, area / torch.clamp(tot, min=1.0),
                      torch.zeros_like(area))
    return {"AUC": [auc], "StatPosOut": [pos_new.reshape(stat_pos.shape)],
            "StatNegOut": [neg_new.reshape(stat_neg.shape)]}


# -- py_func ----------------------------------------------------------------

_PY_FUNC_REGISTRY: list = []


def register_py_func(fn) -> int:
    """Register a host callable; returns the id the op's
    `forward_callable_id` attr stores."""
    _PY_FUNC_REGISTRY.append(fn)
    return len(_PY_FUNC_REGISTRY) - 1


@register_op("py_func")
def _py_func(ctx, op, ins):
    """misc_ops.py:75-110: the registered function runs on the host on
    numpy copies of the X inputs; each result becomes a tensor of its
    declared output's shape and dtype on the run's device.  No
    gradient flows through (the layer marks the outputs
    stop_gradient)."""
    specs = [_declared(op, n, "py_func") for n in op.output("Out")]
    if ctx.abstract:
        return {"Out": [torch.empty(s, dtype=d, device=ctx.device)
                        for s, d in specs]}
    fn = _PY_FUNC_REGISTRY[int(op.attr("forward_callable_id"))]
    xs = [v.detach().cpu().numpy() for v in ins.get("X", [])
          if v is not None]
    ctx.host_reads += len(xs)
    res = fn(*xs)
    if not isinstance(res, (list, tuple)):
        res = [res]
    return {"Out": [_loaded(ctx, r, spec) for r, spec in zip(res, specs)]}


# -- the long tail of framework and math ops ----------------------------------

@register_op("add_position_encoding")
def _add_position_encoding(ctx, op, ins):
    """misc_ops.py:140-158: alpha x + beta PE for x (B, T, D), PE's
    first D/2 columns sin(pos / 10000^(k / (D/2 - 1))), the rest cos."""
    x = first(ins, "X")
    _, t, d = x.shape
    half = d // 2
    pos = np.arange(t)[:, None]
    div = np.power(10000.0, np.arange(half) / (half - 1)) if half > 1 \
        else np.full((half,), 10000.0)
    pe = np.concatenate([np.sin(pos / div), np.cos(pos / div)], axis=1)
    pe = torch.from_numpy(pe).to(device=x.device, dtype=x.dtype)
    return {"Out": [op.attr("alpha", 1.0) * x
                    + op.attr("beta", 1.0) * pe[None]]}


@register_op("allclose")
def _allclose(ctx, op, ins):
    """|x - y| <= atol + rtol |y| everywhere, Rtol / Atol from their
    tensor inputs (the attrs as the fallback)."""
    x, y = first(ins, "Input"), first(ins, "Other")
    rtol_t, atol_t = first(ins, "Rtol"), first(ins, "Atol")
    rtol = rtol_t.reshape(()) if rtol_t is not None \
        else float(op.attr("rtol", 1e-5) or 1e-5)
    atol = atol_t.reshape(()) if atol_t is not None \
        else float(op.attr("atol", 1e-8) or 1e-8)
    close = torch.abs(x - y) <= atol + rtol * torch.abs(y)
    if op.attr("equal_nan", False):
        close = close | (torch.isnan(x) & torch.isnan(y))
    return {"Out": [torch.all(close)]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, op, ins):
    """misc_ops.py:180-191: out[:, k] = x W[k] y^T + bias[k], for X (B,
    M), Y (B, N) and Weight (K, M, N)."""
    x, y, w = first(ins, "X"), first(ins, "Y"), first(ins, "Weight")
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    bias = first(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": [out]}


@register_op("conv_shift")
def _conv_shift(ctx, op, ins):
    """misc_ops.py:194-207 (NTM circular convolution): out[b, i] =
    sum_j x[b, (i + j - (N-1)/2) mod M] y[b, j]."""
    x, y = first(ins, "X"), first(ins, "Y")
    n = y.shape[1]
    half = (n - 1) // 2
    out = sum(torch.roll(x, half - j, dims=1) * y[:, j][:, None]
              for j in range(n))
    return {"Out": [out]}


@register_op("cvm")
def _cvm(ctx, op, ins):
    """misc_ops.py:265-277: with use_cvm the (show, click) prefix as
    log(show + 1), log(click + 1) - log(show + 1); else dropped."""
    x = first(ins, "X")
    if bool(op.attr("use_cvm", True)):
        show = torch.log(x[:, :1] + 1.0)
        clk = torch.log(x[:, 1:2] + 1.0) - show
        return {"Y": [torch.cat([show, clk, x[:, 2:]], dim=1)]}
    return {"Y": [x[:, 2:]]}


@register_op("diag")
def _diag(ctx, op, ins):
    return {"Out": [torch.diag(first(ins, "Diagonal").reshape(-1))]}


@register_op("diag_embed")
def _diag_embed(ctx, op, ins):
    """misc_ops.py:285-304: the last dim of Input on the offset diagonal
    of a new square pair of dims, placed at dim1 / dim2."""
    x = first(ins, "Input")
    offset = int(op.attr("offset", 0))
    m = x.shape[-1]
    n = m + abs(offset)
    out = torch.zeros(tuple(x.shape[:-1]) + (n, n), dtype=x.dtype,
                      device=x.device)
    idx = torch.arange(m, device=x.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = x
    nd = out.dim()
    d1, d2 = int(op.attr("dim1", -2)) % nd, int(op.attr("dim2", -1)) % nd
    perm = [i for i in range(nd) if i not in (nd - 2, nd - 1)]
    for pos, src in sorted([(d1, nd - 2), (d2, nd - 1)]):
        perm.insert(pos, src)
    return {"Out": [out.permute(perm)]}


@register_op("empty")
def _empty(ctx, op, ins):
    """Zeros of `shape` (the reference's choice for uninitialized)."""
    return {"Out": [torch.zeros([int(s) for s in op.attr("shape", [])],
                                dtype=tdt(op.attr("dtype", "float32")),
                                device=ctx.device)]}


@register_op("fc")
def _fc(ctx, op, ins):
    """misc_ops.py:313-331: Input flattened at in_num_col_dims, times W,
    plus Bias; activation_type "" or relu (others raise, as in the
    reference)."""
    x, w, bias = first(ins, "Input"), first(ins, "W"), first(ins, "Bias")
    lead = tuple(x.shape[:int(op.attr("in_num_col_dims", 1))])
    out = x.reshape(int(np.prod(lead)), -1) @ w
    if bias is not None:
        out = out + bias.reshape(1, -1)
    act = op.attr("activation_type", "")
    if act == "relu":
        out = torch.relu(out)
    elif act:
        raise NotImplementedError(f"fc activation {act}")
    return {"Out": [out.reshape(lead + (w.shape[1],))]}


@register_op("fill")
def _fill(ctx, op, ins):
    shape = [int(s) for s in op.attr("shape", [])]
    vals = torch.tensor(list(op.attr("value", [])),
                        dtype=tdt(op.attr("dtype", "float32")))
    return {"Out": [vals.reshape(shape).to(ctx.device)]}


@register_op("fill_zeros_like2")
def _fill_zeros_like2(ctx, op, ins):
    return {"Out": [torch.zeros_like(first(ins, "X"),
                                     dtype=tdt(op.attr("dtype",
                                                       "float32")))]}


@register_op("grad_add")
def _grad_add(ctx, op, ins):
    return {"Out": [first(ins, "X") + first(ins, "Y")]}


@register_op("is_empty")
def _is_empty(ctx, op, ins):
    """A 0-d bool, whether X has no elements (known from its shape)."""
    return {"Out": [torch.full((), first(ins, "X").numel() == 0,
                               dtype=torch.bool, device=ctx.device)]}


@register_op("l1_norm")
def _l1_norm(ctx, op, ins):
    return {"Out": [torch.sum(torch.abs(first(ins, "X")))]}


def _count(idx, weights, n):
    return torch.zeros(n, dtype=weights.dtype, device=idx.device) \
        .index_add(0, idx, weights)


@register_op("mean_iou")
def _mean_iou(ctx, op, ins):
    """misc_ops.py:363-391: correct counts by predicted class, wrong
    counts by label and by prediction, the running InWrongs /
    InCorrects / InMeanIou added; the mean IoU over the classes with a
    nonzero denominator (float32), the counts as int32."""
    pred = first(ins, "Predictions").to(torch.int64).reshape(-1)
    lab = first(ins, "Labels").to(torch.int64).reshape(-1)
    nc = int(op.attr("num_classes"))
    hit = (pred == lab).to(torch.int64)
    miss = 1 - hit
    pc, lc = torch.clamp(pred, 0, nc - 1), torch.clamp(lab, 0, nc - 1)
    correct = _count(pc, hit, nc)
    wrong = _count(lc, miss, nc) + _count(pc, miss, nc)
    for extra in ins.get("InWrongs") or []:
        wrong = wrong + extra.to(wrong.dtype)
    for extra in ins.get("InCorrects") or []:
        correct = correct + extra.to(correct.dtype)
    denom = wrong + correct
    valid = torch.sum((denom > 0).to(torch.int64))
    denom_safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    iou = torch.sum(correct.to(torch.float32) / denom_safe.to(torch.float32))
    mean = iou / torch.clamp(valid.to(torch.float32), min=1.0)
    for extra in ins.get("InMeanIou") or []:
        mean = mean + extra.reshape(()).to(mean.dtype)
    return {"OutMeanIou": [mean], "OutWrong": [wrong.to(torch.int32)],
            "OutCorrect": [correct.to(torch.int32)]}


@register_op("minus")
def _minus(ctx, op, ins):
    return {"Out": [first(ins, "X") - first(ins, "Y")]}


@register_op("modified_huber_loss")
def _modified_huber_loss(ctx, op, ins):
    """misc_ops.py:399-409: with z = 2y - 1, -4xz below -1, (1 - xz)^2
    below 1, else 0; IntermediateVal is xz."""
    x, y = first(ins, "X"), first(ins, "Y")
    xz = x * (2.0 * y - 1.0)
    out = torch.where(xz < -1.0, -4.0 * xz,
                      torch.where(xz < 1.0, torch.square(1.0 - xz),
                                  torch.zeros_like(xz)))
    return {"Out": [out], "IntermediateVal": [xz]}


@register_op("sampling_id")
def _sampling_id(ctx, op, ins):
    """One column a row of X, drawn with probability X[row] (+1e-20, the
    reference's log floor), as int64 (B,)."""
    x = first(ins, "X")
    if ctx.abstract:
        return {"Out": [torch.empty(x.shape[0], dtype=torch.int64,
                                    device=ctx.device)]}
    idx = torch.multinomial(x.to(torch.float32) + 1e-20, 1,
                            generator=ctx.generator(op))
    return {"Out": [idx.reshape(-1)]}


@register_op("seed")
def _seed(ctx, op, ins):
    """The `seed` attr as an int32 (1,); with seed 0 a draw on [1,
    2^31 - 1) from the op's generator."""
    s = int(op.attr("seed", 0))
    if s:
        return {"Out": [torch.full((1,), s, dtype=torch.int32,
                                   device=ctx.device)]}
    out = torch.empty((1,), dtype=torch.int32, device=ctx.device)
    if not ctx.abstract:
        out = torch.randint(1, 2 ** 31 - 1, (1,), dtype=torch.int32,
                            generator=ctx.generator(op), device=ctx.device)
    return {"Out": [out]}


@register_op("shard_index")
def _shard_index(ctx, op, ins):
    """misc_ops.py:434-444: shard size ceil(index_num / nshards); an id
    of this shard becomes id mod size, any other ignore_value."""
    x = first(ins, "X")
    nshards = int(op.attr("nshards"))
    ssize = (int(op.attr("index_num")) + nshards - 1) // nshards
    mine = torch.div(x, ssize, rounding_mode="floor") \
        == int(op.attr("shard_id"))
    return {"Out": [torch.where(mine, torch.remainder(x, ssize),
                                torch.full_like(x, int(op.attr(
                                    "ignore_value", -1))))]}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, op, ins):
    """Row sums of (x - y)^2 as (N, 1); Y may be one row; sub_result is
    the difference."""
    x, y = first(ins, "X"), first(ins, "Y")
    sub = x.reshape(x.shape[0], -1) - y.reshape(y.shape[0], -1)
    return {"Out": [torch.sum(sub * sub, dim=1, keepdim=True)],
            "sub_result": [sub]}


@register_op("teacher_student_sigmoid_loss")
def _teacher_student_sigmoid_loss(ctx, op, ins):
    """misc_ops.py:458-475: the label encodes (clicked, teacher score):
    < -1: bce(x, 0); < 0: bce(x, 1); < 1: bce(x, 0) + bce(x, label);
    else bce(x, 1) + bce(x, label - 1), bce the stable form."""
    x = first(ins, "X").reshape(-1)
    lab = first(ins, "Label").reshape(-1).to(x.dtype)

    def bce(z):
        return torch.clamp(x, min=0.0) - x * z \
            + torch.log1p(torch.exp(-torch.abs(x)))

    out = torch.where(
        lab < -1.0, bce(0.0),
        torch.where(lab < 0.0, bce(1.0),
                    torch.where(lab < 1.0, bce(0.0) + bce(lab),
                                bce(1.0) + bce(lab - 1.0))))
    return {"Y": [out.reshape(-1, 1)]}


def _partial(xs, op):
    start, length = int(op.attr("start_index", 0)), \
        int(op.attr("length", -1))
    for x in xs:
        s = start if start >= 0 else x.shape[1] + start
        yield x[:, s:x.shape[1] if length < 0 else s + length]


@register_op("partial_concat")
def _partial_concat(ctx, op, ins):
    """The [start, start + length) columns of each X, concatenated."""
    return {"Out": [torch.cat(list(_partial(ins.get("X") or [], op)),
                              dim=1)]}


@register_op("partial_sum")
def _partial_sum(ctx, op, ins):
    """The same column slices, summed."""
    acc = None
    for sl in _partial(ins.get("X") or [], op):
        acc = sl if acc is None else acc + sl
    return {"Out": [acc]}


@register_op("fsp")
def _fsp(ctx, op, ins):
    """The FSP matrix x_flat y_flat^T / (H W) of (B, C1, H, W) and (B,
    C2, H, W)."""
    x, y = first(ins, "X"), first(ins, "Y")
    b, c1 = x.shape[:2]
    hw = x.shape[2] * x.shape[3]
    return {"Out": [torch.einsum("bch,bdh->bcd", x.reshape(b, c1, hw),
                                 y.reshape(b, y.shape[1], hw)) / hw]}


@register_op("random_crop")
def _random_crop(ctx, op, ins):
    """The trailing len(shape) dims cropped to `shape` at offsets drawn
    uniformly (on a host generator: no sync); SeedOut is Seed."""
    x = first(ins, "X")
    shape = [int(s) for s in op.attr("shape")]
    lead = x.dim() - len(shape)
    if ctx.abstract:
        return {"Out": [x.new_empty(tuple(x.shape[:lead]) + tuple(shape))],
                "SeedOut": [first(ins, "Seed")]}
    g = ctx.generator(op, device="cpu")
    out = x
    for i, s in enumerate(shape):
        dim = lead + i
        start = int(torch.randint(0, x.shape[dim] - s + 1, (), generator=g))
        out = out.narrow(dim, start, s)
    return {"Out": [out], "SeedOut": [first(ins, "Seed")]}


@register_op("gaussian_random_batch_size_like")
def _gaussian_random_batch_size_like(ctx, op, ins):
    """N(mean, std^2) of `shape`, its output_dim_idx dim taken from
    Input's input_dim_idx dim."""
    shape = [int(s) for s in op.attr("shape")]
    shape[int(op.attr("output_dim_idx", 0))] = \
        first(ins, "Input").shape[int(op.attr("input_dim_idx", 0))]
    dt = tdt(op.attr("dtype", "float32"))
    if ctx.abstract:
        return {"Out": [torch.empty(shape, dtype=dt, device=ctx.device)]}
    x = torch.randn(shape, generator=ctx.generator(op), dtype=dt,
                    device=ctx.device)
    return {"Out": [op.attr("mean", 0.0) + op.attr("std", 1.0) * x]}


@register_op("average_accumulates")
def _average_accumulates(ctx, op, ins):
    """misc_ops.py:552-592 (ModelAverage's windows): each step sum_1 +=
    param; every 16384 updates sum_2 += sum_1, sum_1 = 0; once
    num_accumulates reaches both min_average_window and min(
    max_average_window, num_updates average_window) the window rolls:
    sum_3 = sum_1 + sum_2, sum_1 = sum_2 = 0, old_num_accumulates =
    num_accumulates, num_accumulates = 0.  The counts stay on the
    device, int64 (1,)."""
    param = first(ins, "param")
    s1, s2, s3 = (first(ins, f"in_sum_{i}") for i in (1, 2, 3))
    num_acc = first(ins, "in_num_accumulates").reshape(()).to(torch.int64)
    old_num = first(ins, "in_old_num_accumulates").reshape(()).to(
        torch.int64)
    num_upd = first(ins, "in_num_updates").reshape(()).to(torch.int64) + 1
    num_acc = num_acc + 1
    s1 = s1 + param
    batch = torch.remainder(num_upd, 16384) == 0  # kMaxNumAccumulates
    s2 = torch.where(batch, s2 + s1, s2)
    s1 = torch.where(batch, torch.zeros_like(s1), s1)
    window = torch.clamp(
        (num_upd.to(torch.float32)
         * op.attr("average_window", 0.0)).to(torch.int64),
        max=int(op.attr("max_average_window", 10000)))
    roll = (num_acc >= int(op.attr("min_average_window", 10000))) \
        & (num_acc >= window)
    s3 = torch.where(roll, s1 + s2, s3)
    s1 = torch.where(roll, torch.zeros_like(s1), s1)
    s2 = torch.where(roll, torch.zeros_like(s2), s2)
    old_num = torch.where(roll, num_acc, old_num)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
            "out_num_accumulates": [num_acc.reshape(1)],
            "out_old_num_accumulates": [old_num.reshape(1)],
            "out_num_updates": [num_upd.reshape(1)]}


# -- program io ops (misc_ops.py:595-698) --------------------------------------
#
# The reference's formats: `save` (and a `save_combine` of one tensor)
# writes framework_io's pickle of the array; a `save_combine` of several
# writes an npz keyed t0..tN in input order, to `file_path` + ".npz"
# unless the path ends so.  A file written by either package loads in the
# other.  Writing reads the tensors to the host.

def _npz(path):
    return path if path.endswith(".npz") else path + ".npz"


def _host_save(ctx, path, xs):
    from .. import framework_io

    if ctx.abstract:
        return
    arrs = [x.detach().cpu().numpy() for x in xs]
    ctx.host_reads += len(arrs)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if len(arrs) == 1:
        framework_io.save(arrs[0], path)
    else:
        np.savez(_npz(path), **{f"t{i}": a for i, a in enumerate(arrs)})


def _fp16(op, xs):
    if op.attr("save_as_fp16", False):
        return [x.to(torch.float16) for x in xs]
    return xs


@register_op("save")
def _save_op(ctx, op, ins):
    _host_save(ctx, op.attr("file_path"), _fp16(op, [first(ins, "X")]))
    return {}


@register_op("save_combine")
def _save_combine_op(ctx, op, ins):
    _host_save(ctx, op.attr("file_path"),
               _fp16(op, [v for v in ins.get("X", []) if v is not None]))
    return {}


def _loaded(ctx, arr, spec):
    shape, dt = spec
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr).reshape(shape))).to(device=ctx.device, dtype=dt)


@register_op("load")
def _load_op(ctx, op, ins):
    """`file_path` into Out, of its declared shape and dtype."""
    from .. import framework_io

    spec = _declared(op, op.output("Out")[0], "load")
    if ctx.abstract:
        return {"Out": [torch.empty(spec[0], dtype=spec[1],
                                    device=ctx.device)]}
    return {"Out": [_loaded(ctx, framework_io.load(op.attr("file_path")),
                            spec)]}


@register_op("load_combine")
def _load_combine_op(ctx, op, ins):
    """One npz bundle into the Out vars, t0..tN in output order."""
    specs = [_declared(op, n, "load_combine") for n in op.output("Out")]
    if ctx.abstract:
        return {"Out": [torch.empty(s, dtype=d, device=ctx.device)
                        for s, d in specs]}
    data = np.load(_npz(op.attr("file_path")))
    return {"Out": [_loaded(ctx, data[f"t{i}"], spec)
                    for i, spec in enumerate(specs)]}
