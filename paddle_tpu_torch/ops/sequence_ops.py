"""Sequence rules (counterpart of paddle_tpu/ops/sequence_ops.py): all
17 of its op types.

A sequence batch is a padded dense tensor X (B, T, ...) with a Length
(B,) beside it (full rows without one), as in the reference's dense
re-design of LoD; there is no LoD.  The rules that drop steps
(sequence_unpad, sequence_erase, sequence_slice, sequence_concat) keep
the static shape, with each row's survivors moved to its front by a
stable sort on the invalid mask and the rest zero, and give the new
lengths where the reference does.
"""

from __future__ import annotations

import torch

from .registry import first, register_op, tdt


def _lens(ins, x):
    ln = first(ins, "Length", None)
    if ln is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.long,
                          device=x.device)
    return ln.reshape(x.shape[0]).long()


def _valid(x, lens):
    """(B, T, 1, ...) mask of the steps below each row's length."""
    t = torch.arange(x.shape[1], device=x.device)
    mask = t[None, :] < lens[:, None]
    return mask.reshape(mask.shape + (1,) * (x.ndim - 2))


@register_op("sequence_pool")
def _sequence_pool(ctx, op, ins):
    """Each row's valid prefix pooled (sequence_ops.py:79-120): SUM,
    AVERAGE / MEAN, SQRT (sum over sqrt(length)), MAX, LAST or FIRST;
    an empty row gives `pad_value`.  MaxIndex (int32) when declared."""
    x = first(ins, "X")
    lens = _lens(ins, x)
    mask = _valid(x, lens)
    pooltype = op.attr("pooltype", "SUM").upper()
    lead = (-1,) + (1,) * (x.ndim - 2)
    denom = torch.clamp(lens, min=1).to(x.dtype).reshape(lead)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    if pooltype == "SUM":
        out = torch.where(mask, x, zero).sum(1)
    elif pooltype in ("AVERAGE", "MEAN"):
        out = torch.where(mask, x, zero).sum(1) / denom
    elif pooltype == "SQRT":
        out = torch.where(mask, x, zero).sum(1) / torch.sqrt(denom)
    elif pooltype == "MAX":
        out = torch.amax(torch.where(mask, x, neg), dim=1)
    elif pooltype == "LAST":
        idx = torch.clamp(lens - 1, min=0).reshape((-1, 1) + lead[1:])
        out = torch.gather(x, 1, idx.expand((-1, 1) + x.shape[2:]))[:, 0]
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"sequence_pool: unknown pooltype {pooltype}")
    empty = (lens == 0).reshape(lead)
    out = torch.where(empty, torch.full_like(out, op.attr("pad_value", 0.0)),
                      out)
    outs = {"Out": [out]}
    if "MaxIndex" in op.outputs:
        outs["MaxIndex"] = [torch.argmax(torch.where(mask, x, neg),
                                         dim=1).to(torch.int32)]
    return outs


@register_op("sequence_conv")
def _sequence_conv(ctx, op, ins):
    """The context-window projection (sequence_ops.py:283-312): each
    valid step's window [t + contextStart, t + contextStart +
    contextLength) of D-wide features, zeros outside the row, concatenated
    and multiplied by Filter (contextLength * D, M); steps past the row's
    length give 0."""
    x, w = first(ins, "X"), first(ins, "Filter")
    lens = _lens(ins, x)
    clen = int(op.attr("contextLength", op.attr("context_length", 3)))
    cstart = int(op.attr("contextStart", op.attr("context_start",
                                                 -(clen - 1) // 2)))
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    cols = []
    for k in range(clen):
        at = pos + cstart + k
        g = x[:, torch.clamp(at, 0, t - 1)]
        ok = (at[None, :] >= 0) & (at[None, :] < lens[:, None])
        cols.append(torch.where(ok[..., None], g, torch.zeros_like(g)))
    out = torch.cat(cols, dim=-1) @ w
    valid = pos[None, :] < lens[:, None]
    return {"Out": [torch.where(valid[..., None], out,
                                torch.zeros_like(out))]}


def _front_pack(vals, valid):
    """Each row's valid steps moved to its front in order, the rest zero
    (sequence_ops.py:50-61); vals (B, T, ...), valid (B, T) bool.
    Returns (packed, count of valid steps a row)."""
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    idx = order.reshape(order.shape + (1,) * (vals.ndim - 2))
    packed = torch.gather(vals, 1, idx.expand(vals.shape))
    n_valid = valid.sum(1)
    keep = _valid(packed, n_valid)
    return torch.where(keep, packed, torch.zeros_like(packed)), n_valid


@register_op("sequence_mask")
def _sequence_mask(ctx, op, ins):
    """Lengths (any shape) -> a 0/1 mask with a last axis of `maxlen`
    (from MaxLenTensor, else the attr), in `out_dtype`; a negative
    maxlen raises, as the reference needs a static one (:64-80)."""
    x = first(ins, "X")
    mt = first(ins, "MaxLenTensor")
    maxlen = int(op.attr("maxlen", -1) if mt is None else mt.reshape(()))
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen: pass "
                         "maxlen=... instead of deriving it from the data")
    pos = torch.arange(maxlen, device=x.device)
    mask = pos < x.long().reshape(-1, 1)
    return {"Y": [mask.reshape(tuple(x.shape) + (maxlen,)).to(
        tdt(op.attr("out_dtype", "int64")))]}


@register_op("sequence_softmax")
def _sequence_softmax(ctx, op, ins):
    """Softmax over each row's valid prefix; the padding gets 0 (an
    empty row gives NaN before the mask, as in the reference)."""
    x = first(ins, "X")
    mask = _valid(x, _lens(ins, x))
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    p = torch.softmax(torch.where(mask, x, neg), dim=1)
    return {"Out": [torch.where(mask, p, torch.zeros_like(p))]}


@register_op("sequence_reverse")
def _sequence_reverse(ctx, op, ins):
    """Each row's valid prefix reversed, the padding in place."""
    x = first(ins, "X")
    lens = _lens(ins, x)
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return {"Y": [torch.gather(x, 1, idx.expand(x.shape))]}


@register_op("sequence_expand")
@register_op("sequence_expand_as")
def _sequence_expand_as(ctx, op, ins):
    """Each row of X (B, D...) or (B, 1, D...) repeated over Y's time
    axis (B, T, ...) and zeroed past the row's length (Length, or Y's
    full rows); sequence_expand is its dense collapse (:145-162)."""
    x, y = first(ins, "X"), first(ins, "Y")
    if x.ndim >= 3 and x.shape[1] == 1:
        x = x[:, 0]
    out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    mask = _valid(out, _lens(ins, y))
    return {"Out": [torch.where(mask, out, torch.zeros_like(out))]}


@register_op("sequence_pad")
def _sequence_pad(ctx, op, ins):
    """Rows cut or zero-extended to `padded_length` (-1: T), each row's
    valid prefix kept and the rest PadValue; Length as int64."""
    x = first(ins, "X")
    lens = _lens(ins, x)
    pad_v = first(ins, "PadValue")
    plen = int(op.attr("padded_length", -1))
    plen = x.shape[1] if plen < 0 else plen
    if plen > x.shape[1]:
        x = torch.cat([x, x.new_zeros((x.shape[0], plen - x.shape[1])
                                      + tuple(x.shape[2:]))], dim=1)
    else:
        x = x[:, :plen]
    fill = (torch.zeros((), dtype=x.dtype, device=x.device) if pad_v is None
            else pad_v.to(x.dtype))
    return {"Out": [torch.where(_valid(x, lens), x, fill)],
            "Length": [lens.long()]}


@register_op("sequence_unpad")
def _sequence_unpad(ctx, op, ins):
    """Every valid step front-packed into a flat (B*T, ...) buffer, row
    b's from sum(Length[:b]), the tail zero."""
    x = first(ins, "X")
    lens = _lens(ins, x)
    t = torch.arange(x.shape[1], device=x.device)
    vflat = (t[None, :] < lens[:, None]).reshape(-1)
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    order = torch.sort((~vflat).to(torch.uint8), stable=True).indices
    packed = flat[order]
    keep = torch.arange(flat.shape[0], device=x.device) < lens.sum()
    keep = keep.reshape((-1,) + (1,) * (packed.ndim - 1))
    return {"Out": [torch.where(keep, packed, torch.zeros_like(packed))]}


@register_op("sequence_concat")
def _sequence_concat(ctx, op, ins):
    """The i-th rows of the inputs joined in time (B, T1 + T2 + ..., ...),
    each row's segments front-packed; OutLength the summed lengths."""
    xs = [v for v in ins.get("X", []) if v is not None]
    lens_in = ins.get("Length", [])
    valid = []
    for i, x in enumerate(xs):
        ln = lens_in[i] if i < len(lens_in) else None
        ln = (torch.full((x.shape[0],), x.shape[1], dtype=torch.long,
                         device=x.device) if ln is None
              else ln.reshape(x.shape[0]).long())
        valid.append(torch.arange(x.shape[1], device=x.device)[None, :]
                     < ln[:, None])
    packed, n = _front_pack(torch.cat(xs, dim=1), torch.cat(valid, dim=1))
    return {"Out": [packed], "OutLength": [n.long()]}


@register_op("sequence_erase")
def _sequence_erase(ctx, op, ins):
    """Every step equal to one of `tokens` dropped, the survivors
    front-packed; OutLength the new lengths."""
    x = first(ins, "X")
    lens = _lens(ins, x)
    valid = torch.arange(x.shape[1], device=x.device)[None, :] \
        < lens[:, None]
    for tok in op.attr("tokens", []) or []:
        valid = valid & (x != tok)
    packed, n = _front_pack(x[..., None], valid)
    return {"Out": [packed[..., 0]], "OutLength": [n.long()]}


@register_op("sequence_slice")
def _sequence_slice(ctx, op, ins):
    """Each row's steps [Offset, Offset + Length) moved to its front, the
    rest zero."""
    x = first(ins, "X")
    offset = first(ins, "Offset").reshape(x.shape[0]).long()
    length = first(ins, "Length").reshape(x.shape[0]).long()
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = torch.clamp(offset[:, None] + t, 0, x.shape[1] - 1)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    shifted = torch.gather(x, 1, idx.expand(x.shape))
    keep = _valid(x, length)
    return {"Out": [torch.where(keep, shifted, torch.zeros_like(shifted))]}


@register_op("sequence_enumerate")
def _sequence_enumerate(ctx, op, ins):
    """(B, T, win_size) windows of the ids from each step; positions at
    or past the row's length give `pad_value`."""
    x = first(ins, "X")
    if x.ndim == 2 and x.shape[-1] == 1:
        x = x[..., 0]
    lens = _lens(ins, x)
    win = int(op.attr("win_size", 2))
    b, t = x.shape
    pos = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(win, device=x.device)[None, :])
    idx = torch.clamp(pos, 0, t - 1).reshape(1, -1).expand(b, -1)
    gathered = torch.gather(x, 1, idx).reshape(b, t, win)
    ok = pos[None] < lens[:, None, None]
    pad = torch.full((), op.attr("pad_value", 0), dtype=x.dtype,
                     device=x.device)
    return {"Out": [torch.where(ok, gathered, pad)]}


@register_op("im2sequence")
def _im2sequence(ctx, op, ins):
    """`kernels`-sized patches of X (N, C, H, W) at `strides` over the
    padded image, each flattened in (C, kh, kw) order: (N, oh * ow,
    C * kh * kw).  The ImgRealSize input (Y) raises, as in the
    reference."""
    x = first(ins, "X")
    if first(ins, "Y") is not None:
        raise NotImplementedError(
            "im2sequence: ImgRealSize (per-image output shapes) is a "
            "dynamic-shape path; pad to a common size")
    kh, kw = [int(k) for k in op.attr("kernels", [1, 1])]
    sh, sw = [int(s) for s in op.attr("strides", [1, 1])]
    pads = [int(p) for p in op.attr("paddings", [0, 0, 0, 0])]
    n, c, h, w = x.shape
    xp = torch.nn.functional.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    oh = (h + pads[0] + pads[2] - kh) // sh + 1
    ow = (w + pads[1] + pads[3] - kw) // sw + 1
    taps = [xp[:, :, ki:ki + oh * sh:sh, kj:kj + ow * sw:sw]
            for ki in range(kh) for kj in range(kw)]
    out = torch.stack(taps, dim=2).permute(0, 3, 4, 1, 2)
    return {"Out": [out.reshape(n, oh * ow, c * kh * kw)]}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, op, ins):
    """(B, T, D) -> (B, T * D / new_dim, new_dim)."""
    x = first(ins, "X")
    nd = int(op.attr("new_dim", x.shape[-1]))
    return {"Out": [x.reshape(x.shape[0], -1, nd)]}


@register_op("sequence_scatter")
def _sequence_scatter(ctx, op, ins):
    """Out = X (B, D), then out[i, Ids[i, j]] += Updates[i, j]; a negative
    id is padding and an id past D is dropped."""
    x = first(ins, "X")
    b, d = x.shape[0], x.shape[1]
    ids = first(ins, "Ids").reshape(b, -1).long()
    upd = first(ins, "Updates").reshape(b, -1)
    ok = (ids >= 0) & (ids < d)
    return {"Out": [x.scatter_add(
        1, torch.where(ok, ids, torch.zeros_like(ids)),
        torch.where(ok, upd.to(x.dtype), torch.zeros((), dtype=x.dtype,
                                                     device=x.device)))]}


@register_op("lod_reset")
def _lod_reset(ctx, op, ins):
    """The payload unchanged: lengths travel as their own tensors, so a
    new LoD has nothing to re-attach to."""
    return {"Out": [first(ins, "X")]}
