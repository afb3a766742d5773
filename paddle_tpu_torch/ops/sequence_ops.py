"""Sequence rules (counterpart of paddle_tpu/ops/sequence_ops.py):
sequence_pool and sequence_conv, the two the book's sentiment program
needs.

A sequence batch is a padded dense tensor X (B, T, ...) with a Length
(B,) beside it (full rows without one), as in the reference's dense
re-design of LoD.
"""

from __future__ import annotations

import torch

from .registry import first, register_op


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
