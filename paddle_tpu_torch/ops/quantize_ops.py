"""Fake-quantization rules (counterpart of paddle_tpu/ops/quantize_ops.py):
the quantize-aware-training observers and the dequantizers.  With
bin_cnt = 2^(bits-1) - 1 and scale s,

    quant(x)   = round(bin_cnt / s * clip(x, -s, s))     (integer-valued)
    dequant(q) = q * s / bin_cnt

- `torch.round` rounds half to even, as `jnp.round` does.
- round() has zero gradient, so the quant-dequant forms carry the
  straight-through estimator in the rule: out = x + (q - x).detach(),
  the reference's x + stop_gradient(q - x).  The quantize-only forms'
  outputs are detached, as the reference stops their gradient.
- Observer state (scale, accum, state) comes out as new output tensors,
  slot for slot; nothing is changed in place.
"""

from __future__ import annotations

import torch

from .registry import first, register_op


def _bin_cnt(op):
    return float((1 << (int(op.attr("bit_length", 8)) - 1)) - 1)


def _quant(x, s, bin_cnt):
    s = torch.clamp(s, min=1e-9)
    return torch.round(bin_cnt / s * torch.clamp(x, -s, s))


def _quant_dequant_ste(x, s, bin_cnt):
    s = torch.clamp(s, min=1e-9)
    q = _quant(x, s, bin_cnt) * s / bin_cnt
    return x + (q - x).detach()  # straight-through


def _ones(x):
    return torch.ones((), dtype=x.dtype, device=x.device)


@register_op("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, op, ins):
    x = first(ins, "X")
    s = torch.abs(x).max()
    return {"Out": [_quant(x, s, _bin_cnt(op)).detach()],
            "OutScale": [s.reshape(1)]}


@register_op("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(ctx, op, ins):
    x = first(ins, "X")
    s = torch.abs(x).max().detach()
    return {"Out": [_quant_dequant_ste(x, s, _bin_cnt(op))],
            "OutScale": [s.reshape(1)]}


@register_op("fake_quantize_moving_average_abs_max")
@register_op("fake_quantize_dequantize_moving_average_abs_max")
def _fake_q_moving(ctx, op, ins):
    """The moving-average observer: state' = rate * state + 1, accum' =
    rate * accum + max|x|, scale = accum' / state' (InScale as is under
    is_test)."""
    x = first(ins, "X")
    in_scale = first(ins, "InScale").reshape(())
    bc = _bin_cnt(op)
    rate = op.attr("moving_rate", 0.9)
    dequant = op.type == "fake_quantize_dequantize_moving_average_abs_max"
    outs = {}
    if op.attr("is_test", False):
        scale = in_scale
    else:
        accum = first(ins, "InAccum", _ones(x)).reshape(())
        state = first(ins, "InState", _ones(x)).reshape(())
        cur = torch.abs(x).max().detach()
        state_out = rate * state + 1.0
        accum_out = rate * accum + cur
        scale = accum_out / state_out
        outs = {"OutState": [state_out.reshape(1)],
                "OutAccum": [accum_out.reshape(1)]}
    outs["OutScale"] = [scale.reshape(1)]
    outs["Out"] = [_quant_dequant_ste(x, scale, bc) if dequant
                   else _quant(x, scale, bc).detach()]
    return outs


@register_op("fake_quantize_range_abs_max")
def _fake_q_range(ctx, op, ins):
    """The window-max observer in the reference's monotone form: the
    scale is the larger of this batch's max|x| and InScale."""
    x = first(ins, "X")
    in_scale = first(ins, "InScale").reshape(())
    if op.attr("is_test", False):
        scale = in_scale
    else:
        scale = torch.maximum(torch.abs(x).max().detach(), in_scale)
    outs = {"Out": [_quant(x, scale, _bin_cnt(op)).detach()],
            "OutScale": [scale.reshape(1)]}
    if "OutScales" in op.outputs:
        outs["OutScales"] = [scale.reshape(1)]
    return outs


@register_op("fake_channel_wise_quantize_abs_max")
@register_op("fake_channel_wise_quantize_dequantize_abs_max")
def _fake_q_channel(ctx, op, ins):
    x = first(ins, "X")
    bc = _bin_cnt(op)
    axis = int(op.attr("quant_axis", 0))
    red = tuple(i for i in range(x.dim()) if i != axis)
    s = torch.clamp(torch.amax(torch.abs(x), dim=red, keepdim=True),
                    min=1e-9).detach()
    if op.type.endswith("dequantize_abs_max"):
        out = _quant_dequant_ste(x, s, bc)
    else:
        out = _quant(x, s, bc).detach()
    return {"Out": [out], "OutScale": [s.reshape(-1)]}


@register_op("fake_dequantize_max_abs")
def _fake_dequantize(ctx, op, ins):
    x = first(ins, "X")
    scale = first(ins, "Scale").reshape(())
    return {"Out": [x * scale / op.attr("max_range", 127.0)]}


@register_op("moving_average_abs_max_scale")
def _moving_scale(ctx, op, ins):
    """The observer alone: records the moving max|x|, passes X through."""
    x = first(ins, "X")
    rate = op.attr("moving_rate", 0.9)
    accum = first(ins, "InAccum", _ones(x)).reshape(())
    state = first(ins, "InState", _ones(x)).reshape(())
    cur = torch.abs(x).max().detach()
    state_out = rate * state + 1.0
    accum_out = rate * accum + cur
    outs = {"OutScale": [(accum_out / state_out).reshape(1)],
            "OutState": [state_out.reshape(1)],
            "OutAccum": [accum_out.reshape(1)]}
    if "Out" in op.outputs:
        outs["Out"] = [x]
    return outs


@register_op("dequantize_abs_max")
def _dequantize_abs_max(ctx, op, ins):
    """Int8 rows back to float: scale * x / max_range."""
    x = first(ins, "X")
    scale = first(ins, "Scale").reshape(())
    dt = torch.promote_types(torch.float32, scale.dtype)
    return {"Out": [x.to(dt) * scale / op.attr("max_range", 127.0)]}


@register_op("dequantize_log")
def _dequantize_log(ctx, op, ins):
    """Log-table dequantization: a code x < 0 reads -Dict[x + 128], else
    Dict[x]."""
    x = first(ins, "X").to(torch.long)
    table = first(ins, "Dict").reshape(-1)
    n = table.shape[0]
    neg = -table[torch.clamp(x + 128, 0, n - 1)]
    pos = table[torch.clamp(x, 0, n - 1)]
    return {"Out": [torch.where(x < 0, neg, pos)]}


@register_op("fake_channel_wise_dequantize_max_abs")
def _fake_channel_wise_dequantize_max_abs(ctx, op, ins):
    """One scale tensor: a per-channel (quant_axis) rescale; two (the
    weight's per-channel scales and the activation's scale): x * s1[c] *
    s2 / max_range with the channel on axis 1."""
    x = first(ins, "X")
    scales = ins.get("Scales") or []
    max_range = op.attr("max_range", 127.0)
    shape = [1] * x.dim()
    if len(scales) == 1:
        shape[int(op.attr("quant_axis", 0))] = -1
        return {"Out": [x * scales[0].reshape(-1).reshape(shape)
                        / max_range]}
    shape[1] = -1
    return {"Out": [x * scales[0].reshape(-1).reshape(shape)
                    * scales[1].reshape(()) / max_range]}
