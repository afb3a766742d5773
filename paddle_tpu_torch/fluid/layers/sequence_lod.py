"""Sequence layers (counterpart of paddle_tpu/fluid/layers/
sequence_lod.py): sequence_conv and sequence_pool, with
sequence_first_step and sequence_last_step over the pool.  A sequence
is a padded dense tensor with an optional `length` (B,) beside it, as in
the reference; the rest of its sequence layers wait for their rules
(ROADMAP queue 1 item 8)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["sequence_conv", "sequence_pool", "sequence_first_step",
           "sequence_last_step"]


def _seq_op(op_type, inputs, attrs=None, n_outs=("Out",), dtype=None,
            name=None):
    """n_outs: slot names; per-slot dtype via a (slot, dtype) tuple,
    plain slots default to `dtype` (length outputs are int64)."""
    helper = LayerHelper(op_type, name=name)
    slots = [(s, dtype or "float32") if isinstance(s, str) else s
             for s in n_outs]
    outs = {s: [helper.create_variable_for_type_inference(dtype=dt)]
            for s, dt in slots}
    helper.append_op(op_type, inputs=inputs, outputs=outs,
                     attrs=attrs or {})
    ret = [outs[s][0] for s, _ in slots]
    return ret[0] if len(ret) == 1 else tuple(ret)


def _with_len(x, length):
    ins = {"X": [x]}
    if length is not None:
        ins["Length"] = [length]
    return ins


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, length=None,
                  bias_attr=None, param_attr=None, act=None, name=None):
    """Context-window projection (reference sequence_lod.py:44)."""
    helper = LayerHelper("sequence_conv", name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    # (B, T, num_filters): append_bias_op needs the channel dim
    out.shape = list(input.shape[:-1]) + [num_filters]
    ins = _with_len(input, length)
    ins["Filter"] = [w]
    start = (-(filter_size - 1) // 2 if padding_start is None
             else padding_start)
    helper.append_op("sequence_conv", inputs=ins, outputs={"Out": [out]},
                     attrs={"contextLength": filter_size,
                            "contextStart": start,
                            "contextStride": filter_stride},
                     infer_shape=False)
    out = helper.append_bias_op(out, bias_attr)
    return helper.append_activation(out, act)


def sequence_pool(input, pool_type, length=None, is_test=False,
                  pad_value=0.0, name=None):
    return _seq_op("sequence_pool", _with_len(input, length),
                   attrs={"pooltype": pool_type.upper(),
                          "pad_value": pad_value},
                   dtype=input.dtype, name=name)


def sequence_first_step(input, length=None):
    return sequence_pool(input, "FIRST", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "LAST", length=length)
