"""Sequence layers (a copy of paddle_tpu/fluid/layers/sequence_lod.py,
which follows the reference's python/paddle/fluid/layers/
sequence_lod.py): sequence_conv, sequence_softmax, sequence_pool,
sequence_concat, sequence_first_step, sequence_last_step,
sequence_slice, sequence_expand, sequence_expand_as, sequence_pad,
sequence_unpad, sequence_erase, sequence_enumerate, sequence_mask and
sequence_reverse.

A sequence is a padded dense tensor (B, T, ...) with an optional
`length` (B,) beside it, not a LoDTensor; layers that drop steps return
front-packed results and, where the reference carries them in the LoD,
the new lengths (ops/sequence_ops.py).
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_concat", "sequence_first_step", "sequence_last_step",
    "sequence_slice", "sequence_expand", "sequence_expand_as",
    "sequence_pad", "sequence_unpad", "sequence_erase",
    "sequence_enumerate", "sequence_mask", "sequence_reverse",
]


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


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    return _seq_op("sequence_softmax", _with_len(input, length),
                   dtype=input.dtype, name=name)


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


def sequence_concat(input, length=None, name=None):
    """Concat the i-th rows of all inputs time-wise; returns (out,
    out_length) — the reference carries the new lengths in the LoD."""
    ins = {"X": list(input)}
    if length is not None:
        ins["Length"] = list(length)
    return _seq_op("sequence_concat", ins,
                   n_outs=(("Out", input[0].dtype), ("OutLength", "int64")),
                   name=name)


def sequence_slice(input, offset, length, name=None):
    return _seq_op("sequence_slice",
                   {"X": [input], "Offset": [offset], "Length": [length]},
                   dtype=input.dtype, name=name)


def sequence_expand(x, y, ref_level=-1, length=None, name=None):
    return _seq_op("sequence_expand",
                   {"X": [x], "Y": [y]} | ({"Length": [length]}
                                           if length is not None else {}),
                   attrs={"ref_level": ref_level}, dtype=x.dtype,
                   name=name)


def sequence_expand_as(x, y, length=None, name=None):
    return _seq_op("sequence_expand_as",
                   {"X": [x], "Y": [y]} | ({"Length": [length]}
                                           if length is not None else {}),
                   dtype=x.dtype, name=name)


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """Returns (out, length) like the reference (sequence_lod.py:894)."""
    ins = _with_len(x, length)
    ins["PadValue"] = [pad_value]
    return _seq_op("sequence_pad", ins,
                   attrs={"padded_length": -1 if maxlen is None
                          else int(maxlen)},
                   n_outs=(("Out", x.dtype), ("Length", "int64")),
                   name=name)


def sequence_unpad(x, length, name=None):
    return _seq_op("sequence_unpad", _with_len(x, length),
                   dtype=x.dtype, name=name)


def sequence_erase(input, tokens, length=None, name=None):
    """Returns (out, out_length): survivors front-packed."""
    return _seq_op("sequence_erase", _with_len(input, length),
                   attrs={"tokens": list(tokens)},
                   n_outs=(("Out", input.dtype), ("OutLength", "int64")),
                   name=name)


def sequence_enumerate(input, win_size, pad_value=0, length=None,
                       name=None):
    return _seq_op("sequence_enumerate", _with_len(input, length),
                   attrs={"win_size": win_size, "pad_value": pad_value},
                   dtype=input.dtype, name=name)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        raise ValueError(
            "sequence_mask needs a static maxlen (the reference derives "
            "it from the LoD at run time)")
    return _seq_op("sequence_mask", {"X": [x]},
                   attrs={"maxlen": int(maxlen), "out_dtype": dtype},
                   n_outs=("Y",), dtype=dtype, name=name)


def sequence_reverse(x, length=None, name=None):
    return _seq_op("sequence_reverse", _with_len(x, length),
                   n_outs=("Y",), dtype=x.dtype, name=name)
