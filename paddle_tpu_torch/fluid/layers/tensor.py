"""Tensor-creation, casting and manipulation layers (counterpart of
paddle_tpu/fluid/layers/tensor.py)."""

from __future__ import annotations

import numpy as np

from .. import core, unique_name
from ..framework import default_main_program, default_startup_program
from ..layer_helper import LayerHelper

__all__ = [
    "data", "create_tensor", "create_parameter", "create_global_var",
    "cast", "concat", "sums", "assign", "fill_constant",
    "fill_constant_batch_size_like", "ones", "zeros", "ones_like",
    "zeros_like", "reverse", "range", "arange", "linspace", "eye",
    "diag", "increment", "argmax", "argmin", "argsort", "shape",
    "slice", "strided_slice", "split", "stack", "unstack", "expand",
    "expand_as", "tile", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "where", "index_select", "index_sample", "roll",
    "flip", "tril", "triu", "one_hot", "unsqueeze", "squeeze",
    "cumsum", "meshgrid", "full", "full_like",
]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=False):
    """Declare a feed Variable (fluid.data / fluid.layers.data).  The
    reference's `layers.data` prepends a -1 batch dim (append_batch_size);
    `fluid.data` (recommended) takes the full shape."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            is_data=True, stop_gradient=True)


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr

    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """Create a persistable var in the main program, initialized by a
    fill_constant in the startup program (tensor.py:createglobalvar in
    the reference)."""
    name = name or unique_name.generate("global_var")
    main_block = default_main_program().global_block()
    var = main_block.create_var(name=name, shape=list(shape), dtype=dtype,
                                persistable=persistable, stop_gradient=True)
    startup_block = default_startup_program().global_block()
    startup_block.create_var(name=name, shape=list(shape), dtype=dtype,
                             persistable=persistable, stop_gradient=True)
    startup_block.append_op(
        "fill_constant", outputs={"Out": [name]},
        attrs={"shape": list(shape), "dtype": core.convert_dtype(dtype),
               "value": float(value)},
        infer_shape=False)
    return var


def cast(x, dtype):
    dtype = core.convert_dtype(dtype)
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op("concat", inputs={"X": input}, outputs={"Out": [out]},
                     attrs={"axis": int(axis)})
    return out


def sums(input, out=None):
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op("sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=core.convert_dtype(input.dtype))
        helper.append_op("assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": core.convert_dtype(input.dtype),
                                "values": input})
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=core.convert_dtype(dtype))
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": core.convert_dtype(dtype),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(
        dtype=core.convert_dtype(dtype))
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": core.convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def full(shape, fill_value, dtype="float32"):
    return fill_constant(shape, dtype, fill_value)


def _like(x, value, dtype=None):
    helper = LayerHelper("full_like")
    dtype = core.convert_dtype(dtype) if dtype else x.dtype
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"value": float(value), "dtype": dtype})
    return out


def ones_like(x, out=None):
    return _like(x, 1.0)


def zeros_like(x, out=None):
    return _like(x, 0.0)


def full_like(x, fill_value, dtype=None):
    return _like(x, fill_value, dtype)


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    axis = [axis] if isinstance(axis, int) else list(axis)
    helper.append_op("flip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def range(start, end, step, dtype="int64"):
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(
        dtype=core.convert_dtype(dtype))
    helper.append_op("range", outputs={"Out": [out]},
                     attrs={"start": float(start), "end": float(end),
                            "step": float(step),
                            "dtype": core.convert_dtype(dtype)})
    out.stop_gradient = True
    return out


arange = range


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(
        dtype=core.convert_dtype(dtype))
    helper.append_op("linspace", outputs={"Out": [out]},
                     attrs={"start": float(start), "stop": float(stop),
                            "num": int(num),
                            "dtype": core.convert_dtype(dtype)})
    return out


def eye(num_rows, num_columns=None, dtype="float32", batch_shape=None):
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(
        dtype=core.convert_dtype(dtype))
    helper.append_op("eye", outputs={"Out": [out]},
                     attrs={"num_rows": int(num_rows),
                            "num_columns": int(num_columns or num_rows),
                            "dtype": core.convert_dtype(dtype)})
    return out


def diag(diagonal, offset=0, padding_value=0):
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(dtype=diagonal.dtype)
    helper.append_op("diag_v2", inputs={"X": [diagonal]},
                     outputs={"Out": [out]},
                     attrs={"offset": offset, "padding_value": padding_value})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out


def argmax(x, axis=0, keepdims=False, dtype="int64"):
    helper = LayerHelper("argmax")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op("arg_max", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "keepdims": keepdims,
                            "dtype": core.convert_dtype(dtype)})
    out.stop_gradient = True
    return out


def argmin(x, axis=0, keepdims=False):
    helper = LayerHelper("argmin")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op("arg_min", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "keepdims": keepdims})
    out.stop_gradient = True
    return out


def argsort(x, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op("argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op("shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    out.stop_gradient = True
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("strided_slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "strides": list(strides)})
    return out


# the builtin, which the `range` layer above shadows in this module
_builtin_range = __import__("builtins").range


def split(input, num_or_sections, dim=-1, name=None):
    """The reference's split raises TypeError here: it calls the
    module's `range` layer for the builtin (ROADMAP queue 3); the port
    calls the builtin."""
    helper = LayerHelper("split", name=name)
    axis = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": axis, "sections": []}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "num": 0, "axis": axis}
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in _builtin_range(n)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op("stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype)
            for _ in _builtin_range(num)]
    helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def expand_as(x, y=None, target_shape=None):
    helper = LayerHelper("expand_as")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    shape = list(target_shape if target_shape is not None else y.shape)
    helper.append_op("expand_as_v2", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"target_shape": shape})
    return out


def tile(x, repeat_times):
    helper = LayerHelper("tile")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("tile", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"repeat_times": list(repeat_times)})
    return out


def gather(input, index, overwrite=True, axis=0):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("gather_nd", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True):
    helper = LayerHelper("scatter")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def scatter_nd_add(x, index, updates):
    helper = LayerHelper("scatter_nd_add")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("scatter_nd_add",
                     inputs={"X": [x], "Index": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return out


def where(condition, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def index_select(x, index, axis=0):
    helper = LayerHelper("index_select")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("index_select", inputs={"X": [x], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"dim": axis})
    return out


def index_sample(x, index):
    helper = LayerHelper("index_sample")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("index_sample", inputs={"X": [x], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def roll(x, shifts, axis=None):
    helper = LayerHelper("roll")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    shifts = [shifts] if isinstance(shifts, int) else list(shifts)
    axis = [] if axis is None else ([axis] if isinstance(axis, int) else list(axis))
    helper.append_op("roll", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shifts": shifts, "axis": axis})
    return out


def flip(x, axis):
    helper = LayerHelper("flip")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("flip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": [axis] if isinstance(axis, int) else list(axis)})
    return out


def tril(x, diagonal=0):
    helper = LayerHelper("tril")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("tril_triu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"diagonal": diagonal, "lower": True})
    return out


def triu(x, diagonal=0):
    helper = LayerHelper("triu")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("tril_triu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"diagonal": diagonal, "lower": False})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op("one_hot_v2", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": int(depth)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": [axes] if isinstance(axes, int) else list(axes)})
    return out


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes or [])})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out


def meshgrid(args):
    helper = LayerHelper("meshgrid")
    outs = [helper.create_variable_for_type_inference(dtype=args[0].dtype)
            for _ in args]
    helper.append_op("meshgrid", inputs={"X": args}, outputs={"Out": outs})
    return outs
