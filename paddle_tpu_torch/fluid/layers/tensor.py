"""Tensor-creation layers (counterpart of paddle_tpu/fluid/layers/tensor.py:
data, create_global_var, concat and fill_constant)."""

from __future__ import annotations

from .. import core, unique_name
from ..framework import default_main_program, default_startup_program
from ..layer_helper import LayerHelper

__all__ = ["data", "create_global_var", "concat", "fill_constant"]


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op("concat", inputs={"X": input}, outputs={"Out": [out]},
                     attrs={"axis": int(axis)})
    return out


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
