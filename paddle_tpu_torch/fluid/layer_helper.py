"""LayerHelper: shared machinery for layer functions (a copy of
paddle_tpu/fluid/layer_helper.py): creates parameters in BOTH the main
program's global block and the startup program (with the initializer op
appended to the startup block), creates temp output vars, and appends
activation ops.
"""

from __future__ import annotations

from . import unique_name
from .framework import (Parameter, default_main_program,
                        default_startup_program)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    # -- parameters --------------------------------------------------------
    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.name is None:
            attr.name = unique_name.generate(f"{self.name}.w" if not is_bias
                                             else f"{self.name}.b")
        init = attr.initializer or default_initializer
        if init is None:
            from .initializer import _global_initializer

            init = _global_initializer(is_bias)
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        shape = [int(s) for s in shape]
        # main program: the Parameter node
        main_block = self.main_program.global_block()
        param = main_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **{k: v for k, v in attr._to_kwargs().items() if k != "name"})
        # startup program: a twin var + its init op
        startup_block = self.startup_program.global_block()
        startup_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **{k: v for k, v in attr._to_kwargs().items() if k != "name"})
        init(startup_block.vars[attr.name], startup_block)
        return param

    def get_parameter(self, name):
        return self.main_program.global_block().var(name)

    # -- temp variables ----------------------------------------------------
    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, **kwargs):
        return self.main_program.current_block().create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    # -- ops ---------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        return self.main_program.current_block().append_op(
            type, inputs=inputs, outputs=outputs, attrs=attrs,
            infer_shape=infer_shape)

    def append_activation(self, input_var, act=None):
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out

    def append_bias_op(self, input_var, bias_attr=None, dim_start=1,
                       num_flatten_dims=None):
        bias_attr = bias_attr if bias_attr is not None else self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = input_var.shape[-1]
        b = self.create_parameter(bias_attr, shape=[size],
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op("elementwise_add", inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": -1})
        return out
