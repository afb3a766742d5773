"""Operator sugar on Variable (counterpart of
paddle_tpu/fluid/layers/math_op_patch.py), for the ops the port has
rules for: + and - emit elementwise_add / elementwise_sub; a scalar
operand of +, -, * or / becomes one scale op; unary minus is scale -1."""

from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper


def _scalar_op(var, scale, bias):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(dtype=var.dtype)
    helper.append_op("scale", inputs={"X": [var]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": True})
    return out


def _binary(op_type, reverse=False):
    def impl(self, other):
        if isinstance(other, (int, float)):
            if op_type == "elementwise_add":
                return _scalar_op(self, 1.0, other)
            if op_type == "elementwise_sub":
                if reverse:
                    return _scalar_op(self, -1.0, other)
                return _scalar_op(self, 1.0, -other)
            if op_type == "elementwise_mul":
                return _scalar_op(self, other, 0.0)
            if op_type == "elementwise_div" and not reverse:
                return _scalar_op(self, 1.0 / other, 0.0)
        if op_type not in ("elementwise_add", "elementwise_sub"):
            return NotImplemented
        x, y = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        return out

    return impl


def _neg(self):
    return _scalar_op(self, -1.0, 0.0)


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add", reverse=True)
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul", reverse=True)
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__neg__ = _neg


monkey_patch_variable()
