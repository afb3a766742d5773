"""Operator sugar on Variable (counterpart of
paddle_tpu/fluid/layers/math_op_patch.py): + - * / ** % // @ emit the
elementwise ops (@ matmul_v2); a scalar operand of +, -, * or / becomes
one scale op, of the others a fill_constant; the comparisons emit
equal, not_equal, less_than, ... (bool, stop_gradient), and a Variable
hashes by identity.  As in the reference there is no __rpow__: `2 **
var` raises TypeError."""

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
            # fall through: build a constant var
            from .tensor import fill_constant

            other = fill_constant(self.shape if self.shape else [1],
                                  self.dtype, other)
        x, y = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": -1})
        return out

    return impl


def _compare(op_type):
    def impl(self, other):
        if isinstance(other, (int, float)):
            from .tensor import fill_constant

            other = fill_constant(self.shape if self.shape else [1],
                                  self.dtype, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype="bool")
        out.stop_gradient = True
        helper.append_op(op_type, inputs={"X": [self], "Y": [other]},
                         outputs={"Out": [out]})
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
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__mod__ = _binary("elementwise_mod")
    Variable.__floordiv__ = _binary("elementwise_floordiv")
    Variable.__matmul__ = _binary("matmul_v2")
    Variable.__neg__ = _neg
    Variable.__eq__ = _compare("equal")
    Variable.__ne__ = _compare("not_equal")
    Variable.__lt__ = _compare("less_than")
    Variable.__le__ = _compare("less_equal")
    Variable.__gt__ = _compare("greater_than")
    Variable.__ge__ = _compare("greater_equal")
    Variable.__hash__ = lambda self: id(self)


monkey_patch_variable()
