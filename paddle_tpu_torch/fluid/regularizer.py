"""Weight-decay regularizers (a copy of paddle_tpu/fluid/regularizer.py):
applied by appending grad-modification ops during apply_gradients."""

from __future__ import annotations

from .layer_helper import LayerHelper


class WeightDecayRegularizer:
    def _append_regularization_op(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_regularization_op(self, param, grad):
        helper = LayerHelper("l2_decay")
        scaled = helper.create_variable_for_type_inference(dtype=param.dtype)
        helper.append_op("scale", inputs={"X": [param]},
                         outputs={"Out": [scaled]},
                         attrs={"scale": float(self._coeff), "bias": 0.0,
                                "bias_after_scale": True, "op_role": 1})
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        helper.append_op("sum", inputs={"X": [grad, scaled]},
                         outputs={"Out": [out]}, attrs={"op_role": 1})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_regularization_op(self, param, grad):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(dtype=param.dtype)
        helper.append_op("sign", inputs={"X": [param]},
                         outputs={"Out": [sign]}, attrs={"op_role": 1})
        scaled = helper.create_variable_for_type_inference(dtype=param.dtype)
        helper.append_op("scale", inputs={"X": [sign]},
                         outputs={"Out": [scaled]},
                         attrs={"scale": float(self._coeff), "bias": 0.0,
                                "bias_after_scale": True, "op_role": 1})
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        helper.append_op("sum", inputs={"X": [grad, scaled]},
                         outputs={"Out": [out]}, attrs={"op_role": 1})
        return out


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer
