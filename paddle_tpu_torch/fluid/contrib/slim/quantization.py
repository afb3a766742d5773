"""Quantization-aware training passes (counterpart of
paddle_tpu/fluid/contrib/slim/quantization.py; Paddle's
contrib/slim/quantization/quantization_pass.py QuantizationTransformPass,
which rewrites the graph so every quantizable op reads quant-dequantized
inputs, and imperative/qat.py ImperativeQuantAware, which wraps dygraph
layers).

The redesign is the reference's: Paddle's pass mutates an IrGraph and
wires per-var state (scales, accum, state) as graph nodes updated in
place; here the Program rewrite inserts functional
fake_quantize_dequantize_* ops whose observer state flows through
persistable vars created in the startup program.  The quantized numerics
(round and clip with the straight-through estimator) live in
ops/quantize_ops.py.  In the dygraph wrapper the observer state stays a
tensor on the layer's device between calls (the reference copies it to
the host after each call).
"""

from __future__ import annotations

from ... import core
from ...framework import (default_main_program, default_startup_program,
                          program_guard)
from ... import unique_name

_DEFAULT_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul",
                        "matmul_v2")
# input slots that carry weights for each quantizable op type
_WEIGHT_SLOTS = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
                 "mul": "Y", "matmul": "Y", "matmul_v2": "Y"}


class QuantizationTransformPass:
    """Insert fake quant-dequant on every quantizable op's inputs.

    Weights use per-call abs_max (`fake_quantize_dequantize_abs_max`);
    activations use the moving-average observer with persistable
    scale/accum/state, matching the reference defaults
    (quantization_pass.py:252)."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="abs_max", moving_rate=0.9,
                 quantizable_op_type=_DEFAULT_QUANTIZABLE, scope=None,
                 place=None):
        if weight_quantize_type not in ("abs_max",
                                        "channel_wise_abs_max"):
            raise ValueError(
                f"unsupported weight_quantize_type {weight_quantize_type}")
        if activation_quantize_type not in ("abs_max",
                                            "moving_average_abs_max"):
            raise ValueError(
                "unsupported activation_quantize_type "
                f"{activation_quantize_type}")
        self._wbits = weight_bits
        self._abits = activation_bits
        self._act_type = activation_quantize_type
        self._w_type = weight_quantize_type
        self._rate = moving_rate
        self._op_types = tuple(quantizable_op_type)

    def apply(self, program, startup_program=None):
        """Rewrite `program` in place; observer state vars are created
        via the default startup program (pass them under
        program_guard)."""
        startup = startup_program or default_startup_program()
        with program_guard(program, startup):
            block = program.global_block()
            quantized = {}  # var name -> qdq var name (share observers)
            idx = 0
            while idx < len(block.ops):
                op = block.ops[idx]
                if op.type not in self._op_types:
                    idx += 1
                    continue
                w_slot = _WEIGHT_SLOTS.get(op.type)
                for slot, names in list(op.inputs.items()):
                    new_names = []
                    for name in names:
                        var = block.var(name) if block.has_var_recursive(
                            name) else None
                        if var is None or not core.is_float_dtype(
                                var.dtype):
                            new_names.append(name)
                            continue
                        if name not in quantized:
                            is_weight = (slot == w_slot)
                            qname = self._insert_qdq(
                                block, idx, name, var, is_weight)
                            quantized[name] = qname
                            idx += 1  # one op inserted before this one
                        new_names.append(quantized[name])
                    op.inputs[slot] = new_names
                idx += 1
        return program

    def _insert_qdq(self, block, at, name, var, is_weight):
        from ...layers.tensor import create_global_var

        out = block.create_var(
            name=unique_name.generate(f"{name}.quant_dequant"),
            dtype=var.dtype, shape=var.shape, stop_gradient=False)
        scale = create_global_var(
            [1], 0.001, "float32", persistable=True,
            name=unique_name.generate(f"{name}.quant_scale"))
        bits = self._wbits if is_weight else self._abits
        if is_weight and self._w_type == "channel_wise_abs_max":
            op_type = "fake_channel_wise_quantize_dequantize_abs_max"
            inputs = {"X": [name]}
            outputs = {"Out": [out.name], "OutScale": [scale.name]}
            attrs = {"bit_length": bits, "quant_axis": 0}
        elif is_weight or self._act_type == "abs_max":
            op_type = "fake_quantize_dequantize_abs_max"
            inputs = {"X": [name]}
            outputs = {"Out": [out.name], "OutScale": [scale.name]}
            attrs = {"bit_length": bits}
        else:
            accum = create_global_var(
                [1], 1.0, "float32", persistable=True,
                name=unique_name.generate(f"{name}.quant_accum"))
            state = create_global_var(
                [1], 1.0, "float32", persistable=True,
                name=unique_name.generate(f"{name}.quant_state"))
            op_type = "fake_quantize_dequantize_moving_average_abs_max"
            inputs = {"X": [name], "InScale": [scale.name],
                      "InAccum": [accum.name], "InState": [state.name]}
            outputs = {"Out": [out.name], "OutScale": [scale.name],
                       "OutAccum": [accum.name],
                       "OutState": [state.name]}
            attrs = {"bit_length": bits, "moving_rate": self._rate,
                     "is_test": False}
        block.insert_op(at, op_type, inputs=inputs, outputs=outputs,
                        attrs=attrs, infer_shape=False)
        return out.name


class ImperativeQuantAware:
    """Dygraph QAT (reference slim/quantization/imperative/qat.py):
    `quantize(model)` wraps every Linear / Conv2D so input and weight
    pass through fake quant-dequant (STE gradients) on each call."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9):
        if weight_quantize_type not in ("abs_max", "channel_wise_abs_max"):
            raise ValueError(
                f"unsupported weight_quantize_type {weight_quantize_type}")
        if activation_quantize_type != "moving_average_abs_max":
            raise ValueError(
                "unsupported activation_quantize_type "
                f"{activation_quantize_type} (dygraph QAT uses the "
                "moving-average observer)")
        self._wbits = weight_bits
        self._abits = activation_bits
        self._w_type = weight_quantize_type
        self._rate = moving_rate

    def quantize(self, model):
        from ....nn import Conv2D, Linear

        for layer in model.sublayers(include_self=True):
            if isinstance(layer, (Linear, Conv2D)) and \
                    not getattr(layer, "_quantized", False):
                self._wrap(layer)
        return model

    def _wrap(self, layer):
        import numpy as np

        from ...dygraph import trace_op

        state = {
            "scale": None, "accum": None, "state": None,
        }
        orig_forward = layer.forward
        wbits, abits, rate = self._wbits, self._abits, self._rate

        channel_wise = self._w_type == "channel_wise_abs_max"

        def qdq_weight(w):
            if channel_wise:
                outs = trace_op(
                    "fake_channel_wise_quantize_dequantize_abs_max",
                    {"X": w}, {"bit_length": wbits, "quant_axis": 0},
                    multi_out=True)
            else:
                outs = trace_op("fake_quantize_dequantize_abs_max",
                                {"X": w}, {"bit_length": wbits},
                                multi_out=True)
            return outs["Out"][0]

        def qdq_act(x):
            if state["scale"] is None:
                state["scale"] = np.array([0.001], "float32")
                state["accum"] = np.array([1.0], "float32")
                state["state"] = np.array([1.0], "float32")
            outs = trace_op(
                "fake_quantize_dequantize_moving_average_abs_max",
                {"X": x, "InScale": state["scale"],
                 "InAccum": state["accum"], "InState": state["state"]},
                {"bit_length": abits, "moving_rate": rate,
                 "is_test": False}, multi_out=True)
            for key, slot in (("scale", "OutScale"), ("accum", "OutAccum"),
                              ("state", "OutState")):
                state[key] = outs[slot][0].detach()
            return outs["Out"][0]

        def forward(x, *args, **kwargs):
            # shadow the weight parameter with its quant-dequant view in
            # the INSTANCE dict for this call only; popping it restores
            # lookup through _parameters (the Parameter is never removed)
            object.__setattr__(layer, "weight", qdq_weight(layer.weight))
            try:
                return orig_forward(qdq_act(x), *args, **kwargs)
            finally:
                layer.__dict__.pop("weight", None)

        layer.forward = forward
        layer._quantized = True
