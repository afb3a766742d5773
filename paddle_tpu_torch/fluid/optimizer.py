"""Optimizers as Program rewrites (counterpart of
paddle_tpu/fluid/optimizer.py): the Optimizer base appends the backward
and the update ops to the main program (`minimize`, `apply_gradients`),
with the learning rate and the accumulators (velocities, moments, beta
powers) as persistable vars that the startup program fills.  Ported:
SGD, Momentum and Adam; their update rules are
paddle_tpu_torch/ops/optimizer_ops.py.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import unique_name
from .backward import append_backward
from .framework import (OpRole, Variable, default_startup_program,
                        program_guard)
from .initializer import ConstantInitializer


class Optimizer:
    _instance_count = 0

    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or unique_name.generate(self.__class__.__name__.lower())
        self._learning_rate_var: Optional[Variable] = None
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self.type = getattr(self, "type", "sgd")

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        if self._learning_rate_var is not None:
            return
        from .layers import tensor as tensor_layers

        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        lr_value = float(self._learning_rate)
        self._learning_rate_var = tensor_layers.create_global_var(
            name=unique_name.generate("learning_rate"),
            shape=[1], value=lr_value, dtype="float32", persistable=True)

    def _global_learning_rate(self) -> Variable:
        self._create_global_learning_rate()
        return self._learning_rate_var

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        # accumulators live in the param's own program (not whatever program
        # happens to be the default at minimize() time)
        main = param.block.program
        startup = getattr(self, "_startup_program", None) or \
            default_startup_program()
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        v = main.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        sv = startup.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        ConstantInitializer(fill_value)(sv, startup.global_block())
        # ties the accumulator back to its parameter
        v._optimizer_state_of = param.name
        sv._optimizer_state_of = param.name
        self._accumulators.setdefault(name, {})[param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- the program rewrite ----------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        parameter_list = parameter_list or self._parameter_list
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        if self._grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported")
        params_grads = self._apply_regularization(params_grads)
        self._create_global_learning_rate()
        ops = []
        for p, g in params_grads:
            ops.append(self._append_optimize_op(p.block, (p, g)))
        return ops

    def _apply_regularization(self, params_grads):
        if self.regularization is None:
            return params_grads
        out = []
        for p, g in params_grads:
            reg = p.regularizer if p.regularizer is not None else self.regularization
            if reg is None:
                out.append((p, g))
                continue
            new_g = reg._append_regularization_op(p, g)
            out.append((p, new_g))
        return out

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self._startup_program = startup_program
        main = loss.block.program
        with program_guard(main, startup_program
                           or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self.apply_optimize(loss, startup_program, params_grads)
        return opt_ops, params_grads

    def _append_optimize_op(self, block, param_and_grad) -> None:
        raise NotImplementedError

    def _opt_attrs(self, extra=None):
        a = {"op_role": OpRole.Optimize}
        if extra:
            a.update(extra)
        return a


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p]},
            attrs=self._opt_attrs(), infer_shape=False)


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._add_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs=self._opt_attrs({"mu": self._momentum,
                                   "use_nesterov": self._use_nesterov}),
            infer_shape=False)


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _adam_io(self, p, g):
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                    fill_value=self._beta1)
        b2p = self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                    fill_value=self._beta2)
        inputs = {"Param": [p], "Grad": [g],
                  "LearningRate": [self._global_learning_rate()],
                  "Moment1": [m1], "Moment2": [m2],
                  "Beta1Pow": [b1p], "Beta2Pow": [b2p]}
        outputs = {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                   "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]}
        return inputs, outputs

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs, outputs = self._adam_io(p, g)
        return block.append_op(
            "adam", inputs=inputs, outputs=outputs,
            attrs=self._opt_attrs({"beta1": self._beta1, "beta2": self._beta2,
                                   "epsilon": self._epsilon}),
            infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
