"""Optimizers as Program rewrites (counterpart of
paddle_tpu/fluid/optimizer.py): the Optimizer base appends the backward
and the update ops to the main program (`minimize`, `apply_gradients`),
with the learning rate and the accumulators (velocities, moments, beta
powers) as persistable vars that the startup program fills.  Before the
updates it applies the gradient clip (`grad_clip`, else the one of
`fluid.clip.set_gradient_clip`) and the regularizers.

The sixteen update optimizers: SGD, Momentum, LarsMomentum, Adagrad, Adam,
AdamW, Adamax, Adadelta, RMSProp, Lamb, DGCMomentum, DecayedAdagrad,
ProximalGD, ProximalAdagrad, Ftrl and Dpsgd (their rules are
paddle_tpu_torch/ops/optimizer_ops.py).  The wrappers: Lookahead and
Recompute rewrite the program; ExponentialMovingAverage and ModelAverage
keep their state beside the scope, on each parameter's device, and swap
it in with `apply()`.  PipelineOptimizer raises, as the reference's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

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

    def current_step_lr(self):
        return self._learning_rate

    def set_lr(self, value, scope=None):
        """Set the learning rate var in the scope (the host's value)."""
        from .executor import global_scope

        scope = scope or global_scope()
        self._create_global_learning_rate()
        scope.set(self._learning_rate_var.name,
                  torch.full((1,), float(value), dtype=torch.float32))

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
        params_grads = self._clip_and_regularize(
            sorted(params_grads, key=lambda pg: pg[0].name))
        self._create_global_learning_rate()
        ops = []
        for p, g in params_grads:
            ops.append(self._append_optimize_op(p.block, (p, g)))
        return ops

    def _clip_and_regularize(self, params_grads):
        """The gradients the updates read: `grad_clip` (else the clip of
        `fluid.clip.set_gradient_clip`) applied, then the regularizers."""
        clip = self._grad_clip
        if clip is None:
            from .clip import _global_gradient_clip

            clip = _global_gradient_clip()
        if clip is not None:
            params_grads = clip(params_grads)
        return self._apply_regularization(params_grads)

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


class LarsMomentumOptimizer(Optimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._add_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs=self._opt_attrs({
                "mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
                "epsilon": self._epsilon}),
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p, fill_value=self._initial)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs=self._opt_attrs({"epsilon": self._epsilon}),
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


class AdamWOptimizer(AdamOptimizer):
    type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, apply_decay_param_fun=None,
                 **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        with_decay = True
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(p.name)):
            with_decay = False
        inputs, outputs = self._adam_io(p, g)
        return block.append_op(
            "adamw", inputs=inputs, outputs=outputs,
            attrs=self._opt_attrs({"beta1": self._beta1, "beta2": self._beta2,
                                   "epsilon": self._epsilon,
                                   "coeff": self._coeff,
                                   "with_decay": with_decay}),
            infer_shape=False)


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p)
        inf = self._add_accumulator("inf_norm", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                    fill_value=self._beta1)
        return block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [m], "InfNorm": [inf],
                    "Beta1Pow": [b1p],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "MomentOut": [m], "InfNormOut": [inf]},
            attrs=self._opt_attrs({"beta1": self._beta1, "beta2": self._beta2,
                                   "epsilon": self._epsilon}),
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ag = self._add_accumulator("avg_squared_grad", p)
        au = self._add_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [ag],
                    "AvgSquaredUpdate": [au]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [ag],
                     "AvgSquaredUpdateOut": [au]},
            attrs=self._opt_attrs({"epsilon": self._epsilon, "rho": self._rho}),
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._add_accumulator("mean_square", p)
        mg = self._add_accumulator("mean_grad", p)
        mom = self._add_accumulator("momentum", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [p], "Grad": [g], "MeanSquare": [ms],
                    "MeanGrad": [mg], "Moment": [mom],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs=self._opt_attrs({"decay": self._rho, "epsilon": self._epsilon,
                                   "momentum": self._momentum,
                                   "centered": self._centered}),
            infer_shape=False)


class LambOptimizer(AdamOptimizer):
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        inputs, outputs = self._adam_io(p, g)
        return block.append_op(
            "lamb", inputs=inputs, outputs=outputs,
            attrs=self._opt_attrs({"beta1": self._beta1, "beta2": self._beta2,
                                   "epsilon": self._epsilon,
                                   "weight_decay": wd}),
            infer_shape=False)


# the short names
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum (Paddle's
    DGCMomentumOptimizer over dgc_op.cc): a gradient goes through the dgc
    op (momentum correction u, error feedback v, the top (1 - sparsity)
    of |v| sent), the sum over the data-parallel ranks (c_allreduce_sum;
    one process: itself) and an SGD step.  Before `rampup_begin_step`
    Paddle trains with plain momentum; only rampup_begin_step=0, which
    compresses from the first step, is carried, as in the reference."""

    type = "dgc_momentum"

    def __init__(self, learning_rate, momentum=0.9, rampup_begin_step=0,
                 rampup_step=1, sparsity=None, **kwargs):
        super().__init__(learning_rate, **kwargs)
        if rampup_begin_step != 0:
            raise NotImplementedError(
                "DGCMomentumOptimizer: rampup_begin_step != 0 (delayed "
                "compression) is not supported; compression starts at "
                "step 0")
        self._momentum = momentum
        self._sparsity_list = [float(x) for x in (sparsity or [0.999])]
        self._rampup_step = int(rampup_step)
        self._step_var = None

    def _dgc_step_counter(self, block):
        """The persistable step counter of the sparsity warm-up, one
        increment a step."""
        if self._step_var is None:
            from .layers import tensor as tl

            self._step_var = tl.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate("dgc_step"))
            block.append_op(
                "increment", inputs={"X": [self._step_var]},
                outputs={"Out": [self._step_var]},
                attrs=self._opt_attrs({"step": 1.0}),
                infer_shape=False)
        return self._step_var

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        u = self._add_accumulator("dgc_u", p, dtype="float32")
        v = self._add_accumulator("dgc_v", p, dtype="float32")
        encoded = block.create_var(dtype="float32", shape=p.shape)
        step = self._dgc_step_counter(block)
        block.append_op(
            "dgc",
            inputs={"U": [u], "V": [v], "Grad": [g],
                    "CurrentStep": [step]},
            outputs={"U_out": [u], "V_out": [v],
                     "EncodeGrad": [encoded]},
            attrs=self._opt_attrs({"m": self._momentum,
                                   "ratio": self._sparsity_list[-1],
                                   "ratio_list": self._sparsity_list,
                                   "rampup_step": self._rampup_step}),
            infer_shape=False)
        block.append_op(
            "scale", inputs={"X": [encoded]}, outputs={"Out": [encoded]},
            attrs=self._opt_attrs({"scale": 1.0, "bias": 0.0,
                                   "bias_after_scale": True,
                                   "divide_by_axis_size": "data"}),
            infer_shape=False)
        block.append_op(
            "c_allreduce_sum", inputs={"X": [encoded]},
            outputs={"Out": [encoded]},
            attrs=self._opt_attrs({"ring_id": 0,
                                   "use_calc_stream": True}),
            infer_shape=False)
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [encoded],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p]},
            attrs=self._opt_attrs({}),
            infer_shape=False)


DGCMomentum = DGCMomentumOptimizer


class DecayedAdagradOptimizer(Optimizer):

    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs=self._opt_attrs({"decay": self._decay,
                                   "epsilon": self._epsilon}),
            infer_shape=False)


class ProximalGDOptimizer(Optimizer):

    type = "proximal_gd"

    def __init__(self, learning_rate, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1 = l1_regularization_strength
        self._l2 = l2_regularization_strength

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "proximal_gd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p]},
            attrs=self._opt_attrs({"l1": self._l1, "l2": self._l2}),
            infer_shape=False)


class ProximalAdagradOptimizer(Optimizer):

    type = "proximal_adagrad"

    def __init__(self, learning_rate, initial_accumulator_value=0.1,
                 l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._initial = initial_accumulator_value
        self._l1 = l1_regularization_strength
        self._l2 = l2_regularization_strength

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p, fill_value=self._initial)
        return block.append_op(
            "proximal_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs=self._opt_attrs({"l1": self._l1, "l2": self._l2}),
            infer_shape=False)


class FtrlOptimizer(Optimizer):

    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._add_accumulator("squared", p)
        lin = self._add_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g],
                    "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs=self._opt_attrs({"l1": self._l1, "l2": self._l2,
                                   "lr_power": self._lr_power}),
            infer_shape=False)


DecayedAdagrad = DecayedAdagradOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
Ftrl = FtrlOptimizer


class DpsgdOptimizer(Optimizer):
    """Differentially-private SGD: the gradient clipped in L2 norm, plus
    Gaussian noise."""

    type = "dpsgd"

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, parameter_list=None):
        super().__init__(learning_rate, parameter_list=parameter_list)
        self._clip = clip
        self._batch_size = batch_size
        self._sigma = sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p]},
            attrs=self._opt_attrs({"clip": self._clip,
                                   "batch_size": self._batch_size,
                                   "sigma": self._sigma}),
            infer_shape=False)


Dpsgd = DpsgdOptimizer
LarsMomentum = LarsMomentumOptimizer


class ExponentialMovingAverage:
    """The moving average of every trainable parameter, decay (or, with
    thres_steps, min(decay, (1 + t) / (10 + t))) a step, bias-corrected
    by 1 - prod(decay_t) when applied.  `update()` after each optimizer
    step reads the scope; each shadow is an f32 tensor on its
    parameter's device, so an update costs no sync.  `with ema.apply():`
    puts the averages in the scope, and restores the training values
    after, bit for bit (`restore()` does it by hand)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._decay_prod = 1.0
        self._shadow = {}
        self._backup = {}
        self._step = 0
        self._program = None

    def _params(self, program):
        from .framework import default_main_program

        program = program or self._program or default_main_program()
        self._program = program
        return [v for v in program.global_block().vars.values()
                if getattr(v, "persistable", False)
                and getattr(v, "trainable", True)
                and getattr(v, "is_parameter", False)]

    @staticmethod
    def _value(scope, name):
        if not scope.has(name) or scope.get(name) is None:
            return None
        val = scope.get(name)
        if not isinstance(val, torch.Tensor):
            val = torch.as_tensor(np.asarray(val))
        return val

    def update(self, scope=None, program=None):
        from .executor import global_scope

        scope = scope or global_scope()
        self._step += 1
        decay = self._decay
        if self._thres_steps is not None:
            decay = min(decay, (1 + self._step) / (10 + self._step))
        self._decay_prod *= decay
        for p in self._params(program):
            val = self._value(scope, p.name)
            if val is None:
                continue
            prev = self._shadow.get(p.name)
            if prev is None:
                prev = torch.zeros_like(val)
            self._shadow[p.name] = decay * prev + (1 - decay) * val

    def apply(self, executor=None, need_restore=True):
        import contextlib

        from .executor import global_scope

        @contextlib.contextmanager
        def ctx():
            scope = global_scope()
            self._backup = {}
            corr = 1.0 - self._decay_prod
            for name, avg in self._shadow.items():
                val = self._value(scope, name)
                if val is None:
                    continue
                # the Executor commits new tensors, never writes into
                # these: the value itself is the backup
                self._backup[name] = val
                ema = avg / corr if corr > 0 else avg
                scope.set(name, ema.to(val.dtype))
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return ctx()

    def restore(self, executor=None):
        from .executor import global_scope

        scope = global_scope()
        for name, val in self._backup.items():
            scope.set(name, val)
        self._backup = {}


class ModelAverage(ExponentialMovingAverage):
    """The average of the parameters over a sliding window, kept by the
    `average_accumulates` rule (Paddle's ModelAverage state: sum_1,
    sum_2, sum_3 and the counts, here on each parameter's device): the
    average is (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates), the current window and the last one that
    rolled.  The reference keeps a host-side form that rolls one step
    later (ROADMAP queue 3); both agree until the first roll."""

    def __init__(self, average_window_rate=0.15,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(decay=0.0, name=name)
        self._rate = average_window_rate
        self._min_window = min_average_window
        self._max_window = max_average_window
        self._sums = {}

    def _accumulate(self, val, state):
        from ..ops import registry
        from .framework import Operator

        op = Operator(None, 0, "average_accumulates", {}, {}, {
            "average_window": float(self._rate),
            "min_average_window": int(self._min_window),
            "max_average_window": int(self._max_window)})
        if state is None:
            count = torch.zeros(1, dtype=torch.int64, device=val.device)
            state = [torch.zeros_like(val)] * 3 + [count] * 3
        names = ("sum_1", "sum_2", "sum_3", "num_accumulates",
                 "old_num_accumulates", "num_updates")
        ins = {f"in_{n}": [v] for n, v in zip(names, state)}
        ins["param"] = [val]
        outs = registry.forward_rule("average_accumulates")(
            registry.LowerCtx(0, device=val.device), op, ins)
        return [outs[f"out_{n}"][0] for n in names]

    def update(self, scope=None, program=None):
        from .executor import global_scope

        scope = scope or global_scope()
        self._step += 1
        self._decay_prod = 0.0  # apply() divides by 1
        for p in self._params(program):
            val = self._value(scope, p.name)
            if val is None:
                continue
            st = self._accumulate(val, self._sums.get(p.name))
            self._sums[p.name] = st
            n = (st[3] + st[4]).to(val.dtype)
            self._shadow[p.name] = (st[0] + st[1] + st[2]) / n


class LookaheadOptimizer:
    """Lookahead: the fast weights step with the inner optimizer every
    step; every k steps the slow weights move alpha of the way to the
    fast ones, and the fast weights reset to the slow.  In the program:
    the slow copies are persistables, and the k-step gate multiplies by
    (step % k == 0)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if inner_optimizer is None:
            raise ValueError("LookaheadOptimizer needs an inner optimizer")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if not isinstance(k, int) or k <= 0:
            raise ValueError(f"k must be a positive int, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from .framework import default_startup_program, program_guard
        from .layers import tensor as T
        from .layers import nn as L

        mini_out = self.inner_optimizer.minimize(
            loss, startup_program=startup_program)
        main = loss.block.program
        with program_guard(main, startup_program
                           or default_startup_program()):
            step = T.create_global_var(
                name=unique_name.generate("lookahead_step"), shape=[1],
                value=0.0, dtype="float32", persistable=True)
            one = T.fill_constant([1], "float32", 1.0)
            kf = T.fill_constant([1], "float32", float(self.k))
            new_step = L.elementwise_add(step, one)
            T.assign(new_step, step)
            mod = L.elementwise_mod(new_step, kf)
            sync = L.equal(mod, T.fill_constant([1], "float32", 0.0))
            syncf = T.cast(sync, "float32")
            params = [v for v in main.global_block().vars.values()
                      if getattr(v, "is_parameter", False)
                      and getattr(v, "trainable", True)]
            for p in params:
                slow = T.create_global_var(
                    name=unique_name.generate(p.name + "_slow"),
                    shape=list(p.shape), value=0.0, dtype=p.dtype,
                    persistable=True)
                # first sync initializes slow = fast (step 0 weights
                # are unknown at build time; k-step 1 copies them)
                new_slow = L.elementwise_add(
                    L.elementwise_mul(
                        L.elementwise_add(
                            L.elementwise_mul(p, T.fill_constant(
                                [1], "float32", self.alpha)),
                            L.elementwise_mul(slow, T.fill_constant(
                                [1], "float32", 1 - self.alpha))),
                        syncf),
                    L.elementwise_mul(slow, L.elementwise_sub(
                        one, syncf)))
                is_first = L.equal(new_step, kf)
                firstf = T.cast(is_first, "float32")
                new_slow = L.elementwise_add(
                    L.elementwise_mul(p, firstf),
                    L.elementwise_mul(new_slow,
                                      L.elementwise_sub(one, firstf)))
                new_fast = L.elementwise_add(
                    L.elementwise_mul(new_slow, syncf),
                    L.elementwise_mul(p, L.elementwise_sub(one, syncf)))
                T.assign(new_slow, slow)
                T.assign(new_fast, p)
        return mini_out


class RecomputeOptimizer:
    """Recompute: the backward re-runs the forward segments between the
    checkpoints (`_set_checkpoints`) instead of keeping their
    activations (fluid.backward.append_backward_with_checkpoints)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        from .backward import append_backward_with_checkpoints

        if not self._checkpoints:
            raise ValueError("call _set_checkpoints before minimize")
        return append_backward_with_checkpoints(
            loss, self._checkpoints, parameter_list)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .framework import default_startup_program, program_guard

        main = loss.block.program
        self._optimizer._startup_program = startup_program
        with program_guard(main, startup_program
                           or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self._optimizer.apply_gradients(params_grads)
        return opt_ops, params_grads


class PipelineOptimizer:
    """Paddle's SectionWorker pipeline rewrites a static program into
    section programs a device each; the reference does not carry that
    rewrite, and neither does the port."""

    def __init__(self, optimizer, num_microbatches=1, **kwargs):
        raise NotImplementedError(
            "PipelineOptimizer's section-program rewrite is not carried; "
            "pipeline parallelism comes with the parallel package "
            "(fleet's DistributedStrategy().pipeline)")
