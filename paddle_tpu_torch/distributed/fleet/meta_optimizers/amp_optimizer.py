"""AMP meta-optimizer: wraps the inner optimizer with the mixed-precision
decorator.  The default is bf16 (no loss scaling); set
amp_configs["dtype"]="float16" for fp16 with dynamic loss scaling."""

from __future__ import annotations

from ....fluid.contrib.mixed_precision import (AutoMixedPrecisionLists,
                                               decorate)
from .meta_optimizer_base import MetaOptimizerBase


class AMPOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.amp_opt = None
        self.meta_optimizers_white_list = [
            "RecomputeOptimizer", "LarsOptimizer", "LambOptimizer",
            "GradientMergeOptimizer", "GraphExecutionOptimizer",
        ]

    def _can_apply(self):
        return self.user_defined_strategy.amp

    def _disable_strategy(self, dist_strategy):
        dist_strategy.amp = False

    def _init_wrapped_opt(self):
        if self.amp_opt is not None:
            return
        cfg = self.user_defined_strategy.amp_configs
        lists = AutoMixedPrecisionLists(
            custom_white_list=cfg.get("custom_white_list"),
            custom_black_list=cfg.get("custom_black_list"))
        self.amp_opt = decorate(
            self.inner_opt, lists,
            init_loss_scaling=cfg.get("init_loss_scaling", 32768.0),
            incr_every_n_steps=cfg.get("incr_every_n_steps", 1000),
            decr_every_n_nan_or_inf=cfg.get("decr_every_n_nan_or_inf", 2),
            incr_ratio=cfg.get("incr_ratio", 2.0),
            decr_ratio=cfg.get("decr_ratio", 0.5),
            use_dynamic_loss_scaling=cfg.get("use_dynamic_loss_scaling",
                                             True),
            dtype=cfg.get("dtype", "bfloat16"))

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        self._init_wrapped_opt()
        return self.amp_opt.backward(loss, startup_program, parameter_list,
                                     no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        return self.amp_opt.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.amp_opt.apply_gradients(params_grads)

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        self._init_wrapped_opt()
        return self.amp_opt.minimize(loss, startup_program, parameter_list,
                                     no_grad_set)
