"""LAMB meta-optimizer: swaps the inner optimizer for LambOptimizer when
strategy.lamb is set."""

from __future__ import annotations

from ....fluid import optimizer as opt_mod
from .meta_optimizer_base import MetaOptimizerBase


class LambOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.lamb_opt = None
        self.meta_optimizers_white_list = ["GraphExecutionOptimizer"]

    def _can_apply(self):
        return (self.user_defined_strategy.lamb
                and self.inner_opt.__class__.__name__
                in ("AdamOptimizer", "AdamWOptimizer", "Adam", "AdamW"))

    def _disable_strategy(self, dist_strategy):
        dist_strategy.lamb = False

    def _init(self):
        if self.lamb_opt is not None:
            return
        cfg = self.user_defined_strategy.lamb_configs
        excluded = cfg.get("exclude_from_weight_decay", [])

        def exclude_fn(param):
            return any(e in param.name for e in excluded)

        self.lamb_opt = opt_mod.LambOptimizer(
            learning_rate=self.inner_opt._learning_rate,
            lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
            beta1=getattr(self.inner_opt, "_beta1", 0.9),
            beta2=getattr(self.inner_opt, "_beta2", 0.999),
            epsilon=getattr(self.inner_opt, "_epsilon", 1e-6),
            exclude_from_weight_decay_fn=exclude_fn if excluded else None)

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        self._init()
        return self.lamb_opt.minimize(loss, startup_program, parameter_list,
                                      no_grad_set)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        self._init()
        return self.lamb_opt.backward(loss, startup_program, parameter_list,
                                      no_grad_set)

    def apply_gradients(self, params_grads):
        return self.lamb_opt.apply_gradients(params_grads)
