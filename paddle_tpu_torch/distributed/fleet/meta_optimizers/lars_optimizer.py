"""LARS meta-optimizer: swaps Momentum for LarsMomentum when strategy.lars
is set."""

from __future__ import annotations

from ....fluid import optimizer as opt_mod
from .meta_optimizer_base import MetaOptimizerBase


class LarsOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.lars_opt = None
        self.meta_optimizers_white_list = ["GraphExecutionOptimizer"]

    def _can_apply(self):
        return (self.user_defined_strategy.lars
                and self.inner_opt.__class__.__name__
                in ("MomentumOptimizer", "Momentum"))

    def _disable_strategy(self, dist_strategy):
        dist_strategy.lars = False

    def _init(self):
        if self.lars_opt is not None:
            return
        cfg = self.user_defined_strategy.lars_configs
        self.lars_opt = opt_mod.LarsMomentumOptimizer(
            learning_rate=self.inner_opt._learning_rate,
            momentum=getattr(self.inner_opt, "_momentum", 0.9),
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            epsilon=cfg.get("epsilon", 0.0))

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        self._init()
        return self.lars_opt.minimize(loss, startup_program, parameter_list,
                                      no_grad_set)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        self._init()
        return self.lars_opt.backward(loss, startup_program, parameter_list,
                                      no_grad_set)

    def apply_gradients(self, params_grads):
        return self.lars_opt.apply_gradients(params_grads)
