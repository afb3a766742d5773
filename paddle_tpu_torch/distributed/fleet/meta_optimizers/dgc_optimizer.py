"""DGC meta-optimizer: swaps a Momentum inner optimizer for DGC momentum.
DGC all-reduces its own (sparsified) gradients inside the optimize ops,
so this meta-optimizer keeps GraphExecutionOptimizer's plain gradient
all-reduce out of the chain (its white list leaves it out)."""

from __future__ import annotations

from ....fluid.optimizer import DGCMomentumOptimizer
from .meta_optimizer_base import MetaOptimizerBase


class DGCOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        # non-empty whitelist WITHOUT GraphExecutionOptimizer: DGC owns
        # the gradient communication
        self.meta_optimizers_white_list = ["GradientMergeOptimizer",
                                           "RecomputeOptimizer"]

    def _can_apply(self):
        try:
            return (self.user_defined_strategy.dgc
                    and self.role_maker.worker_num() > 1
                    and self.inner_opt.__class__.__name__
                    in ("MomentumOptimizer", "Momentum"))
        except Exception:
            return False

    def _disable_strategy(self, dist_strategy):
        dist_strategy.dgc = False

    def _enable_strategy(self, dist_strategy, context=None):
        dist_strategy.dgc = True

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        cfg = dict(self.user_defined_strategy.dgc_configs or {})
        inner = self.inner_opt
        dgc = DGCMomentumOptimizer(
            learning_rate=inner._learning_rate,
            momentum=getattr(inner, "_momentum", 0.9),
            rampup_begin_step=int(cfg.get("rampup_begin_step", 0)),
            rampup_step=int(cfg.get("rampup_step", 1)),
            sparsity=cfg.get("sparsity"),
            # keep the inner optimizer's training contract intact
            parameter_list=inner._parameter_list,
            regularization=inner.regularization,
            grad_clip=inner._grad_clip)
        return dgc.minimize(loss, startup_program, parameter_list,
                            no_grad_set)
