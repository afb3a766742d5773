"""FP16/bf16-allreduce meta-optimizer: gradients cross between the ranks
in half precision (bf16 by default: half the bytes with f32's exponent
range, so the comm path needs no loss scaling)."""

from __future__ import annotations

from ....fluid.transpiler.collective import FP16AllReduce
from .meta_optimizer_base import MetaOptimizerBase


class FP16AllReduceOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        # replaces the plain GradAllReduce transpile: a non-empty
        # whitelist WITHOUT GraphExecutionOptimizer keeps it out of the
        # chain (strategy_compiler honors whitelists, not blacklists)
        self.meta_optimizers_white_list = ["GradientMergeOptimizer",
                                           "RecomputeOptimizer"]

    def _can_apply(self):
        try:
            return (self.user_defined_strategy.fp16_allreduce
                    and self.role_maker.worker_num() > 1)
        except Exception:
            return False

    def _disable_strategy(self, dist_strategy):
        dist_strategy.fp16_allreduce = False

    def _enable_strategy(self, dist_strategy, context=None):
        dist_strategy.fp16_allreduce = True

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....fluid.framework import default_startup_program

        ret = self.inner_opt.minimize(loss, startup_program,
                                      parameter_list, no_grad_set)
        nranks = self.role_maker.worker_num()
        t = FP16AllReduce(nrings=1)
        t.transpile(startup_program or default_startup_program(),
                    loss.block.program, self.role_maker.worker_index(),
                    self.role_maker.get_trainer_endpoints() or
                    ["127.0.0.1:0"] * nranks, "127.0.0.1:0")
        return ret
