"""Sharding (ZeRO) meta-optimizer.  The reference annotates optimizer
state (and, at stage 3, parameters) with a sharding over the mesh; the
port's sharded state over the process group waits for ROADMAP queue 1
item 10b, so minimize raises."""

from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase


class ShardingOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.meta_optimizers_white_list = ["GraphExecutionOptimizer"]

    def _can_apply(self):
        return self.user_defined_strategy.sharding

    def _disable_strategy(self, dist_strategy):
        dist_strategy.sharding = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        raise NotImplementedError(
            "the sharding strategy (ZeRO) waits for ROADMAP queue 1 item "
            "10b (the model-parallel half of the collective path)")
