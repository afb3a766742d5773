"""Recompute meta-optimizer: the backward is rebuilt from user-marked
checkpoints by segment grad ops that re-run each segment
(fluid/backward.py append_backward_with_checkpoints)."""

from __future__ import annotations

from ....fluid.backward import append_backward_with_checkpoints
from .meta_optimizer_base import MetaOptimizerBase


class RecomputeOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.meta_optimizers_white_list = [
            "LarsOptimizer", "LambOptimizer", "GradientMergeOptimizer",
            "GraphExecutionOptimizer",
        ]

    def _can_apply(self):
        return (self.user_defined_strategy.recompute
                and self.user_defined_strategy
                .recompute_configs.get("checkpoints"))

    def _disable_strategy(self, dist_strategy):
        dist_strategy.recompute = False

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        ckpts = self.user_defined_strategy.recompute_configs["checkpoints"]
        return append_backward_with_checkpoints(
            loss, ckpts, parameter_list, no_grad_set)

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....fluid.framework import (default_startup_program,
                                         program_guard)

        self.inner_opt._startup_program = startup_program
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self.inner_opt.apply_gradients(params_grads)
        return opt_ops, params_grads
