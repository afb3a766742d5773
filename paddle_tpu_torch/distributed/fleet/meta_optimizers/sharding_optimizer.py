"""Sharding (ZeRO) meta-optimizer (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers/sharding_optimizer.py).

ZeRO is an annotation here, as in the reference: the optimizer's
accumulators (stage 1 and up) and, at stage 3, the parameters get
`_sharding_axes = ("fsdp", "data")`.  The compiler's SPMD arm
(parallel/compiler.py) reads it through `spec_layout.spec_for`: dim 0
over the first of those axes the mesh has and that divides it, so each
rank's scope keeps only its shard, the gradients are reduce-scattered to
it and the update runs on it.  Stage 2 adds nothing: the gradients are
intermediates, reduce-scattered already once the accumulators are
sharded."""

from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase


def _annotate(var, axes=("fsdp", "data")):
    # preference order, not a product: the spec registry picks the
    # first axis present in the mesh that divides dim 0
    var._sharding_axes = tuple(axes)


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
        stage = int(self.user_defined_strategy
                    .sharding_configs.get("stage", 1))
        ret = self.inner_opt.minimize(loss, startup_program,
                                      parameter_list, no_grad_set)
        _, params_grads = ret
        # stage 1: the optimizer's accumulators over the data axes
        accs = getattr(self.inner_opt, "_accumulators", {})
        for per_param in accs.values():
            for var in per_param.values():
                if var.shape and len(var.shape) >= 1 and var.shape[0] != 1:
                    _annotate(var)
        if stage >= 3:
            for p, _ in params_grads:
                if p.shape and len(p.shape) >= 1:
                    _annotate(p)
        return ret
