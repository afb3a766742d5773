"""Pipeline meta-optimizer: carries the strategy's config.  The pipelined
run itself (parallel/pipeline.py, PipelineOptimizer's sections) waits
for ROADMAP queue 1 item 10b: minimize and build_pipeline raise."""

from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase

_LATER = ("the pipeline strategy waits for ROADMAP queue 1 item 10b (the "
          "model-parallel half of the collective path)")


class PipelineOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.meta_optimizers_white_list = ["RecomputeOptimizer",
                                           "AMPOptimizer"]

    def _can_apply(self):
        return bool(getattr(self.user_defined_strategy, "pipeline", False))

    def _disable_strategy(self, dist_strategy):
        dist_strategy.pipeline = False

    def _enable_strategy(self, dist_strategy, context=None):
        dist_strategy.pipeline = True
        dist_strategy.pipeline_configs = {"micro_batch": 1}

    @property
    def micro_batch(self):
        cfgs = getattr(self.user_defined_strategy, "pipeline_configs", {})
        return int(cfgs.get("micro_batch", 1)
                   if isinstance(cfgs, dict) else 1)

    def build_pipeline(self, mesh, stage_fn, num_microbatches=None,
                       axis="pp"):
        raise NotImplementedError(_LATER)

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        raise NotImplementedError(_LATER)
