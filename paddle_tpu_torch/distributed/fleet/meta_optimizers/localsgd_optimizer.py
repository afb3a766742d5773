"""LocalSGD meta-optimizer: train locally and average the parameters over
the ranks every k steps through the LocalSGD transpile.  k_steps > 1
keeps per-rank parameters apart between syncs, which the reference runs
through its mesh-level step; that waits for ROADMAP queue 1 item 10b."""

from __future__ import annotations

from ....fluid.transpiler.collective import LocalSGD
from .meta_optimizer_base import MetaOptimizerBase


class LocalSGDOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)

    def _can_apply(self):
        return (self.user_defined_strategy.localsgd
                and self.inner_opt.__class__.__name__
                in ("SGDOptimizer", "SGD", "MomentumOptimizer", "Momentum"))

    def _disable_strategy(self, dist_strategy):
        dist_strategy.localsgd = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....fluid.framework import default_startup_program

        ret = self.inner_opt.minimize(loss, startup_program,
                                      parameter_list, no_grad_set)
        cfg = self.user_defined_strategy.localsgd_configs
        if int(cfg.get("k_steps", 1)) > 1:
            raise NotImplementedError(
                "localsgd k_steps>1 in static-program mode: the mesh-level "
                "step (parallel/localsgd.py) waits for ROADMAP queue 1 "
                "item 10b")
        t = LocalSGD(k_steps=int(cfg.get("k_steps", 1)))
        nranks = self.role_maker.worker_num()
        t.transpile(startup_program or default_startup_program(),
                    loss.block.program, self.role_maker.worker_index(),
                    ["127.0.0.1:0"] * nranks, "127.0.0.1:0")
        return ret
