"""GraphExecution meta-optimizer: applies the GradAllReduce collective
transpile (fluid/transpiler/collective.py), giving the per-rank program
each rank's Executor runs over the process group."""

from __future__ import annotations

from ....fluid.transpiler.collective import GradAllReduce
from .meta_optimizer_base import MetaOptimizerBase


class GraphExecutionOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self._transpiled_programs = set()

    def _can_apply(self):
        # applies whenever training collectively with >1 rank, except
        # under ZeRO (strategy.sharding), which owns the gradient
        # reduction (the reference's rule)
        try:
            if self.user_defined_strategy.sharding:
                return False
            return self.role_maker.worker_num() > 1
        except Exception:
            return False

    def _transpile(self, loss, startup_program):
        from ....fluid.framework import default_startup_program

        main = loss.block.program
        if id(main) in self._transpiled_programs:
            return
        self._transpiled_programs.add(id(main))
        startup = startup_program or default_startup_program()
        nranks = self.role_maker.worker_num()
        t = GradAllReduce(nrings=1)
        t.transpile(startup, main, self.role_maker.worker_index(),
                    self.role_maker.get_trainer_endpoints() or
                    ["127.0.0.1:0"] * nranks,
                    "127.0.0.1:0")

    def apply_gradients(self, params_grads):
        # chained mode (an outer meta-opt drives backward/apply): transpile
        # right after the optimizer ops land
        ret = self.inner_opt.apply_gradients(params_grads)
        if params_grads:
            self._transpile(params_grads[0][1], None)
        return ret

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        ret = self.inner_opt.minimize(loss, startup_program,
                                      parameter_list, no_grad_set)
        self._transpile(loss, startup_program)
        return ret
