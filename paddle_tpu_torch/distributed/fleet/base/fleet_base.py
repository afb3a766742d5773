"""Fleet facade: fleet.init / distributed_optimizer / minimize (counterpart
of paddle_tpu/distributed/fleet/base/fleet_base.py): a singleton that
composes meta-optimizers from the DistributedStrategy and rewrites the
user's program, in the reference's order, with its warning for a
dropped candidate.  `init` starts the process group when the role maker
counts more than one worker; `distributed_model` wraps a dygraph layer
in DataParallel under a group of more than one.  `sharding` annotates
the optimizer state for the compiler's SPMD arm (ShardingOptimizer);
`pipeline` waits for ROADMAP queue 1 item 10b (iv) and raises at
minimize.  There is no
parameter-server mode: init_server / run_server raise."""

from __future__ import annotations

from typing import Optional

from ..meta_optimizers import (AMPOptimizer, DGCOptimizer,
                               FP16AllReduceOptimizer,
                               GradientMergeOptimizer,
                               GraphExecutionOptimizer, LambOptimizer,
                               LarsOptimizer, LocalSGDOptimizer,
                               PipelineOptimizer, RecomputeOptimizer,
                               ShardingOptimizer)
from .distributed_strategy import DistributedStrategy
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase
from .strategy_compiler import StrategyCompiler

# canonical application order (outermost first); mirrors the reference's
# meta_optimizer_factory list order
_META_OPTIMIZER_CLASSES = [
    AMPOptimizer,
    RecomputeOptimizer,
    LarsOptimizer,
    LambOptimizer,
    PipelineOptimizer,
    ShardingOptimizer,
    LocalSGDOptimizer,
    DGCOptimizer,
    FP16AllReduceOptimizer,
    GradientMergeOptimizer,
    GraphExecutionOptimizer,
]


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._is_collective = True
        self._user_defined_strategy: Optional[DistributedStrategy] = None
        self._user_defined_optimizer = None
        self._context = {}
        self.strategy_compiler = StrategyCompiler()

    # -- lifecycle ---------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None):
        self._is_collective = is_collective
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._user_defined_strategy = strategy or DistributedStrategy()
        from ... import parallel as par

        # the group starts where the launcher's PADDLE_* contract names a
        # job of several ranks; a role maker that only describes one (a
        # program built for N workers in one process) starts nothing
        if self.worker_num() > 1 and par.process_count() > 1 \
                and not par.is_initialized():
            par.init_parallel_env()
        return self

    # -- topology ----------------------------------------------------------
    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def is_server(self):
        return False

    def barrier_worker(self):
        from ... import comm

        if comm.live():
            comm.barrier(comm.default_group())

    # -- PS mode: documented out of scope ---------------------------------
    def init_server(self, *args, **kwargs):
        raise NotImplementedError(
            "parameter-server mode is not supported; use collective mode "
            "(is_collective=True)")

    run_server = init_server
    init_worker = lambda self: None
    stop_worker = lambda self: None

    # -- checkpoint --------------------------------------------------------
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from ....fluid import io

        return io.save_inference_model(dirname, feeded_var_names,
                                       target_vars, executor, main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from ....fluid import io

        return io.save_persistables(executor, dirname, main_program)

    # -- the main event ----------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        self._user_defined_optimizer = optimizer
        if strategy is not None:
            self._user_defined_strategy = strategy
        return self

    def distributed_model(self, model):
        """DataParallel(model) under a group of more than one, else the
        model itself."""
        from ... import comm

        if comm.live():
            from ....fluid.dygraph.parallel import DataParallel

            return DataParallel(model)
        return model

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        strategy = self._user_defined_strategy
        inner = self._user_defined_optimizer
        if getattr(strategy, "pipeline", False):
            raise NotImplementedError(
                "DistributedStrategy.pipeline: waits for ROADMAP queue 1 "
                "item 10b (iv), the pipeline")
        candidates = []
        for cls in _META_OPTIMIZER_CLASSES:
            opt = cls(inner)
            opt._set_basic_info(loss, self._role_maker, inner, strategy)
            if opt._can_apply():
                candidates.append(opt)
        _, meta_opt, _ = self.strategy_compiler.generate_optimizer(
            loss, self._role_maker, inner, strategy, candidates, [])
        chain = self.strategy_compiler._meta_optimizers
        target = meta_opt if meta_opt is not None else inner
        # innermost wrapper delegates to the user optimizer
        if chain:
            chain[-1].inner_opt = inner
        # surface dropped candidates: flip their strategy flag off and warn
        dropped = [c for c in candidates if c not in chain]
        for c in dropped:
            c._disable_strategy(strategy)
            import warnings

            warnings.warn(
                f"fleet: {c.__class__.__name__} is incompatible with the "
                f"selected meta-optimizer chain and was NOT applied")
        optimize_ops, params_grads = target.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        self._context = {"applied_meta_list":
                         [c.__class__.__name__ for c in chain]}
        return optimize_ops, params_grads

    def applied_meta_list(self):
        return self._context.get("applied_meta_list", [])


fleet = Fleet()
