"""Fleet meta-optimizers: strategy-driven program rewrites (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers).  Each wraps an inner
Optimizer and rewrites the Program as the reference's does."""

from .meta_optimizer_base import MetaOptimizerBase  # noqa: F401
from .amp_optimizer import AMPOptimizer  # noqa: F401
from .recompute_optimizer import RecomputeOptimizer  # noqa: F401
from .gradient_merge_optimizer import GradientMergeOptimizer  # noqa: F401
from .sharding_optimizer import ShardingOptimizer  # noqa: F401
from .lamb_optimizer import LambOptimizer  # noqa: F401
from .lars_optimizer import LarsOptimizer  # noqa: F401
from .graph_execution_optimizer import GraphExecutionOptimizer  # noqa: F401
from .localsgd_optimizer import LocalSGDOptimizer  # noqa: F401
from .dgc_optimizer import DGCOptimizer  # noqa: F401
from .fp16_allreduce_optimizer import FP16AllReduceOptimizer  # noqa: F401
from .pipeline_optimizer import PipelineOptimizer  # noqa: F401
