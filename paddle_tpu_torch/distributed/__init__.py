"""paddle_tpu_torch.distributed — process topology and collectives
(counterpart of paddle_tpu/distributed) over `torch.distributed`, one
process a rank:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py
    # in train.py
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()          # nccl on cuda:FLAGS_selected_gpus

`spawn(func, args, nprocs)` starts the trainers from Python.  `fleet` is
the Fleet API (distributed.fleet).  `launch` is not imported here:
`python -m paddle_tpu_torch.distributed.launch` imports this package
first, and runpy would warn about a second copy of the module.
"""

from __future__ import annotations

from . import comm, parallel  # noqa: F401
from . import collective  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         barrier, broadcast, get_rank, get_world_size,
                         reduce_scatter, scatter)
from .parallel import (ParallelEnv, destroy_parallel_env,  # noqa: F401
                       init_parallel_env, prepare_context, process_count,
                       process_index)
from .spawn import spawn  # noqa: F401
from . import launch_utils  # noqa: F401


def __getattr__(name):
    if name == "fleet":
        import importlib

        return importlib.import_module(".fleet", __name__)
    raise AttributeError(name)
