"""paddle_tpu_torch.distributed.fleet — the Fleet API (counterpart of
paddle_tpu/distributed/fleet):

    fleet.init(is_collective=True)
    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    opt = fleet.distributed_optimizer(fluid.optimizer.Adam(1e-3), strategy)
    opt.minimize(loss)

The meta-optimizers rewrite the program as the reference's do (same
ops, attributes and order), and each rank's Executor runs it over the
process group."""

from .base import (DistributedStrategy, Fleet, PaddleCloudRoleMaker,  # noqa: F401
                   Role, UserDefinedRoleMaker, fleet)
from . import meta_optimizers  # noqa: F401
from . import utils  # noqa: F401
from . import metrics  # noqa: F401

# module-level delegation so `from paddle_tpu_torch.distributed import
# fleet; fleet.init(...)` works like the reference
init = fleet.init
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
worker_endpoints = fleet.worker_endpoints
is_server = fleet.is_server
barrier_worker = fleet.barrier_worker
init_worker = fleet.init_worker
stop_worker = fleet.stop_worker
init_server = fleet.init_server
run_server = fleet.run_server
distributed_optimizer = fleet.distributed_optimizer
distributed_model = fleet.distributed_model
save_inference_model = fleet.save_inference_model
save_persistables = fleet.save_persistables
minimize = fleet.minimize
from .base import UtilBase  # noqa: F401
from ...fluid.incubate.data_generator import (  # noqa: F401
    MultiSlotDataGenerator, MultiSlotStringDataGenerator)

# fleet.util: the singleton UtilBase the reference hangs off the fleet
# facade (util_factory._create_util)
util = UtilBase()
# lazy: resolve the role maker at CALL time so a later fleet.init()
# is honored (review finding: an import-time snapshot is always None)
util._set_role_maker(lambda: getattr(fleet, "_role_maker", None))
