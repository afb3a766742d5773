from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import Fleet, fleet  # noqa: F401
from .role_maker import (PaddleCloudRoleMaker, Role, RoleMakerBase,  # noqa: F401
                         UserDefinedRoleMaker)
from .util_base import UtilBase  # noqa: F401
