"""fluid.layers: the op-emitting layer library (counterpart of
paddle_tpu/fluid/layers/, the functions the ported programs call)."""

from . import math_op_patch  # noqa: F401 - installs Variable operator sugar
from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from . import tensor, nn, loss  # noqa: F401
