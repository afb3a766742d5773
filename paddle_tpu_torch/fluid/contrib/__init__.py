"""fluid.contrib (counterpart of paddle_tpu/fluid/contrib): the static
AMP decorator, `mixed_precision`, quantization-aware training, `slim`,
and `reader.distributed_batch_reader`."""

from . import mixed_precision  # noqa: F401
from . import reader  # noqa: F401
from . import slim  # noqa: F401
