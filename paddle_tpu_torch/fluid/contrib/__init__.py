"""fluid.contrib (counterpart of paddle_tpu/fluid/contrib): the static
AMP decorator, `mixed_precision`, and quantization-aware training,
`slim`.  `reader` comes with the data pipeline (ROADMAP queue 1 item
11)."""

from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401
