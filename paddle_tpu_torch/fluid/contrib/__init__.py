"""fluid.contrib (counterpart of paddle_tpu/fluid/contrib): the static
AMP decorator, `mixed_precision`.  `slim` (quantization-aware training)
comes with the quantize bucket and `reader` with the data pipeline
(ROADMAP queue 1 items 8 and 11)."""

from . import mixed_precision  # noqa: F401
