"""fluid.contrib.slim (counterpart of paddle_tpu/fluid/contrib/slim):
quantization-aware training, a static Program pass and a dygraph
wrapper."""

from .quantization import (  # noqa: F401
    QuantizationTransformPass, ImperativeQuantAware,
)

__all__ = ["QuantizationTransformPass", "ImperativeQuantAware"]
