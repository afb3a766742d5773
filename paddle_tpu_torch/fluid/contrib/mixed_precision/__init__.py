"""fluid.contrib.mixed_precision: the static-graph AMP decorator, its op
lists and the cast rewrite (counterpart of
paddle_tpu/fluid/contrib/mixed_precision)."""

from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import cast_model_to_fp16, rewrite_program  # noqa: F401
