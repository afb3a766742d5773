"""fluid.incubate (counterpart of paddle_tpu/fluid/incubate): the
MultiSlot data generator and the epoch auto-checkpoint."""

from . import checkpoint, data_generator  # noqa: F401
