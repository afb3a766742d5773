"""fluid.incubate (counterpart of paddle_tpu/fluid/incubate): the
MultiSlot data generator.  The auto-checkpoint half waits for ROADMAP
queue 1 item 11 (ckpt/)."""

from . import data_generator  # noqa: F401
