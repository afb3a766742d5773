"""Models of the port (counterpart of paddle_tpu.models)."""

from . import bert  # noqa: F401
