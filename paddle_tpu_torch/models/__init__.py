"""Models of the port (counterpart of paddle_tpu.models)."""

from . import bert, transformer_wmt  # noqa: F401
