"""hapi: the high-level Model API (counterpart of paddle_tpu/hapi)."""

from . import callbacks  # noqa: F401
from .model import Model, summary  # noqa: F401
