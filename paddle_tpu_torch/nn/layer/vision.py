"""`paddle.nn.vision` (counterpart of paddle_tpu/nn/layer/vision.py):
PixelShuffle lives in common.py; this module mirrors the reference's
submodule so that `nn.vision` resolves."""

from .common import PixelShuffle  # noqa: F401
