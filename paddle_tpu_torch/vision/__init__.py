"""paddle_tpu_torch.vision — the vision models and their train step
(counterpart of paddle_tpu.vision)."""

from . import models, train  # noqa: F401
