"""paddle_tpu_torch.vision — the vision models, their train step and the
vision datasets (counterpart of paddle_tpu.vision; its `transforms` wait
for ROADMAP queue 1 item 12)."""

from . import datasets, models, train  # noqa: F401
