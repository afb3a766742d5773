"""paddle_tpu_torch.ckpt — training checkpoints (counterpart of
paddle_tpu.ckpt, whose checkpoints it reads and which reads its own).

* `CheckpointManager` — a snapshot at a step boundary (CUDA tensors
  copied into pinned host memory on a side stream) handed to a
  background `WriterPool` (bounded in flight, backpressure); atomic
  commits (shard file + fsync'd manifest renamed last); retention of the
  newest `keep`.
* Mid-epoch resume — `Executor.train_from_dataset` records
  `(feed_epoch, step_in_epoch, executor_step, feed_seed)` in the
  manifest's `meta` and skips the consumed batches of a resumed epoch.
* `serving.ProgramModel.reload_weights(path)` / `ModelRegistry.
  reload_weights` — swap a live model's parameters from a checkpoint.

Knobs: `FLAGS_ckpt_*` (fluid/flags.py), seeded from the PADDLE_CKPT_*
environment variables as in the reference.
"""

from __future__ import annotations

from .manifest import (CKPT_PREFIX, CheckpointError,  # noqa: F401
                       MANIFEST_FILE, MANIFEST_FORMAT, TMP_PREFIX,
                       latest_checkpoint, list_checkpoints,
                       shard_assignment)
from .manager import (CheckpointManager, read_state,  # noqa: F401
                      write_state)
from .writer import WriterPool  # noqa: F401

__all__ = [
    "CheckpointManager", "CheckpointError", "WriterPool",
    "latest_checkpoint", "list_checkpoints", "shard_assignment",
    "read_state", "write_state", "MANIFEST_FILE", "MANIFEST_FORMAT",
    "CKPT_PREFIX", "TMP_PREFIX",
]
