"""Auto-checkpoint: preemption recovery a training epoch (counterpart of
paddle_tpu/fluid/incubate/checkpoint/auto_checkpoint.py, Paddle's EDL
`TrainEpochRange` and `AutoCheckpointChecker`).

The checkpoints live under `<PADDLE_TPU_CHECKPOINT_DIR or
ckpt_dir>/<PADDLE_JOB_ID>/acp_epoch_<n>/` (the reference's environment
names and layout): the scope's persistables through `io.checkpoint.
save_state` (the ckpt commit protocol) and a `meta.json`, the directory
published with one `os.replace`, so a preemption in a save never leaves
a torn epoch.  Entering `train_epoch_range` restores the newest complete
epoch and resumes after it.

    import paddle_tpu_torch.fluid.incubate.checkpoint.auto_checkpoint as acp

    for epoch in acp.train_epoch_range(10):
        for batch in loader():
            exe.run(main, feed=..., fetch_list=[...])
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Optional

_JOB_ENV = "PADDLE_JOB_ID"
_DIR_ENV = "PADDLE_TPU_CHECKPOINT_DIR"
_CKPT_PREFIX = "acp_epoch_"


class AutoCheckpointChecker:
    """The job's checkpoint directory and id, from the arguments or the
    environment."""

    def __init__(self, job_id: Optional[str] = None,
                 ckpt_dir: Optional[str] = None):
        self.job_id = job_id or os.environ.get(_JOB_ENV, "default_job")
        self.ckpt_dir = ckpt_dir or os.environ.get(_DIR_ENV)

    def valid(self) -> bool:
        return bool(self.ckpt_dir)

    def job_dir(self) -> str:
        return os.path.join(self.ckpt_dir, self.job_id)


def _complete_epochs(job_dir):
    if not os.path.isdir(job_dir):
        return []
    out = []
    for name in os.listdir(job_dir):
        if name.startswith(_CKPT_PREFIX):
            meta = os.path.join(job_dir, name, "meta.json")
            if os.path.exists(meta):  # published by a rename: complete
                out.append(int(name[len(_CKPT_PREFIX):]))
    return sorted(out)


class TrainEpochRange:
    """Iterable over epochs that saves at an epoch's end and restores on
    entry (`save_checkpoint_inter` seconds between saves, 0 = every
    epoch; the newest `keep_max` kept)."""

    def __init__(self, max_epoch_num: int, name: Optional[str] = None,
                 checker: Optional[AutoCheckpointChecker] = None,
                 save_checkpoint_inter: int = 0, keep_max: int = 3,
                 program=None, scope=None):
        self.max_epoch_num = max_epoch_num
        self.name = name or "train"
        self.checker = checker or AutoCheckpointChecker()
        self.save_inter = save_checkpoint_inter
        self.keep_max = keep_max
        self._program = program
        self._scope = scope
        self._last_save = 0.0
        self.restored_epoch = -1

    def _names_and_scope(self):
        from ...executor import global_scope
        from ...framework import default_main_program
        from ...io import _persistable_names

        program = self._program or default_main_program()
        scope = self._scope or global_scope()
        return _persistable_names(program), scope

    def _save(self, epoch: int):
        from ....io.checkpoint import save_state

        job_dir = self.checker.job_dir()
        os.makedirs(job_dir, exist_ok=True)
        names, scope = self._names_and_scope()
        state = {n: scope.get(n) for n in names
                 if scope.has(n) and scope.get(n) is not None}
        final = os.path.join(job_dir, f"{_CKPT_PREFIX}{epoch}")
        tmp = tempfile.mkdtemp(dir=job_dir, prefix=".tmp_")
        try:
            save_state(state, os.path.join(tmp, "state"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"epoch": epoch, "name": self.name,
                           "time": time.time()}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        done = _complete_epochs(job_dir)
        for old in done[:-self.keep_max]:
            shutil.rmtree(os.path.join(job_dir, f"{_CKPT_PREFIX}{old}"),
                          ignore_errors=True)

    def _restore(self) -> int:
        from ....io.checkpoint import load_state

        job_dir = self.checker.job_dir()
        done = _complete_epochs(job_dir)
        if not done:
            return -1
        epoch = done[-1]
        state = load_state(os.path.join(job_dir, f"{_CKPT_PREFIX}{epoch}",
                                        "state"))
        names, scope = self._names_and_scope()
        keep = set(names)
        for n, v in state.items():
            if n in keep:
                old = scope.get(n) if scope.has(n) else None
                # the live tensor's dtype and device, when there is one
                scope.set(n, v.to(device=old.device, dtype=old.dtype)
                          if hasattr(old, "device") else v)
        return epoch

    def __iter__(self):
        if not self.checker.valid():
            # no checkpoint dir: a plain range()
            for e in range(self.max_epoch_num):
                yield e
            return
        self.restored_epoch = self._restore()
        for e in range(self.restored_epoch + 1, self.max_epoch_num):
            yield e
            now = time.time()
            if self.save_inter <= 0 or \
                    now - self._last_save >= self.save_inter:
                self._save(e)
                self._last_save = now


def train_epoch_range(max_epoch_num: int, save_checkpoint_inter: int = 0,
                      **kw) -> TrainEpochRange:
    return TrainEpochRange(max_epoch_num,
                           save_checkpoint_inter=save_checkpoint_inter,
                           **kw)
