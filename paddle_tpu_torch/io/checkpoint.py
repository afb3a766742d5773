"""The array-checkpoint surface over `paddle_tpu_torch.ckpt` (counterpart
of paddle_tpu/io/checkpoint.py).

* `save_state` goes through `ckpt.write_state`: shard file + fsync'd
  manifest + atomic rename, so no caller sees a torn or partial dir.
* `load_state` reads the ckpt manifest format and returns CPU tensors.
  The reference's fallback to its older orbax layout is left out: no
  such directory was ever written by this package.
* `AsyncSaver` rides a `ckpt.WriterPool`: `save()` snapshots and
  returns, `wait()` joins the write and re-raises what the writer thread
  hit.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_async_mgr = None
_async_lock = threading.Lock()


def save_state(state: Dict[str, Any], path: str):
    """Synchronous atomic save of a flat {name: tensor or array} dict."""
    from ..ckpt import write_state

    state = {k: v for k, v in state.items() if v is not None}
    if not state:
        raise ValueError(
            "save_state: empty state — nothing to checkpoint (did you "
            "pass the right program/scope? persistables resolve against "
            "the DEFAULT program unless one is given)")
    write_state(path, state)


def load_state(path: str, target: Optional[Dict[str, Any]] = None
               ) -> Dict[str, torch.Tensor]:
    """The dict `save_state` wrote (a checkpoint root gives its newest
    checkpoint).  With `target` (name -> tensor), each value takes its
    target's dtype and device."""
    from ..ckpt import read_state

    out, _ = read_state(path)
    if target is not None:
        for k, t in target.items():
            if k in out and isinstance(t, torch.Tensor):
                out[k] = out[k].to(device=t.device, dtype=t.dtype)
    return out


class AsyncSaver:
    """Background writer: `save()` snapshots and returns at once, `wait()`
    (or the next save) joins the write and re-raises any writer-thread
    exception.  One outstanding write at a time."""

    def __init__(self):
        from ..ckpt import WriterPool

        self._pool = WriterPool(max_in_flight=1, name="io-async-saver")

    def save(self, state: Dict[str, Any], path: str):
        # copies before returning, so training may update the tensors in
        # place while the writer runs
        snap = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                else np.array(v) for k, v in state.items() if v is not None}
        self._pool.submit(lambda: save_state(snap, path))

    def wait(self):
        self._pool.wait()


def async_save(state: Dict[str, Any], path: str) -> AsyncSaver:
    global _async_mgr
    with _async_lock:
        if _async_mgr is None:
            _async_mgr = AsyncSaver()
    _async_mgr.save(state, path)
    return _async_mgr
