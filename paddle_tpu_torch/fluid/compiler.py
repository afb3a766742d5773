"""CompiledProgram on one card (counterpart of paddle_tpu/fluid/compiler.py
over paddle_tpu/parallel/compiler.py:48-147).

`CompiledProgram(program).with_data_parallel(loss_name=...)` is how 1.x
scripts hand a program to the Executor.  On one card there is nothing to
split: `Executor.run(compiled, ...)` runs the program's block through the
Executor as `Executor.run(program, ...)` does, so the same seed and feeds
give the same bits.  Data parallelism over several cards (places naming
more than one device, `BuildStrategy.mesh_axes` whose product exceeds 1)
waits for ROADMAP queue 1 item 10 and raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

_MULTI = ("data parallelism over more than one device waits for ROADMAP "
          "queue 1 item 10 (parallel and distributed)")


class BuildStrategy:
    """The reference's build knobs.  On one card none of them changes
    what runs: the collective layout (`reduce_strategy`,
    `gradient_scale_strategy`, `fuse_all_reduce_ops`) has no collective
    to act on, and the Executor frees each intermediate after its last
    use whatever `enable_inplace` says.  `mesh_axes` of more than one
    device raises at with_data_parallel."""

    def __init__(self):
        self.reduce_strategy = "all_reduce"
        self.gradient_scale_strategy = "coeff_one"
        self.mesh_axes: Optional[Dict[str, int]] = None
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True


class ExecutionStrategy:
    """The reference's scheduling knobs, kept for parity: the Executor
    runs the block's ops in order on one stream."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1


def _device_count(places) -> int:
    if places is None:
        return 1
    if not isinstance(places, (list, tuple)):
        places = [places]
    return len({repr(p) for p in places})


class CompiledProgram:
    """compiler.CompiledProgram(program).with_data_parallel(...)."""

    def __init__(self, program, build_strategy: Optional[BuildStrategy] =
                 None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()

    @property
    def program(self):
        return self._program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """On one card: `places` may name one device, `share_vars_from`
        another CompiledProgram (both read the Executor's scope);
        `loss_name` and `exec_strategy` change nothing there."""
        if build_strategy is not None:
            self._build_strategy = build_strategy
        axes = self._build_strategy.mesh_axes or {}
        if math.prod(int(v) for v in axes.values()) > 1:
            raise NotImplementedError(
                f"BuildStrategy.mesh_axes={axes}: {_MULTI}")
        if _device_count(places) > 1:
            raise NotImplementedError(f"places={places}: {_MULTI}")
        if share_vars_from is not None and not isinstance(
                share_vars_from, CompiledProgram):
            raise TypeError("share_vars_from takes a CompiledProgram")
        return self

    def _run(self, executor, feed, fetch_list, scope, return_numpy=True):
        return executor.run(self._program, feed=feed, fetch_list=fetch_list,
                            scope=scope, return_numpy=return_numpy)
