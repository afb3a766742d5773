"""fleet.UtilBase (counterpart of paddle_tpu/distributed/fleet/base/
util_base.py): host-side utilities across workers.  The collectives run
over the live process group (numpy in, numpy out, through the group's
device); with no group there is one worker and they return its value."""

from __future__ import annotations

import numpy as np


class UtilBase:
    def __init__(self):
        self.role_maker = None
        self.dist_strategy = None

    def _set_strategy(self, dist_strategy):
        self.dist_strategy = dist_strategy

    def _set_role_maker(self, role_maker):
        """Accepts the role maker itself OR a zero-arg callable
        resolving to it — the fleet facade passes a callable so the
        util singleton always sees the role maker installed by a LATER
        fleet.init() (the reference builds util inside init; a static
        snapshot at import time would permanently see None)."""
        self.role_maker = role_maker

    def _role(self):
        rm = self.role_maker
        return rm() if callable(rm) else rm

    # -- host collectives -------------------------------------------------

    def _world(self):
        from ... import parallel

        return parallel.process_count(), parallel.process_index()

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        if mode not in ("sum", "min", "max"):
            # validated before the one-worker path: a bad mode fails on
            # one process too
            raise ValueError(f"all_reduce mode must be sum/min/max, "
                             f"got {mode!r}")
        from ... import comm

        a = np.asarray(input)
        if not comm.live():
            return a.copy()
        return comm.host_all_reduce(a, mode, comm.default_group())

    def all_gather(self, input, comm_world="worker"):
        from ... import comm

        if not comm.live():
            return [input]
        return comm.host_all_gather(input, comm.default_group())

    def barrier(self, comm_world="worker"):
        from ... import comm

        if comm.live():
            comm.barrier(comm.default_group())

    # -- file sharding / logging ------------------------------------------

    def get_file_shard(self, files):
        """Split `files` contiguously across workers (trainer i gets
        block i): the role maker's topology, else the group's."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file paths")
        rm = self._role()
        if rm is not None:
            idx = rm.worker_index()
            num = rm.worker_num()
        else:
            num, idx = self._world()
        base, remain = divmod(len(files), num)
        begin = idx * base + min(idx, remain)
        count = base + (1 if idx < remain else 0)
        return files[begin:begin + count]

    def print_on_rank(self, message, rank_id):
        rm = self._role()
        idx = (rm.worker_index() if rm is not None
               else self._world()[1])
        if idx == rank_id:
            print(message)
