"""CompiledProgram: a Program run data-parallel over the process group
(counterpart of paddle_tpu/parallel/compiler.py and fluid/compiler.py).

The reference jits a block over a device mesh in one process: feeds cut
along the batch over the "data" axis, state replicated, and either XLA
inserts the gradient all-reduce (`_compile_spmd`) or the block's own
collective ops lower inside a `shard_map` (`_compile_shard_map`).  The
port runs one process a rank, as Paddle's collective mode does: each
rank's Executor runs the block on the rank's own feed and returns the
rank's own fetches (ROADMAP queue 3 item 42), and the block's collective
rules call `torch.distributed` (ops/collective_ops.py).  A program with
optimize ops and no collective op (one `with_data_parallel` is handed
without Fleet's transpile) runs through a clone that GradAllReduce has
transpiled, the all-reduce the reference's SPMD partitioner inserts.
`BuildStrategy.sync_batch_norm` runs the clone with `sync_batch_norm` in
place of each `batch_norm`, as Paddle's pass does; without it batch
norm is per rank, Paddle's default.

With no group, or a group of one, `Executor.run(compiled, ...)` runs the
program itself, so the same seed and feeds give today's bits.
`BuildStrategy.mesh_axes` may name only the data axis; another axis of
size above 1 waits for ROADMAP queue 1 item 10b and raises.  One process
drives one card: `places` naming more than one device raises (start a
rank a card with distributed.launch).
"""

from __future__ import annotations

from typing import Dict, Optional

from . import mesh as mesh_lib

_ONE_CARD = ("one process drives one card: start one rank a card "
             "(python -m paddle_tpu_torch.distributed.launch) instead of "
             "naming several places")

COLLECTIVE_OPS = ("barrier", "alltoall", "send_v2", "recv_v2",
                  "mp_allreduce_sum")


class BuildStrategy:
    """The reference's build knobs.  `mesh_axes` names the mesh (the data
    axis only in this slice); `sync_batch_norm` makes batch norm's
    statistics the group's.  The collective layout knobs
    (`reduce_strategy`, `gradient_scale_strategy`, `fuse_all_reduce_ops`)
    and `enable_inplace` are kept for parity: the gradients are
    all-reduced one op each, averaged, and the Executor frees each
    intermediate after its last use."""

    def __init__(self):
        self.reduce_strategy = "all_reduce"
        self.gradient_scale_strategy = "coeff_one"
        self.mesh_axes: Optional[Dict[str, int]] = None
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.sync_batch_norm = False


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


def has_collective_ops(program) -> bool:
    return any(op.type.startswith("c_") or op.type in COLLECTIVE_OPS
               for blk in program.blocks for op in blk.ops)


def _has_optimize_ops(program) -> bool:
    from ..fluid.framework import OpRole

    return any(op.attr("op_role", 0) & OpRole.Optimize
               and op.input("Grad") for op in program.global_block().ops)


def _sync_batch_norm(program) -> None:
    """batch_norm -> sync_batch_norm, the grad ops' forward type too."""
    for blk in program.blocks:
        for op in blk.ops:
            if op.type == "batch_norm":
                op.type = "sync_batch_norm"
            elif op.attr("fwd_op_type", None) == "batch_norm":
                op.attrs["fwd_op_type"] = "sync_batch_norm"
                if op.type == "batch_norm_grad":
                    op.type = "sync_batch_norm_grad"


class CompiledProgram:
    """compiler.CompiledProgram(program).with_data_parallel(...)."""

    def __init__(self, program, build_strategy: Optional[BuildStrategy] =
                 None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._loss_name = None
        self._mesh = None
        self._is_data_parallel = False
        self._run_program = None  # (program version, the program run)

    @property
    def program(self):
        return self._program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """The mesh over the group's ranks (BuildStrategy.mesh_axes, else
        every rank on the data axis); `share_vars_from` another
        CompiledProgram (both read the Executor's scope); `loss_name`
        and `exec_strategy` change nothing."""
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if _device_count(places) > 1:
            raise NotImplementedError(f"places={places}: {_ONE_CARD}")
        if share_vars_from is not None and not isinstance(
                share_vars_from, CompiledProgram):
            raise TypeError("share_vars_from takes a CompiledProgram")
        self._mesh = mesh_lib.make_mesh(self._build_strategy.mesh_axes)
        mesh_lib.set_current_mesh(self._mesh)
        self._loss_name = loss_name
        self._is_data_parallel = True
        self._run_program = None
        return self

    def _program_to_run(self):
        """The program itself, or (a group of more than one) its clone
        with the gradient all-reduce and the sync_batch_norm rewrite
        where they apply; rebuilt when the program changes."""
        from ..distributed import comm

        prog = self._program
        grads = comm.live() and not has_collective_ops(prog) \
            and _has_optimize_ops(prog)
        sync_bn = comm.live() and self._build_strategy.sync_batch_norm
        if not (self._is_data_parallel and (grads or sync_bn)):
            return prog
        key = (prog.version, grads, sync_bn)
        if self._run_program is None or self._run_program[0] != key:
            run = prog.clone()
            if grads:
                from ..fluid.framework import Program
                from ..fluid.transpiler import GradAllReduce

                n = comm.world()
                GradAllReduce().transpile(Program(), run, comm.rank(),
                                          ["127.0.0.1:0"] * n,
                                          "127.0.0.1:0")
            if sync_bn:
                _sync_batch_norm(run)
            self._run_program = (key, run)
        return self._run_program[1]

    def _run(self, executor, feed, fetch_list, scope, return_numpy=True):
        from ..distributed import comm

        executor._seed_rank = comm.rank() if comm.live() else 0
        try:
            return executor.run(self._program_to_run(), feed=feed,
                                fetch_list=fetch_list, scope=scope,
                                return_numpy=return_numpy)
        finally:
            executor._seed_rank = 0
