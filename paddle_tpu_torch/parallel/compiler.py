"""CompiledProgram: a Program run over the process group's mesh
(counterpart of paddle_tpu/parallel/compiler.py and fluid/compiler.py).

The reference jits a block over a device mesh in one process: either XLA
partitions it from the state's PartitionSpecs (`_compile_spmd`) or the
block's own collective ops lower inside a `shard_map`
(`_compile_shard_map`).  The port runs one process a rank, as Paddle's
collective mode does, and has three arms:

* **per rank** (a program with collective ops): each rank's Executor runs
  the block on the rank's own feed and returns the rank's own fetches
  (ROADMAP queue 3 item 42), and the collective rules call
  `torch.distributed` (ops/collective_ops.py); ring 0 is the mesh's data
  axis, the reference's ring-to-axis mapping, and the state stays
  replicated.
* **data** (no collective op, a mesh whose axes above 1 are the data
  axis, no `_sharding_axes` annotation): a clone that GradAllReduce has
  transpiled, the all-reduce the reference's SPMD partitioner inserts;
  `BuildStrategy.sync_batch_norm` swaps batch norm for sync_batch_norm,
  as Paddle's pass does.
* **SPMD** (no collective op, and an fsdp / tp axis above 1 or a state
  var annotated by ShardingOptimizer): ZeRO-3 / FSDP's schedule on the
  static program (`_SpmdStep`).  Between steps each rank's scope holds
  only its shard of every var whose `spec_layout.spec_for` is not P(),
  parameters and optimizer accumulators alike.  A step all-gathers the
  sharded vars the forward and backward read, runs those ops on the
  rank's rows of the global batch (cut over data x fsdp by
  `mesh.batch_spec`), reduce-scatters each sharded parameter's gradient
  over the batch axes (a mean: the loss is the batch's mean) down to its
  shard, all-reduces the replicated ones, and runs the optimize ops on
  the shards.  As the reference's exe.run, it takes the global batch;
  its fetches are the rank's own (the loss of its rows).  With
  `FLAGS_quant_collectives=int8` and batch axes above 1, each parameter
  gradient the wire takes (`_quantizes`) crosses the batch axes as
  `quant_allreduce_sum / nbatch` (the reference's quantized SPMD step),
  and `collective_bytes_spmd_all_reduce` counts its int8 wire.

With no group, or a group of one, `Executor.run(compiled, ...)` runs the
program itself, so the same seed and feeds give today's bits.  One
process drives one card: `places` naming more than one device raises
(start a rank a card with distributed.launch).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import mesh as mesh_lib
from . import spec_rules

_ONE_CARD = ("one process drives one card: start one rank a card "
             "(python -m paddle_tpu_torch.distributed.launch) instead of "
             "naming several places")

COLLECTIVE_OPS = ("barrier", "alltoall", "send_v2", "recv_v2",
                  "mp_allreduce_sum")


class BuildStrategy:
    """The reference's build knobs.  `mesh_axes` names the mesh over the
    group's ranks (data, fsdp, tp: parallel/mesh.py); `sync_batch_norm`
    makes batch norm's statistics the group's (the data arm).  The collective layout knobs
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
        self._spmd_plans = {}  # the SPMD arm's plans, by program and feeds

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
        self._spmd_plans = {}
        return self

    def _spmd(self, prog) -> bool:
        """Whether the SPMD arm runs `prog`: no collective op, and a mesh
        axis other than the data axis above 1 or a state var that
        ShardingOptimizer annotated."""
        from ..distributed import comm

        mesh = self._mesh
        if not (self._is_data_parallel and comm.live() and mesh is not None
                and mesh.device_mesh is not None) \
                or has_collective_ops(prog):
            return False
        if any(s > 1 for a, s in mesh.shape.items()
               if a not in mesh_lib.DATA_AXES):
            return True
        return any(getattr(v, "_sharding_axes", None)
                   for v in prog.global_block().vars.values())

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

                n = comm.world(comm.default_group())
                GradAllReduce().transpile(Program(), run, comm.rank(),
                                          ["127.0.0.1:0"] * n,
                                          "127.0.0.1:0")
            if sync_bn:
                _sync_batch_norm(run)
            self._run_program = (key, run)
        return self._run_program[1]

    def _run(self, executor, feed, fetch_list, scope, return_numpy=True):
        from ..distributed import comm

        prog = self._program
        if self._spmd(prog):
            if self._build_strategy.sync_batch_norm:
                raise NotImplementedError(
                    "sync_batch_norm on the SPMD arm: batch norm there is "
                    "per rank; the data arm (a mesh of the data axis "
                    "alone) takes it")
            return _run_spmd(self, executor, feed, fetch_list, scope,
                             return_numpy)
        executor._seed_rank = comm.rank() if comm.live() else 0
        try:
            return executor.run(self._program_to_run(), feed=feed,
                                fetch_list=fetch_list, scope=scope,
                                return_numpy=return_numpy)
        finally:
            executor._seed_rank = 0


# -- the SPMD arm ----------------------------------------------------------------

# optimize-segment ops that may run on shards: elementwise over their
# operands of one shape (the optimizer updates, the regularizers' scale
# and sum); another op reading a sharded value raises
ELEMENTWISE_UPDATES = frozenset((
    "sgd", "momentum", "adam", "adamw", "adamax", "adagrad", "rmsprop",
    "adadelta", "decayed_adagrad", "ftrl", "scale", "sum", "assign",
    "cast", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div"))


def _count_bytes(kind: str, t) -> None:
    from ..profiler import stat_add

    stat_add(f"collective_bytes_spmd_{kind}", t.numel() * t.element_size())


def _gather_dim(x, dim: int, group):
    """All ranks' x of `group` concatenated along `dim`, in group-rank
    order."""
    from ..distributed import comm

    out = comm.all_gather(x.movedim(dim, 0).contiguous(), group)
    _count_bytes("all_gather", out)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(x, dim: int, group):
    """This rank's block along `dim` of the group's sum of x."""
    from ..distributed import comm

    _count_bytes("reduce_scatter", x)
    out = comm.reduce_scatter(x.movedim(dim, 0).contiguous(), group)
    return out.movedim(0, dim).contiguous()


def shard_of(full, spec, mesh):
    """This rank's shard of a full tensor laid out by `spec` over `mesh`:
    each dim cut into the product of its entry's axes, block
    `mesh.block_index` (the entry's first axis the major one), as
    DTensor's placements (`spec_layout.placements`) cut it."""
    x = full
    for dim, entry in enumerate(tuple(spec)):
        idx, n = mesh_lib.block_index(mesh, spec_rules.entry_names(entry))
        if n > 1:
            k = x.shape[dim] // n
            x = x.narrow(dim, idx * k, k)
    return x.clone()


def gather_full(shard, spec, mesh):
    """The full tensor from every rank's shard: an all-gather a sharded
    axis, the minor axis of an entry first."""
    x = shard
    for dim, entry in enumerate(tuple(spec)):
        for a in reversed(spec_rules.entry_names(entry)):
            if int(mesh.shape[a]) > 1:
                x = _gather_dim(x, dim, mesh_lib.axis_group(mesh, a))
    return x


def _spread(mesh, axes):
    """The mesh's axes above 1 that `axes` leaves out."""
    return [a for a in mesh.axis_names
            if int(mesh.shape[a]) > 1 and a not in axes]


def reduce_to_shard(g, spec, mesh, batch_axes, n_batch: int):
    """This rank's shard of the batch axes' mean of g: a reduce-scatter
    along the dim a batch axis splits, a slice along the dim another
    axis splits (its ranks hold the same g), and an all-reduce over each
    axis the spec does not name, a batch axis's summing the rows' shares
    and another's averaging its ranks' copies of one value (CUDA's atomic
    adds may leave them apart in the last bits), so every rank holding
    this shard holds the same bits."""
    from ..distributed import comm

    x, named, copies = g, set(), 1
    for dim, entry in enumerate(tuple(spec)):
        for a in spec_rules.entry_names(entry):
            n = int(mesh.shape[a])
            named.add(a)
            if n == 1:
                continue
            if a in batch_axes:
                x = _reduce_scatter_dim(x, dim, mesh_lib.axis_group(mesh, a))
            else:
                k = x.shape[dim] // n
                x = x.narrow(dim, mesh_lib.axis_rank(mesh, a) * k, k)
    x = x.contiguous()
    for a in _spread(mesh, named):
        _count_bytes("all_reduce", x)
        comm.all_reduce_(x, "sum", mesh_lib.axis_group(mesh, a))
        copies *= 1 if a in batch_axes else int(mesh.shape[a])
    n = n_batch * copies
    return x.div_(n) if n > 1 else x


def _quantizes(g, n_batch: int) -> bool:
    """Whether the SPMD arm sends this gradient over the batch axes as
    int8 (FLAGS_quant_collectives=int8, the reference's
    `_quant_grad_split`): batch axes above 1, a float payload of at least
    `min_bytes()`."""
    from . import quant_collectives as qc

    return (n_batch > 1 and qc.mode() == "int8" and g.is_floating_point()
            and g.numel() * g.element_size() >= qc.min_bytes())


def quantized_to_shard(g, spec, mesh, batch_axes, n_batch: int):
    """`reduce_to_shard` through the int8 wire: the batch axes' mean of g
    by `quant_allreduce_sum / n_batch` over their joint group (every
    rank of the group gets the same bits), this rank's block of each
    split dim, and the average over the other axes above 1 that the spec
    does not name (full width, as `reduce_to_shard`)."""
    from ..distributed import comm
    from ..profiler import stat_add
    from . import quant_collectives as qc

    stat_add("collective_bytes_spmd_all_reduce",
             qc.wire_bytes(g, axis_size=n_batch))
    x = qc.quant_allreduce_sum(g, mesh_lib.axes_group(mesh, batch_axes))
    x = x / torch.tensor(float(n_batch), dtype=x.dtype, device=x.device)
    named = set()
    for dim, entry in enumerate(tuple(spec)):
        axes = spec_rules.entry_names(entry)
        named.update(axes)
        idx, n = mesh_lib.block_index(mesh, axes)
        if n > 1:
            k = x.shape[dim] // n
            x = x.narrow(dim, idx * k, k)
    x = x.contiguous()
    copies = [a for a in _spread(mesh, named) if a not in batch_axes]
    for a in copies:
        _count_bytes("all_reduce", x)
        comm.all_reduce_(x, "sum", mesh_lib.axis_group(mesh, a))
    if copies:
        x.div_(math.prod(int(mesh.shape[a]) for a in copies))
    return x


def _mean_replicated(grads, mesh):
    """Each replicated gradient's mean over the batch axes, averaged over
    the mesh's other axes too (as `reduce_to_shard`): one flat f32
    all-reduce an axis."""
    from ..distributed import comm

    axes = _spread(mesh, ())
    if not grads or not axes:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    for a in axes:
        _count_bytes("all_reduce", flat)
        comm.all_reduce_(flat, "sum", mesh_lib.axis_group(mesh, a))
    flat.div_(math.prod(int(mesh.shape[a]) for a in axes))
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g).to(g.dtype))
        off += g.numel()
    return out


class _SpmdStep:
    """One program's plan on the SPMD arm: the split of the block into
    the forward-and-backward ops (A: up to the last write of a parameter
    gradient the optimize ops read) and the update ops (B), the state's
    specs, and the layout each update op runs in."""

    def __init__(self, program, mesh, feed_names, fetch_names):
        from ..fluid import executor as X
        from ..fluid.framework import GRAD_SUFFIX, OpRole
        from ..ops import registry
        from . import spec_layout

        block = program.global_block()
        self.block, self.mesh = block, mesh
        self.fetch_names = list(fetch_names)
        ops = list(block.ops)
        upd = [op for op in ops if op.attr("op_role", 0) & OpRole.Optimize
               and op.input("Param")]
        grads = {op.input("Param")[0] + GRAD_SUFFIX for op in upd}
        split = max((i for i, op in enumerate(ops)
                     if set(op.output_arg_names()) & grads), default=-1)
        self.ops_a, self.ops_b = ops[:split + 1], ops[split + 1:]
        if any(op.attr("op_role", 0) & OpRole.Optimize for op in self.ops_a):
            raise NotImplementedError(
                "SPMD arm: an optimize op runs before the last parameter "
                "gradient is written")
        reads, writes = X._analyze_block(block, feed_names)
        self.state = [n for n in reads]
        self.writes = set(writes)

        def var(name):
            try:
                return block._var_recursive(name)
            except ValueError:
                return None

        # the state's layout in the scope
        self.spec = {}
        for n in set(self.state) | self.writes:
            v = var(n)
            if v is None or not v.shape or any(d < 0 for d in v.shape):
                continue
            sp = spec_layout.spec_for(n, v.shape, mesh, var=v)
            if tuple(sp):
                self.spec[n] = sp
        self.full_shape = {n: tuple(var(n).shape) for n in self.spec}
        a_reads, a_writes = set(), set()
        for op in self.ops_a:
            r, w = registry.op_reads_writes(op)
            a_reads.update(r)
            a_writes.update(w)
        bad = sorted(n for n in a_writes if n in self.spec)
        if bad:
            raise NotImplementedError(
                f"SPMD arm: the forward and backward write sharded vars "
                f"{bad}")
        self.gather = sorted(n for n in a_reads if n in self.spec)
        # each update op's group: its parameter, the parameter's gradient,
        # its Grad input and its accumulators of the parameter's shape,
        # held in B by the parameter's spec, else its accumulators'
        held = {}
        self.param_grads = {}  # p@GRAD -> the spec B holds it in
        for op in upd:
            p = op.input("Param")[0]
            shape = tuple(var(p).shape)
            members = [p] + [n for slot, names in op.inputs.items()
                             if slot not in ("Param", "LearningRate")
                             for n in names
                             if var(n) is not None
                             and tuple(var(n).shape) == shape]
            specs = {tuple(self.spec[n]) for n in members if n in self.spec}
            if len(specs) > 1:
                raise NotImplementedError(
                    f"SPMD arm: {op.type} of {p} mixes layouts {specs}")
            sp = spec_layout.P(*specs.pop()) if specs else spec_layout.P()
            for n in members + [p + GRAD_SUFFIX]:
                held[n] = sp
            self.param_grads[p + GRAD_SUFFIX] = sp
        for n, sp in self.spec.items():
            held.setdefault(n, sp)
        # B's ops: an op reading a sharded value must be elementwise, and
        # its outputs are held in that layout
        for op in self.ops_b:
            r, w = registry.op_reads_writes(op)
            specs = {tuple(held[n]) for n in r if n in held and tuple(held[n])}
            if not specs:
                continue
            if op.type not in ELEMENTWISE_UPDATES or len(specs) > 1:
                raise NotImplementedError(
                    f"SPMD arm: {op.type} reads sharded values "
                    f"{[n for n in r if n in held and tuple(held[n])]}; the "
                    "update ops on shards must be elementwise "
                    f"({sorted(ELEMENTWISE_UPDATES)})")
            sp = spec_layout.P(*specs.pop())
            shape = next(tuple(var(n).shape) for n in r
                         if n in held and tuple(held[n]))
            for n in w:
                # an output of the sharded operands' shape is held like
                # them (an update's Beta1PowOut is not)
                if n not in held and var(n) is not None \
                        and tuple(var(n).shape) == shape:
                    held[n] = sp
        self.held = held
        b_reads = set()
        for op in self.ops_b:
            b_reads.update(registry.op_reads_writes(op)[0])
        self.b_reads = b_reads
        keep = set(self.fetch_names) | self.writes | (b_reads & a_writes)
        self.frees_a = X._last_uses(X._LiveBlock(block, self.ops_a), keep)
        self.frees_b = X._last_uses(X._LiveBlock(block, self.ops_b),
                                    set(self.fetch_names) | self.writes)

    def shard_scope(self, scope) -> None:
        """Replace each sharded var the scope holds whole by this rank's
        shard (the startup's full values, or values a user set)."""
        for n, sp in self.spec.items():
            if not scope.has(n) or scope.get(n) is None:
                continue
            v = scope.get(n)
            if isinstance(v, torch.Tensor) and \
                    tuple(v.shape) == self.full_shape[n]:
                scope.set(n, shard_of(v, sp, self.mesh))

    def batch_axes(self, feeds):
        rows = {a.shape[0] for a in feeds.values() if a.ndim >= 1}
        if len(rows) > 1:
            raise ValueError(f"SPMD arm: feeds of {sorted(rows)} rows; the "
                             "batch is cut over data x fsdp by one count")
        axes = mesh_lib.batch_axes(self.mesh, rows.pop() if rows else None)
        return tuple(a for a in axes if int(self.mesh.shape[a]) > 1)

    def __call__(self, state, feeds, seed, device, batch_axes):
        from ..fluid.executor import run_ops

        mesh = self.mesh
        n_batch = 1
        for a in batch_axes:
            n_batch *= int(mesh.shape[a])
        env = dict(state)
        for n in self.gather:
            env[n] = gather_full(state[n], self.spec[n], mesh)
        env.update(feeds)
        run_ops(self.block, self.ops_a, env, seed, device, self.frees_a)
        # the second environment: the update ops on shards
        env_b = {}
        for n in self.b_reads:
            if n in self.param_grads:
                continue
            if n in feeds:
                env_b[n] = feeds[n]
            elif n in state:
                want = self.held.get(n)
                env_b[n] = state[n] if not want or self.spec.get(n) == want \
                    else shard_of(state[n], want, mesh)  # ZeRO-1's slice
            elif n in env:
                env_b[n] = env[n]
        # FLAGS_quant_collectives=int8: a parameter gradient the wire
        # takes crosses the batch axes as int8 blocks, then the update
        # runs on the shards as below
        quant = [n for n in self.param_grads
                 if n in env and _quantizes(env[n], n_batch)]
        for n in quant:
            env_b[n] = quantized_to_shard(env[n], self.param_grads[n], mesh,
                                          batch_axes, n_batch)
        sharded = [n for n, sp in self.param_grads.items()
                   if tuple(sp) and n in env and n not in env_b]
        for n in sharded:
            env_b[n] = reduce_to_shard(env[n], self.param_grads[n], mesh,
                                       batch_axes, n_batch)
        repl = [n for n, sp in self.param_grads.items()
                if not tuple(sp) and n in env and n not in env_b]
        env_b.update(zip(repl, _mean_replicated([env[n] for n in repl],
                                                mesh)))
        run_ops(self.block, self.ops_b, env_b, seed, device, self.frees_b)
        new_state = {}
        for n in sorted(self.writes):  # one collective order on every rank
            if n in env_b:
                v = env_b[n]
                held = self.held.get(n)
                if held is not None and tuple(held) \
                        and self.spec.get(n) != held:
                    v = gather_full(v, held, mesh)  # ZeRO-1's parameter
                new_state[n] = v
            elif n in env:
                new_state[n] = env[n]
        fetches = [env_b[n] if n in env_b else env[n]
                   for n in self.fetch_names]
        return fetches, new_state


def sharded_vars(compiled, scope) -> Dict[str, object]:
    """{name: PartitionSpec} of the vars `scope` holds as this rank's
    shards on the SPMD arm (the checkpoint manager gathers them whole)."""
    out = {}
    for plan in compiled._spmd_plans.values():
        for n, sp in plan.spec.items():
            v = scope.get(n) if scope.has(n) else None
            if isinstance(v, torch.Tensor) \
                    and tuple(v.shape) != plan.full_shape[n]:
                out[n] = sp
    return out


def _run_spmd(compiled, executor, feed, fetch_list, scope, return_numpy):
    """One step of `compiled._program` on the SPMD arm (`_SpmdStep`),
    through the Executor's dispatch: its state gathered from the scope,
    its new state committed there, the fetches numpy or lazy."""
    from ..fluid import executor as X
    from ..fluid.framework import Variable
    from ..profiler import stat_add

    prog, mesh = compiled._program, compiled._mesh
    scope = scope if scope is not None else X.global_scope()
    executor._nan_monitor.poll()
    stat_add("executor_run_count")
    feeds = executor._normalize_feed(prog, feed or {})
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in (fetch_list or [])]
    key = (prog.version, tuple(sorted(feeds)), tuple(fetch_names), id(scope))
    plan = compiled._spmd_plans.get(key)
    if plan is None:
        plan = _SpmdStep(prog, mesh, feeds.keys(), fetch_names)
        missing = [n for n in plan.state
                   if not scope.has(n) or scope.get(n) is None]
        if missing:
            raise RuntimeError(f"variables {missing} are read by the program "
                               "but neither fed nor initialized in the scope "
                               "(did you run the startup program?)")
        plan.shard_scope(scope)
        stat_add("spmd_specs_applied", len(plan.spec))
        compiled._spmd_plans[key] = plan
    axes = plan.batch_axes(feeds)
    idx, _ = mesh_lib.block_index(mesh, axes)
    local = {}
    for n, a in feeds.items():
        if a.ndim >= 1 and axes:
            _, nb = mesh_lib.block_index(mesh, axes)
            k = a.shape[0] // nb
            a = a[idx * k:(idx + 1) * k]
        local[n] = a
    entry = X._Entry()
    entry.program, entry.scope = prog, scope
    entry.fetch_names = fetch_names
    entry.mutable_in_names = sorted(n for n in plan.state
                                    if n in plan.writes)
    entry.const_in_names = sorted(n for n in plan.state
                                  if n not in plan.writes)
    entry.const_src, entry.const_dev = {}, {}

    def fn(mutable_state, const_state, feeds_, seed):
        state = dict(const_state)
        state.update(mutable_state)
        return plan(state, feeds_, seed, executor.device, axes)

    entry.fn = fn
    # the rank's batch index folds into the step seed: the tp ranks of
    # one batch index draw the same masks, batch index 0 the one-process
    # ones
    executor._seed_rank = idx
    try:
        fetches = executor._dispatch(entry, scope, local)
    finally:
        executor._seed_rank = 0
    return executor._finish(fetches, entry, return_numpy)
