"""The collective bucket (counterpart of paddle_tpu/ops/collective_ops.py):
23 rules.

The reference lowers each rule to a `lax` collective over the mesh axis
its `ring_id` names, inside the `shard_map` its compiler wraps around a
block; outside a mesh every rule is the identity.  The port runs one
process a rank: a rank's Executor runs the block on that rank's batch,
and each rule calls `torch.distributed` on the group its ring names
(distributed/comm.py: ring 0 is the data axis; a ring the mesh does not
name raises).  With no group (or at shape inference) every rule is the
identity, as the reference's is outside a mesh.  A group of one runs the
collective all the same, whose result has the input's bits, so a
world-one NCCL group sends every rule through NCCL.

The definitions are the reference's: `c_allreduce_prod` is
exp(sum(log x)), `c_broadcast` the root's value (its masked sum),
`c_reduce_sum` an all-reduce (every rank keeps the sum), `c_concat` /
`c_split` the last axis, `alltoall` dim 0's blocks, and `send_v2` /
`recv_v2` pair FIFO per ring (an unpaired `recv_v2` raises).  Where the
port's append_backward differentiates through a rule, its backward is
the adjoint collective (comm.py), as `jax.vjp` of `psum` is `psum`.

Each rule that moves data counts its payload under
`collective_bytes_<op type>` (and `collective_count_<op type>`) at each
run, the reference's `_record_wire` (its counts are taken once a trace).
With `FLAGS_quant_collectives=int8` (parallel/quant_collectives.py) a
float payload of at least `min_bytes()` crosses `c_allreduce_sum`,
`mp_allreduce_sum`, `c_reducescatter` and `c_allgather` as int8 codes and
fp32 scales, and the count is their `wire_bytes`, as the reference's.
The quantized forms' backward is the full-width adjoint collective.

`use_calc_stream=False` issues the collective on the port's comm stream
(comm.comm_stream); the fences c_sync_calc_stream / c_wait_calc_stream
make the comm stream wait for the compute stream, c_sync_comm_stream /
c_wait_comm_stream the other way round.  Off CUDA they are no-ops, as
gloo's collectives return when done.
"""

from __future__ import annotations

import torch

from ..distributed import comm, parallel
from .registry import first, register_op


def _group(ctx, op):
    """(group, size) for this op's ring, or None to keep the identity
    (no group, or shape inference)."""
    if ctx.abstract or not parallel.is_initialized():
        return None
    group = comm.group_for_ring(op.attr("ring_id", 0))
    return group, comm.world(group)


def _record_wire(op, x, wire_bytes=None):
    """Count this rule's payload: the logical bytes, or `wire_bytes` of a
    quantized transfer."""
    from .. import profiler

    n = x.numel() * x.element_size() if wire_bytes is None else wire_bytes
    profiler.stat_add(f"collective_bytes_{op.type}", int(n))
    profiler.stat_add(f"collective_count_{op.type}")


def _quant_cfg(x):
    """The quant_collectives module when this payload goes int8 (the mode
    int8, a float dtype, at least min_bytes), else None."""
    from ..parallel import quant_collectives as qc

    if qc.mode() != "int8" or not x.is_floating_point():
        return None
    if x.numel() * x.element_size() < qc.min_bytes():
        return None
    return qc


def _full_sum(x, group):
    return comm.all_reduce(x, "sum", group)


class _Quantized(torch.autograd.Function):
    """A quantized collective forward, the full-width adjoint backward
    (all-reduce <-> all-reduce, reduce-scatter <-> all-gather)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, group):
        ctx.bwd, ctx.group = bwd, group
        return fwd(x, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g, ctx.group), None, None, None


def _issue(op, fn, x, *args):
    if not op.attr("use_calc_stream", True) and x.is_cuda:
        return comm.on_comm_stream(fn, x, *args)
    return fn(x, *args)


def _sum_allreduce(ctx, op, ins):
    """The sum all-reduce, int8 through quant_allreduce_sum where
    `_quant_cfg` takes the payload (the reference's two phases)."""
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    qc = _quant_cfg(x)
    if qc is not None:
        _record_wire(op, x, qc.wire_bytes(x, axis_size=g[1]))
        return {"Out": [_issue(op, _Quantized.apply, x,
                               qc.quant_allreduce_sum, _full_sum, g[0])]}
    _record_wire(op, x)
    return {"Out": [_issue(op, comm.all_reduce_sum, x, g[0])]}


def _allreduce(mode):
    def rule(ctx, op, ins):
        x = first(ins, "X")
        g = _group(ctx, op)
        if g is None:
            return {"Out": [x]}
        _record_wire(op, x)
        return {"Out": [_issue(op, comm.all_reduce, x, mode, g[0])]}

    return rule


register_op("c_allreduce_sum")(_sum_allreduce)
register_op("mp_allreduce_sum")(_sum_allreduce)
register_op("c_allreduce_max")(_allreduce("max"))
register_op("c_allreduce_min")(_allreduce("min"))


@register_op("c_allreduce_prod")
def _c_allreduce_prod(ctx, op, ins):
    """exp(sum(log x)) over the ranks (the reference's definition); a
    group of one all-reduces x itself, whose bits it keeps."""
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    group, n = g
    _record_wire(op, x)
    if n == 1:
        return {"Out": [_issue(op, comm.all_reduce_sum, x, group)]}
    return {"Out": [torch.exp(_issue(op, comm.all_reduce_sum, torch.log(x),
                                     group))]}


@register_op("c_reduce_sum")
def _c_reduce_sum(ctx, op, ins):
    # the reference's psum: every rank keeps the sum, the root's
    # consumers included (full width, as the reference's)
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    _record_wire(op, x)
    return {"Out": [_issue(op, comm.all_reduce_sum, x, g[0])]}


@register_op("c_broadcast")
def _c_broadcast(ctx, op, ins):
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    _record_wire(op, x)
    return {"Out": [_issue(op, comm.broadcast_diff, x, op.attr("root", 0),
                           g[0])]}


@register_op("c_allgather")
def _c_allgather(ctx, op, ins):
    """The ranks' X along dim 0, in rank order (int8 where `_quant_cfg`
    takes the payload)."""
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    qc = _quant_cfg(x)
    if qc is not None and x.dim():
        _record_wire(op, x, qc.wire_bytes(x))
        return {"Out": [_issue(op, _Quantized.apply, x, qc.quant_allgather,
                               comm.reduce_scatter, g[0])]}
    _record_wire(op, x)
    return {"Out": [_issue(op, comm.all_gather_diff, x, g[0])]}


@register_op("c_reducescatter")
def _c_reducescatter(ctx, op, ins):
    """This rank's dim-0 block of the ranks' sum (int8 where `_quant_cfg`
    takes the payload and its rows split over the group)."""
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    qc = _quant_cfg(x)
    if qc is not None and x.dim() and x.shape[0] % g[1] == 0:
        _record_wire(op, x, qc.wire_bytes(x, axis_size=g[1]))
        return {"Out": [_issue(op, _Quantized.apply, x,
                               qc.quant_reducescatter, comm.all_gather,
                               g[0])]}
    _record_wire(op, x)
    return {"Out": [_issue(op, comm.reduce_scatter_diff, x, g[0])]}


def _gather_last(x, group):
    g = comm.all_gather_diff(x.movedim(-1, 0).contiguous(), group)
    return g.movedim(0, -1)


@register_op("c_concat")
def _c_concat(ctx, op, ins):
    """The ranks' X side by side along the last axis."""
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    _record_wire(op, x)
    return {"Out": [_issue(op, _gather_last, x, g[0])]}


@register_op("c_split")
def _c_split(ctx, op, ins):
    """This rank's block of X's last axis (no communication)."""
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    group, n = g
    piece = x.shape[-1] // n
    r = comm.rank(group)
    return {"Out": [x[..., r * piece:(r + 1) * piece]]}


@register_op("c_identity")
def _c_identity(ctx, op, ins):
    return {"Out": [first(ins, "X")]}


@register_op("alltoall")
def _alltoall(ctx, op, ins):
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is None:
        return {"Out": [x]}
    _record_wire(op, x)
    return {"Out": [_issue(op, comm.all_to_all_diff, x, g[0])]}


@register_op("barrier")
def _barrier(ctx, op, ins):
    x = first(ins, "X")
    g = _group(ctx, op)
    if g is not None:
        comm.barrier(g[0])
    return {"Out": [x]}


def _fence(calc_waits: bool):
    def rule(ctx, op, ins):
        xs = list(ins.get("X", []))
        if not ctx.abstract and ctx.device.type == "cuda" \
                and parallel.is_initialized():
            (comm.calc_waits_comm if calc_waits
             else comm.comm_waits_calc)(ctx.device)
        return {"Out": xs} if xs else {}

    return rule


register_op("c_sync_calc_stream")(_fence(False))
register_op("c_sync_comm_stream")(_fence(True))
register_op("c_wait_calc_stream")(_fence(False))
register_op("c_wait_comm_stream")(_fence(True))


@register_op("c_comm_init")
@register_op("c_comm_init_all")
@register_op("c_gen_nccl_id")
def _comm_bootstrap(ctx, op, ins):
    """The communicator comes up with the process group
    (init_parallel_env); a ring these name must be one the mesh names."""
    if not ctx.abstract and parallel.is_initialized():
        comm.group_for_ring(op.attr("ring_id", 0))
    return {}


def _p2p_queue(ctx):
    q = getattr(ctx, "p2p_queue", None)
    if q is None:
        q = ctx.p2p_queue = {}
    return q


@register_op("send_v2")
def _send_v2(ctx, op, ins):
    """Queue (value, destination) on this run's context, FIFO per ring:
    the paired recv_v2 moves it, as the reference's ppermute does."""
    x = first(ins, "X", None)
    if x is not None:
        _p2p_queue(ctx).setdefault(int(op.attr("ring_id", 0)), []).append(
            (x, int(op.attr("peer", 0))))
    return {}


def _edge(x, src, dst, group):
    """Rank src's x on rank dst; zeros on the other ranks (ppermute's
    zero fill)."""
    r = comm.rank(group)
    if src == dst:
        return x if r == src else torch.zeros_like(x)
    if r == src:
        comm.send(x, dst, group)
    if r == dst:
        return comm.recv(x, src, group)
    return torch.zeros_like(x)


@register_op("recv_v2")
def _recv_v2(ctx, op, ins):
    x = first(ins, "X", None)
    src = int(op.attr("peer", 0))
    if x is not None:
        # with its own X: every rank receives rank src's X
        g = _group(ctx, op)
        if g is None:
            return {"Out": [x]}
        return {"Out": [comm.broadcast(x, src, g[0])]}
    ring = int(op.attr("ring_id", 0))
    queue = _p2p_queue(ctx).get(ring, [])
    if queue:
        sent, dst = queue.pop(0)
        want_shape = tuple(op.attr("out_shape", []) or ())
        if want_shape and tuple(sent.shape) != want_shape:
            raise ValueError(
                f"recv_v2 on ring {ring} paired (FIFO) with a send of "
                f"shape {tuple(sent.shape)} but declares out_shape "
                f"{want_shape} — sends and recvs are mis-ordered in the "
                "program")
        g = _group(ctx, op)
        if g is None:
            return {"Out": [sent]}
        return {"Out": [_edge(sent, src, dst, g[0])]}
    raise ValueError(
        "recv_v2 has no data source: no X input and no earlier matching "
        f"send_v2 on ring {ring} in this program. A recv that silently "
        "returned zeros would corrupt training; pair it with a send_v2 or "
        "pass the value as X.")
