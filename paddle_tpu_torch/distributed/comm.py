"""The collectives the port's rules, layers and steps call, over
`torch.distributed` (the counterpart of the `lax` collectives in
paddle_tpu/ops/collective_ops.py).

A ring id names a group: ring 0 is the data axis (the current mesh's
data group, else the whole world); another ring raises until the
pipeline names it (ROADMAP queue 1 item 10b (iv)).  With no group, or a group of one, `live()`
is False for the callers that keep the identity; the functions here
still run the collective on a group of one (its result is the input's
bits), so a world-one NCCL group sends every rule through NCCL.

Every function is out of place, and the differentiable ones carry the
adjoint collective as their backward, as `jax.vjp` of `psum` is `psum`:
all-reduce <-> all-reduce, all-gather <-> reduce-scatter, all-to-all <->
all-to-all (the tiled form with its dims swapped), the ring's step
forward <-> its step back, broadcast <-> the root's share of an
all-reduce.

Gloo on CUDA tensors (asked for by PADDLE_DISTRI_BACKEND=gloo) runs on
CPU copies, as gloo stages CUDA tensors through the host itself; NCCL
runs on the card.  `comm_stream()` is the side stream the rules with
`use_calc_stream=False` issue on; the c_sync_* / c_wait_* fences make
one stream wait on the other.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import parallel

_COMM_STREAMS: Dict[int, object] = {}
# tag -> the times this rank has called store_barrier(tag) on this group
_STORE_BARRIERS: Dict[str, int] = {}


def _dist():
    return torch.distributed


def live() -> bool:
    """A group of more than one rank is running."""
    return parallel.is_initialized() and _dist().get_world_size() > 1


def reset() -> None:
    _COMM_STREAMS.clear()
    _STORE_BARRIERS.clear()
    from ..parallel import mesh

    mesh.set_current_mesh(None)


def group_for_ring(ring_id: int = 0):
    """The process group ring `ring_id` names (None: the whole world):
    ring 0 is the current mesh's data axis, as the reference maps its
    rings onto mesh axes; raises for a ring the mesh does not name."""
    if int(ring_id) != 0:
        raise ValueError(
            f"ring_id {ring_id}: the mesh names only ring 0 (the data "
            "axis); the model and pipeline rings come with ROADMAP queue 1 "
            "item 10b (iv)")
    from ..parallel import mesh

    m = mesh.current_mesh()
    if m is None:
        return None
    if m.data_axis not in m.axis_names and m.device_mesh is not None:
        raise ValueError(f"ring 0 is the data axis, and mesh {m} has none")
    return m.group


def world(group=None) -> int:
    return _dist().get_world_size(group) if parallel.is_initialized() else 1


def rank(group=None) -> int:
    return _dist().get_rank(group) if parallel.is_initialized() else 0


def global_rank(group, group_rank: int) -> int:
    if group is None:
        return group_rank
    return _dist().get_global_rank(group, group_rank)


def _staged(x: torch.Tensor):
    """(tensor to communicate, back-to-x's-device fn): gloo runs on CPU
    copies of CUDA tensors."""
    if x.is_cuda and parallel.backend() == "gloo":
        return x.detach().cpu(), (lambda t: t.to(x.device))
    return x, (lambda t: t)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _reduce_op(op: str):
    return getattr(_dist().ReduceOp, _OPS[op])


# -- plain (non-differentiable) collectives ----------------------------------

def all_reduce_(x: torch.Tensor, op: str = "sum", group=None):
    """In place on x (which must be contiguous), as torch's."""
    t, back = _staged(x)
    _dist().all_reduce(t, op=_reduce_op(op), group=group)
    if t is not x:
        x.copy_(back(t))
    return x


def all_reduce(x: torch.Tensor, op: str = "sum", group=None):
    return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format),
                       op, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' x concatenated along dim 0, in rank order."""
    t, back = _staged(x.detach().contiguous())
    n = world(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:])) \
        if t.dim() else t.new_empty((n,))
    _dist().all_gather_into_tensor(out, t.reshape(-1) if not t.dim() else t,
                                   group=group)
    return back(out)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's dim-0 block of the ranks' sum (dim 0 must split
    evenly)."""
    n = world(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    t, back = _staged(x.detach().contiguous())
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _dist().reduce_scatter_tensor(out, t, group=group)
    return back(out)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Block k of dim 0 goes to rank k; the blocks received stack in
    rank order."""
    n = world(group)
    if x.shape[0] % n:
        raise ValueError(f"alltoall: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    t, back = _staged(x.detach().contiguous())
    out = torch.empty_like(t)
    _dist().all_to_all_single(out, t, group=group)
    return back(out)


def broadcast(x: torch.Tensor, root: int = 0, group=None) -> torch.Tensor:
    """The group rank `root`'s x on every rank."""
    t, back = _staged(x.detach().clone(
        memory_format=torch.contiguous_format))
    _dist().broadcast(t, src=global_rank(group, root), group=group)
    return back(t)


def send(x: torch.Tensor, dst: int, group=None) -> None:
    t, _ = _staged(x.detach().contiguous())
    _dist().send(t, dst=global_rank(group, dst), group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    t, back = _staged(torch.empty_like(like,
                                       memory_format=torch.contiguous_format))
    _dist().recv(t, src=global_rank(group, src), group=group)
    return back(t)


def _ring_step(x: torch.Tensor, group, to: int) -> torch.Tensor:
    """x sent to group rank + `to` and the value of group rank - `to`
    received (mod n), in one `batch_isend_irecv`; a group of one returns
    x."""
    n = world(group)
    if n == 1:
        return x
    r = rank(group)
    t, back = _staged(x.detach().contiguous())
    out = torch.empty_like(t)
    d = _dist()
    reqs = d.batch_isend_irecv([
        d.P2POp(d.isend, t, global_rank(group, (r + to) % n), group),
        d.P2POp(d.irecv, out, global_rank(group, (r - to) % n), group)])
    for q in reqs:
        q.wait()
    return back(out)


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One step of the ring: x to group rank + 1, rank - 1's received
    (the counterpart of `lax.ppermute` with perm [(i, i + 1 mod n)])."""
    return _ring_step(x, group, 1)


def ring_shift_back(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ring's adjoint step: x to group rank - 1, rank + 1's
    received."""
    return _ring_step(x, group, -1)


def all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group=None) -> torch.Tensor:
    """`lax.all_to_all(x, split_axis, concat_axis, tiled=True)`: x cut
    into n blocks along `split_dim`, block k sent to rank k, the blocks
    received concatenated along `concat_dim` in rank order."""
    n = world(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    k = x.shape[split_dim] // n
    # (n, ...) with block k leading: one all_to_all_single of dim 0
    blocks = x.unflatten(split_dim, (n, k)).movedim(split_dim, 0)
    got = all_to_all(blocks.contiguous(), group)  # (n, ...) by sender
    # dims of `got`: 0 the sender, then x's dims with split_dim of size
    # k; the sender goes just before concat_dim, as its major part
    return got.movedim(0, concat_dim).flatten(
        concat_dim, concat_dim + 1).contiguous()


STORE_BARRIER_TIMEOUT_S = 1800.0


def store_barrier(tag: str, count: int) -> None:
    """A rendezvous of `count` ranks through the group's store, not a
    collective: it may be called from another thread than the one that
    issues the group's collectives (the checkpoint writer's), whose
    collectives it then cannot put out of step.  Every rank calls it the
    same number of times with a tag."""
    import time

    from torch.distributed import distributed_c10d as c10d

    store = c10d._get_default_store()
    uses = _STORE_BARRIERS[tag] = _STORE_BARRIERS.get(tag, 0) + 1
    key = f"paddle_tpu_torch/barrier/{tag}"
    store.add(key, 1)
    deadline = time.monotonic() + STORE_BARRIER_TIMEOUT_S
    while store.add(key, 0) < count * uses:
        if time.monotonic() > deadline:
            raise TimeoutError(f"store barrier {tag!r}: {count} ranks did "
                               f"not arrive in {STORE_BARRIER_TIMEOUT_S} s")
        time.sleep(0.002)


def barrier(group=None) -> None:
    if parallel.backend() == "nccl":
        dev = parallel.device()
        _dist().barrier(group=group, device_ids=[dev.index]
                        if dev is not None and dev.index is not None
                        else None)
    else:
        _dist().barrier(group=group)


# -- differentiable collectives ----------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _Broadcast(torch.autograd.Function):
    """out = the root's x: the reference's masked sum, whose adjoint is
    the all-reduced cotangent on the root and zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, root, group):
        ctx.group, ctx.root = group, root
        return broadcast(x, root, group)

    @staticmethod
    def backward(ctx, g):
        s = all_reduce(g, "sum", ctx.group)
        if rank(ctx.group) != ctx.root:
            s = torch.zeros_like(s)
        return s, None, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's "f": the identity forward, the group's all-reduce
    backward (a replicated input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's "g": the group's all-reduce forward, the identity
    backward (the partial sums of a row-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """The group's slices of the last dim concatenated in rank order;
    the backward takes this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.rank = rank(group)
        g = all_gather(x.movedim(-1, 0).contiguous(), group)
        return g.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        w, r = ctx.width, ctx.rank
        return g[..., r * w:(r + 1) * w].contiguous(), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group)

    @staticmethod
    def backward(ctx, g):
        return ring_shift_back(g, ctx.group), None


class _AllToAllTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.args = (split_dim, concat_dim, group)
        return all_to_all_tiled(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group = ctx.args
        return (all_to_all_tiled(g, concat_dim, split_dim, group), None,
                None, None)


def ring_shift_diff(x, group=None):
    """`ring_shift` whose backward is the step back (ppermute's adjoint)."""
    return _RingShift.apply(x, group)


def all_to_all_tiled_diff(x, split_dim: int, concat_dim: int, group=None):
    """`all_to_all_tiled` whose backward is the all-to-all with the dims
    swapped."""
    return _AllToAllTiled.apply(x, int(split_dim), int(concat_dim), group)


def copy_to_group(x, group=None):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group=None):
    return _ReduceFromGroup.apply(x, group)


def gather_last_dim(x, group=None):
    return _GatherLast.apply(x, group)


def all_reduce_sum(x, group=None):
    return _AllReduceSum.apply(x, group)


def all_gather_diff(x, group=None):
    return _AllGather.apply(x, group)


def reduce_scatter_diff(x, group=None):
    return _ReduceScatter.apply(x, group)


def all_to_all_diff(x, group=None):
    return _AllToAll.apply(x, group)


def broadcast_diff(x, root=0, group=None):
    return _Broadcast.apply(x, int(root), group)


# -- the comm stream and the fences ------------------------------------------

def comm_stream(device: torch.device):
    """The port's side stream on `device` for collectives issued with
    use_calc_stream=False (None off CUDA)."""
    if device.type != "cuda":
        return None
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _COMM_STREAMS.get(idx)
    if s is None:
        s = _COMM_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


def calc_waits_comm(device: torch.device) -> None:
    """c_sync_comm_stream / c_wait_comm_stream: the compute stream waits
    for what the comm stream has queued."""
    s = comm_stream(device)
    if s is not None:
        torch.cuda.current_stream(device).wait_stream(s)


def comm_waits_calc(device: torch.device) -> None:
    """c_sync_calc_stream / c_wait_calc_stream: the comm stream waits for
    what the compute stream has queued."""
    s = comm_stream(device)
    if s is not None:
        s.wait_stream(torch.cuda.current_stream(device))


def on_comm_stream(fn, x: torch.Tensor, *args):
    """fn(x, *args) issued on the comm stream after it waits for x's
    producer; the result is kept alive for the compute stream, which
    must wait (c_sync_comm_stream) before it reads it."""
    s = comm_stream(x.device)
    if s is None:
        return fn(x, *args)
    s.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(s):
        out = fn(x, *args)
    x.record_stream(s)
    out.record_stream(torch.cuda.current_stream(x.device))
    return out


# -- host values (fleet.util, metrics) --------------------------------------

def host_all_reduce(a, mode: str = "sum", group=None):
    """A numpy array reduced over the group, on the group's device."""
    import numpy as np

    a = np.asarray(a)
    dev = parallel.device() or torch.device("cpu")
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)
                         if a.dtype.kind == "f" else
                         np.ascontiguousarray(a)).to(dev)
    all_reduce_(t, mode, group)
    return t.cpu().numpy().astype(a.dtype, copy=False)


def host_all_gather(a, group=None):
    import numpy as np

    a = np.ascontiguousarray(np.asarray(a))
    dev = parallel.device() or torch.device("cpu")
    t = torch.from_numpy(a).to(dev)
    g = all_gather(t.reshape((1,) + tuple(t.shape)), group)
    return [x for x in g.cpu().numpy()]


def default_group() -> Optional[object]:
    """Ring 0's group (None: the world)."""
    return group_for_ring(0)
