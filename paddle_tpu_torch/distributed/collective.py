"""The 2.x collective API (counterpart of paddle_tpu/distributed/
collective.py).

On a static Variable each function appends the collective op to the
current program through LayerHelper, as the reference does (the op runs
over the group when the rank's Executor runs the program).  On an eager
tensor it calls `torch.distributed` on the tensor now, in place where
Paddle 2.x works in place (`all_reduce`, `broadcast`, `scatter`), over
the group its ring names (`group` is a ring id: 0 is the data axis).
With no process group the eager forms are the identity.
"""

from __future__ import annotations

import torch

from . import comm, parallel


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_RED_OP = {ReduceOp.SUM: "c_allreduce_sum", ReduceOp.MAX: "c_allreduce_max",
           ReduceOp.MIN: "c_allreduce_min", ReduceOp.PROD: "c_allreduce_prod"}
_MODE = {ReduceOp.SUM: "sum", ReduceOp.MAX: "max", ReduceOp.MIN: "min",
         ReduceOp.PROD: "prod"}


def _static(x) -> bool:
    from ..fluid.framework import Variable

    return isinstance(x, Variable)


def _helper(name):
    from ..fluid.layer_helper import LayerHelper

    return LayerHelper(name)


def _eager_group(ring):
    """(group, live) for an eager call on ring `ring`."""
    if not parallel.is_initialized():
        return None, False
    return comm.group_for_ring(ring), True


def all_reduce(tensor, op=ReduceOp.SUM, group=0, use_calc_stream=True):
    if _static(tensor):
        helper = _helper("all_reduce")
        out = helper.create_variable_for_type_inference(dtype=tensor.dtype)
        helper.append_op(_RED_OP[op], inputs={"X": [tensor]},
                         outputs={"Out": [out]},
                         attrs={"ring_id": group,
                                "use_calc_stream": use_calc_stream})
        return out
    g, live = _eager_group(group)
    if not live:
        return tensor
    with torch.no_grad():
        if op == ReduceOp.PROD and comm.world(g) > 1:
            tensor.copy_(torch.exp(comm.all_reduce(torch.log(tensor),
                                                   "sum", g)))
        else:
            comm.all_reduce_(tensor, _MODE[op] if op != ReduceOp.PROD
                             else "sum", g)
    return tensor


def broadcast(tensor, src, group=0, use_calc_stream=True):
    if _static(tensor):
        helper = _helper("broadcast")
        out = helper.create_variable_for_type_inference(dtype=tensor.dtype)
        helper.append_op("c_broadcast", inputs={"X": [tensor]},
                         outputs={"Out": [out]},
                         attrs={"ring_id": group, "root": src,
                                "use_calc_stream": use_calc_stream})
        return out
    g, live = _eager_group(group)
    if live:
        with torch.no_grad():
            tensor.copy_(comm.broadcast(tensor, src, g))
    return tensor


def all_gather(tensor_list_or_tensor, tensor=None, group=0,
               use_calc_stream=True, nranks=None):
    """all_gather(tensor_list, tensor) (2.0: the list receives one tensor
    a rank) or out = all_gather(tensor) (the ranks' tensors along dim
    0)."""
    if tensor is None:
        t, sink = tensor_list_or_tensor, None
    else:
        t, sink = tensor, tensor_list_or_tensor
    if _static(t):
        helper = _helper("all_gather")
        out = helper.create_variable_for_type_inference(dtype=t.dtype)
        helper.append_op("c_allgather", inputs={"X": [t]},
                         outputs={"Out": [out]},
                         attrs={"ring_id": group, "nranks": nranks or 0,
                                "use_calc_stream": use_calc_stream})
        if sink is not None:
            sink.append(out)
        return out
    g, live = _eager_group(group)
    out = comm.all_gather(t, g) if live else t
    if sink is not None:
        n = comm.world(g) if live else 1
        sink.extend(out.chunk(n, 0) if n > 1 else [out])
    return out


def reduce_scatter(tensor, group=0):
    if _static(tensor):
        helper = _helper("reduce_scatter")
        out = helper.create_variable_for_type_inference(dtype=tensor.dtype)
        helper.append_op("c_reducescatter", inputs={"X": [tensor]},
                         outputs={"Out": [out]}, attrs={"ring_id": group})
        return out
    g, live = _eager_group(group)
    return comm.reduce_scatter(tensor, g) if live else tensor


def scatter(tensor, tensor_list=None, src=0, group=0):
    """Static: the c_split op (this rank's block of the last axis), the
    reference's.  Eager (Paddle 2.x): rank src's tensor_list[rank] into
    `tensor` (only src passes the list)."""
    if _static(tensor):
        helper = _helper("scatter_collective")
        out = helper.create_variable_for_type_inference(dtype=tensor.dtype)
        helper.append_op("c_split", inputs={"X": [tensor]},
                         outputs={"Out": [out]},
                         attrs={"ring_id": group, "root": src})
        return out
    g, live = _eager_group(group)
    if not live:
        if tensor_list is not None:
            with torch.no_grad():
                tensor.copy_(tensor_list[0])
        return tensor
    n, r = comm.world(g), comm.rank(g)
    stacked = torch.stack(list(tensor_list)) if r == src else \
        torch.zeros((n,) + tuple(tensor.shape), dtype=tensor.dtype,
                    device=tensor.device)
    with torch.no_grad():
        tensor.copy_(comm.broadcast(stacked, src, g)[r])
    return tensor


def barrier(group=0):
    """Dygraph mode: wait for every rank now.  Static: append the barrier
    op, as the reference does."""
    from ..fluid.framework import in_dygraph_mode

    if in_dygraph_mode():
        if parallel.is_initialized():
            comm.barrier(comm.group_for_ring(group))
        return None
    from ..fluid.layers import tensor as tl

    helper = _helper("barrier")
    x = tl.fill_constant([1], "float32", 0.0)
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op("barrier", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"ring_id": group})
    return out


def get_rank() -> int:
    return parallel.process_index()


def get_world_size() -> int:
    return parallel.process_count()
