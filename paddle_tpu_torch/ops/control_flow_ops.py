"""Control-flow rules (counterpart of paddle_tpu/ops/control_flow_ops.py):
`while`, `conditional_block`, `select_input`, `select_output`, `assert`,
`print`, and the tensor-array rules `allocate_array`, `write_to_array`,
`read_from_array`, `lod_array_length` and `tensor_array_to_tensor`.

The reference lowers a sub-block to a pure function for `lax.while_loop`
(:47-84) and `lax.cond` (:87-134).  The port runs op by op, so it runs
the sub-block as the reference's interpreter design does: `while`
re-enters `registry.lower_block` on the body for as long as the
condition holds, reading the condition on the host once an iteration;
`conditional_block` reads its condition once and runs the body or not.
The body runs on the run's own environment (`ctx.env`), so what it
writes to an outer var is there for the next iteration and after the
loop.  Each host read is counted on `ctx.host_reads`.

Gradients: a `conditional_block` whose graph a grad op reads runs its
body on the op's inputs under autograd, as the reference's `lax.cond`
differentiates (:87-134).  A `while_grad` raises, where the reference's
reverse mode through `lax.while_loop` raises too (ROADMAP queue 1 item
8).

Random ops in a loop body draw fresh bits on each iteration (the step
seed is mixed with the iteration); the reference folds the counter into
its key (:68-69) and the bits differ between the packages.

A tensor array is the reference's value (:242): a stacked buffer (C,
*element) and a length.  A write at an index the program fixes by a
`fill_constant` grows the buffer as needed; any other index needs an
array preallocated by `create_array(capacity=..., element_shape=...)`,
and writes there are clamped to the capacity, as `lax.
dynamic_update_slice` clamps (the reference raises without one, :288,
and so does the port).  `tensor_array_to_tensor` gives the `length`
elements written, the reference's intent (:338-340; one host read):
under its Executor's single jit the length is a tracer and it gives all
C (ROADMAP queue 3).

`recompute_segment_grad` is the backward of a recompute segment
(`fluid.backward.append_backward_with_checkpoints`): it re-runs the
segment's forward rules from its boundary inputs under autograd and takes
`torch.autograd.grad`, as the reference takes `jax.vjp` of
`jax.checkpoint` (:168-222).  The segment's interior values are not among
its inputs, so the Executor frees them after their last forward reader.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import registry
from .registry import first, register_grad, register_op


@register_op("recompute_segment_grad")
def _recompute_segment_grad(ctx, op, ins):
    """Replay the forward ops `seg_op_ids` on the segment's inputs
    (`seg_inputs`; its float ones as fresh leaves) in an environment of
    their own, then the gradients of `seg_outputs` against OutGrads (0
    for an output without one) to the leaves.  The replay's context
    carries the run's seed and device, so a random op redraws the bits
    of its forward run (its generator is seeded from the seed and its op
    id), and no shared generator advances."""
    block = op.block
    by_id = {o.id: o for o in block.ops}
    seg_ops = [by_id[i] for i in op.attr("seg_op_ids")]
    seg_outputs = op.attr("seg_outputs")
    in_vals = ins.get("Inputs", [])
    leaves = [v.detach().requires_grad_()
              if v is not None and registry._is_diff(v) else v
              for v in in_vals]
    env = dict(zip(op.attr("seg_inputs"), leaves))
    inner = registry.LowerCtx(ctx.seed, device=ctx.device)
    inner.record, inner.env = True, env
    with torch.enable_grad():
        for o in seg_ops:
            registry.lower_op(inner, o, env)
    ctx.ops_run += len(seg_ops)
    ctx.host_reads += inner.host_reads
    ys, cts = [], []
    for name, g in zip(seg_outputs, ins.get("OutGrads", [])):
        y = env[name]
        if y.requires_grad:
            ys.append(y)
            cts.append(g if g is not None else torch.zeros_like(y))
    diff = [i for i, v in enumerate(leaves)
            if isinstance(v, torch.Tensor) and v.requires_grad]
    got = torch.autograd.grad(ys, [leaves[i] for i in diff], cts,
                              allow_unused=True) if ys and diff else []
    grads = [None] * len(in_vals)
    for i, g in zip(diff, got):
        grads[i] = torch.zeros_like(leaves[i]) if g is None else g
    return {"InGrads": grads}


class TensorArrayVal(NamedTuple):
    buffer: torch.Tensor  # (C, *element)
    length: torch.Tensor  # () int64


def _read_flag(ctx, t) -> bool:
    """A one-element condition read on the host (counted)."""
    ctx.host_reads += 1
    return bool(t.reshape(()))


@register_op("while")
def _while(ctx, op, ins):
    """Run the sub-block while the Condition var holds, on the run's
    environment; one host read an iteration, and one that ends it."""
    if ctx.abstract:
        raise ValueError("while: no shape inference (its sub-block runs "
                         "on the run's values)")
    block = op.block.program.blocks[op.attr("sub_block")]
    cond_name = op.input("Condition")[0]
    env = ctx.env
    seed0 = ctx.seed
    ctx.need_vjp |= registry.scan_need_vjp(block)
    it = 0
    try:
        while _read_flag(ctx, env[cond_name]):
            it += 1
            ctx.seed = (seed0 * 1000003 + it) & 0xFFFFFFFF
            registry.lower_block(ctx, block, env, scan=False)
    finally:
        ctx.seed = seed0
    return {"Out": [env.get(n) for n in op.output("Out")]}


@register_grad("while")
def _while_grad(ctx, op, fwd_ins, fwd_outs, out_grads):
    raise NotImplementedError(
        "while_grad: no gradient through a While loop (ROADMAP queue 1 "
        "item 8); the reference's reverse mode through lax.while_loop "
        "raises as well")


def _meta(v):
    if isinstance(v, TensorArrayVal):
        return TensorArrayVal(_meta(v.buffer), _meta(v.length))
    if isinstance(v, torch.Tensor):
        return torch.empty_like(v, device="meta")
    return v


def _abstract_outputs(block, env, names):
    """{name: (shape, dtype)} of `names` after the block, from a run on
    meta tensors (LowerCtx(abstract=True))."""
    menv = {n: _meta(v) for n, v in env.items()}
    actx = registry.LowerCtx(0, device="meta", abstract=True)
    registry.lower_block(actx, block, menv)
    return {n: (menv[n].shape, menv[n].dtype) for n in names}


def _detached(v):
    if isinstance(v, TensorArrayVal):
        return TensorArrayVal(v.buffer.detach(), v.length)
    return v.detach() if isinstance(v, torch.Tensor) else v


@register_op("conditional_block")
def _conditional_block(ctx, op, ins):
    """Run the sub-block once when Cond holds (one host read).  When it
    does not, an output keeps its value if the op lists it among its
    inputs, and is otherwise zeros of the shape and dtype an abstract run
    of the block gives, as the reference's skipped branch (:127-131).

    Under autograd (a grad op reads this op's graph) the body runs on
    the op's inputs, the leaves `_eval_with_vjp` made, in a copy of the
    environment, its rules recording; what it writes goes back to the
    run's environment detached."""
    if ctx.abstract:
        raise ValueError("conditional_block: no shape inference (its "
                         "sub-block runs on the run's values)")
    block = op.block.program.blocks[op.attr("sub_block")]
    env = ctx.env
    out_names = op.output("Out")
    record = torch.is_grad_enabled()
    run_env = dict(env) if record else env
    if record:
        for slot, names in op.inputs.items():
            for n, v in zip(names, ins.get(slot, [])):
                if v is not None:
                    run_env[n] = v
    if _read_flag(ctx, first(ins, "Cond")):
        if not record:
            registry.lower_block(ctx, block, env)
        else:
            before, was = dict(run_env), ctx.record
            ctx.record = True
            try:
                registry.lower_block(ctx, block, run_env)
            finally:
                ctx.record = was
                ctx.env = env
            for n, v in run_env.items():
                if before.get(n) is not v:
                    env[n] = _detached(v)
    else:
        listed = set(op.input_arg_names())
        fill = [n for n in out_names if n not in listed]
        if fill:
            for n, (shape, dtype) in _abstract_outputs(
                    block, env, fill).items():
                run_env[n] = torch.zeros(shape, dtype=dtype,
                                         device=ctx.device)
    return {"Out": [run_env.get(n) for n in out_names]}


@register_op("select_input")
def _select_input(ctx, op, ins):
    """X[Mask] of the X list, chosen on the device."""
    xs = ins.get("X", [])
    mask = first(ins, "Mask").reshape(()).long()
    out = xs[0]
    for i, x in enumerate(xs[1:], start=1):
        out = torch.where(mask == i, x, out)
    return {"Out": [out]}


@register_op("select_output")
def _select_output(ctx, op, ins):
    x = first(ins, "X")
    return {"Out": [x for _ in op.output("Out")]}


@register_op("assert")
def _assert(ctx, op, ins):
    """No check, as the reference's (:154-158: kept for the program's
    shape, a no-op under its jit)."""
    return {}


@register_op("print")
def _print(ctx, op, ins):
    """Print `message` and the tensor on the host (one host read), and
    pass it through."""
    x = first(ins, "In")
    if not ctx.abstract:
        ctx.host_reads += 1
        print(f"{op.attr('message', '') or ''} {x.detach().cpu()}")
    return {"Out": [x]}


# -- tensor arrays -----------------------------------------------------------------

def _ir_const(ctx, op, slot):
    """The value of a `fill_constant` that is the last writer of the
    slot's var before `op` in its block, else None (the reference's
    folding, :254-270); found once a run for each op (`ctx.consts`)."""
    key = (id(op), slot)
    if key in ctx.consts:
        return ctx.consts[key]
    names = op.input(slot)
    val = None
    if names and op.block is not None:
        for prev in op.block.ops:
            if prev is op:
                break
            if names[0] in prev.output_arg_names():
                val = (int(prev.attr("value"))
                       if prev.type == "fill_constant" else None)
    ctx.consts[key] = val
    return val


def _length(n, device):
    """A 0-d int64 length made on the device (no copy from the host)."""
    return torch.full((), n, dtype=torch.int64, device=device)


@register_op("write_to_array")
def _write_to_array(ctx, op, ins):
    """Array[I] = X (a new array value; the length grows to I + 1)."""
    x = first(ins, "X")
    i = first(ins, "I").reshape(()).long()
    arr = first(ins, "Array")
    ci = _ir_const(ctx, op, "I")
    if isinstance(arr, TensorArrayVal) and arr.buffer.shape[0] == 0:
        arr = None  # create_array()'s capacity-0 placeholder
    if not isinstance(arr, TensorArrayVal):
        if ci is None:
            if not ctx.abstract:
                raise ValueError(
                    "write_to_array with a traced index needs a "
                    "preallocated array: create_array(dtype, "
                    "capacity=..., element_shape=...) before the loop "
                    "(an index no fill_constant fixes cannot size the "
                    "buffer; see control_flow_ops.py)")
            ci = 0
        buf = x.new_zeros((ci + 1,) + tuple(x.shape))
        buf[ci] = x
        return {"Out": [TensorArrayVal(buf, _length(ci + 1, x.device))]}
    buf, length = arr
    cap = buf.shape[0]
    if ci is not None and ci >= cap:
        buf = torch.cat([buf, buf.new_zeros((ci + 1 - cap,)
                                            + tuple(buf.shape[1:]))])
        cap = ci + 1
    at = torch.clamp(i, 0, cap - 1).reshape(1)
    buf = buf.index_copy(0, at, x.to(buf.dtype).unsqueeze(0))
    return {"Out": [TensorArrayVal(buf, torch.maximum(length, i + 1))]}


@register_op("read_from_array")
def _read_from_array(ctx, op, ins):
    """X[I], the index clamped to the capacity (as
    `lax.dynamic_index_in_dim`)."""
    buf = first(ins, "X").buffer
    i = first(ins, "I").reshape(()).long()
    at = torch.clamp(i, 0, buf.shape[0] - 1).reshape(1)
    return {"Out": [buf.index_select(0, at)[0]]}


@register_op("lod_array_length")
def _lod_array_length(ctx, op, ins):
    return {"Out": [first(ins, "X").length.reshape(1).long()]}


@register_op("allocate_array")
def _allocate_array(ctx, op, ins):
    """An empty array of `capacity` zero elements of `element_shape`."""
    shape = tuple(op.attr("element_shape") or ())
    cap = int(op.attr("capacity") or 0)
    dtype = registry.tdt(op.attr("dtype") or "float32")
    return {"Out": [TensorArrayVal(
        torch.zeros((cap,) + shape, dtype=dtype, device=ctx.device),
        _length(0, ctx.device))]}


def array_to_tensor(buf, axis=0, use_stack=False):
    """(Out, OutIndex) of the elements buf (n, *element): stacked on a new
    axis 0 under `use_stack`, else concatenated along element axis
    `axis`; OutIndex as the reference gives it (:351-352)."""
    if use_stack:
        out = buf
    elif buf.shape[0] == 0:
        out = buf.reshape(buf.shape[1:])
    else:
        out = torch.cat(list(buf.unbind(0)), dim=axis)
    n = buf.shape[1] if buf.ndim > 1 else 1
    return out, torch.full((buf.shape[0],), n, dtype=torch.int64,
                           device=buf.device)


@register_op("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, op, ins):
    """The `length` elements written (one host read), as
    `array_to_tensor` joins them."""
    arr = first(ins, "X")
    buf = arr.buffer
    if not ctx.abstract:
        ctx.host_reads += 1
        buf = buf[:int(arr.length)]
    out, index = array_to_tensor(buf, int(op.attr("axis") or 0),
                                 bool(op.attr("use_stack")))
    return {"Out": [out], "OutIndex": [index]}
