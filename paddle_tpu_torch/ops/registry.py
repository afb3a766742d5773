"""Op rule registry of the port (counterpart of paddle_tpu/ops/registry.py).

An op type maps to one *rule*: a Python function that emits torch
operations, `fn(ctx, op, ins) -> outs`, where `ins`/`outs` map slot names
to lists of tensors.  Op-type names, slots and attrs are the reference's,
so a Program's JSON means the same in both packages.  The Executor runs a
block's rules in order over its device (`lower_block`).

Gradients are generic.  `append_backward` (fluid/backward.py) emits
`<type>_grad` ops that carry a `fwd_op_id` attr.  A forward op that some
grad op references runs on detached copies of its float inputs that
require grad, under `torch.enable_grad()`, and keeps its outputs and those
leaves by op id; its grad op then calls `torch.autograd.grad` from the kept
outputs, with the incoming cotangents, to the leaves.  The detach is what
makes each grad op the forward op's own VJP (the reference's per-op
`jax.vjp`): autograd never runs on into the graphs of earlier ops, and the
forward residuals are reused, not recomputed.  Every other op runs under
`torch.no_grad()`.  `register_grad` still lets an op give its own gradient.

Build-time shape inference (`infer_op_outputs`) runs the rule on `meta`
tensors, twice when an input has a -1 dim (probe sizes 3 and 5): an output
dim that differs between the probes is -1.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List

import torch

from ..fluid import core
from ..fluid.framework import EMPTY_VAR_NAME, Operator

# slot-name map of tensors: {"X": [t], "Y": [t0, t1], ...}
InsOuts = Dict[str, List[Any]]

_FORWARD: Dict[str, Callable] = {}
_GRAD: Dict[str, Callable] = {}
_RULES_LOADED = [False]

logger = logging.getLogger("paddle_tpu_torch.registry")


def _load_rules() -> None:
    """Import the rule modules once (they register on import)."""
    if _RULES_LOADED[0]:
        return
    _RULES_LOADED[0] = True
    from . import (collective_ops, control_flow_ops,  # noqa: F401
                   detection_ops, math_ops, misc_ops, nn_ops,
                   optimizer_ops, quantize_ops, random_ops, rnn_ops,
                   sequence_ops, tensor_ops, vision_ops)


def register_op(op_type: str):
    """Register the forward rule of `op_type`:
    fn(ctx: LowerCtx, op: Operator, ins: InsOuts) -> InsOuts."""

    def deco(fn):
        _FORWARD[op_type] = fn
        return fn

    return deco


def register_grad(op_type: str):
    """Register a custom gradient for `<op_type>_grad` in place of the
    generic autograd path: fn(ctx, grad_op, fwd_ins, fwd_outs, out_grads)
    -> {input_slot: [grads]}, where out_grads maps forward output slots
    to cotangents (None where absent)."""

    def deco(fn):
        _GRAD[op_type] = fn
        return fn

    return deco


def forward_rule(op_type: str) -> Callable:
    _load_rules()
    fn = _FORWARD.get(op_type)
    if fn is None:
        raise NotImplementedError(f"no rule registered for op {op_type!r}")
    return fn


def has_op(op_type: str) -> bool:
    _load_rules()
    if op_type in _FORWARD:
        return True
    return op_type.endswith("_grad") and op_type[: -len("_grad")] in _FORWARD


def has_grad(op_type: str) -> bool:
    """Whether a custom gradient is registered for `op_type`."""
    _load_rules()
    return op_type in _GRAD


def registered_ops() -> List[str]:
    _load_rules()
    return sorted(_FORWARD)


def _mix(seed: int, op_id: int) -> int:
    """A 63-bit generator seed from the step seed and an op id (the
    reference folds the op id into the step's PRNG key)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (op_id & 0x7FFFFFFF) + 1) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


class LowerCtx:
    """Per-run context: the device, the step seed, the kept forward
    graphs (op id -> (outputs, input paths, leaves)) their grad ops use,
    and for the control-flow rules the run's environment (`env`, which a
    sub-block runs on), whether a differentiated sub-block is running
    (`record`: its rules keep their graphs), the folded constants of
    the tensor-array ops (`consts`) and the counts of ops run
    (sub-blocks' included) and of host reads."""

    def __init__(self, seed: int = 0, device=None, abstract: bool = False):
        self.seed = int(seed)
        self.device = torch.device(device if device is not None else "cpu")
        self.vjp_cache: Dict[int, tuple] = {}
        # forward op ids that some *_grad op of the block references
        self.need_vjp: set = set()
        self.abstract = abstract  # True while inferring shapes on meta
        self.env: Dict[str, Any] = {}
        self.record = False
        self.consts: Dict[tuple, Any] = {}
        self.ops_run = 0
        self.host_reads = 0

    def generator(self, op: Operator, device=None) -> torch.Generator:
        """The op's own generator on the context's device (or on
        `device`: "cpu" for draws the host needs, as a crop's offsets):
        seeded from the op's `seed` attr when it has one, else from the
        step seed mixed with the op id.  The seed is a host integer:
        drawing costs no sync."""
        seed = op.attr("seed", 0)
        g = torch.Generator(device=device if device is not None
                            else self.device)
        g.manual_seed(int(seed) if seed else _mix(self.seed, op.id))
        return g


# ---------------------------------------------------------------------------
# Helpers for rules
# ---------------------------------------------------------------------------

def first(ins: InsOuts, slot: str, default=None):
    vals = ins.get(slot) or []
    return vals[0] if vals else default


def xshape(x) -> torch.Tensor:
    """The XShape output some ops carry: an empty (0, *x.shape) tensor."""
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


def tdt(dtype_name) -> torch.dtype:
    """Canonical dtype name -> torch dtype for a rule."""
    return core.torch_dtype(dtype_name)


def _is_diff(x) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex())


# ---------------------------------------------------------------------------
# Running a block
# ---------------------------------------------------------------------------

def scan_need_vjp(block) -> set:
    """Forward op ids whose graph must be kept (referenced by grad ops
    with no custom gradient)."""
    need = set()
    for op in block.ops:
        fid = op.attr("fwd_op_id", None)
        if fid is not None and op.attr("fwd_op_type", "") not in _GRAD:
            need.add(fid)
    return need


def lower_block(ctx: LowerCtx, block, env: Dict[str, Any],
                frees=None, scan: bool = True) -> int:
    """Run every op of `block` in order, reading and writing `env` (var
    name -> tensor).  `frees[i]`, when given, lists the names to drop from
    `env` after op i (their last use).  A sub-block (a `while` or
    `conditional_block` body) runs on the same `env`, as the reference's
    interpreter runs it in a child of the outer scope.  `scan=False`
    skips looking for the grad ops' forward ids (a loop's body, scanned
    once before its first iteration).  Returns the count of the block's
    ops."""
    _load_rules()
    if scan:
        ctx.need_vjp |= scan_need_vjp(block)
    ctx.env = env
    for i, op in enumerate(block.ops):
        lower_op(ctx, op, env)
        ctx.ops_run += 1
        if frees is not None:
            for name in frees[i]:
                env.pop(name, None)
    return len(block.ops)


# ops that run a sub-block (attr "sub_block"): their declared inputs may
# name vars the body writes before it reads them, unset before the loop
SUB_BLOCK_OPS = ("while", "conditional_block")


def _gather_ins(op: Operator, env) -> InsOuts:
    get = env.get if op.type in SUB_BLOCK_OPS else env.__getitem__
    return {slot: [get(n) if n != EMPTY_VAR_NAME else None for n in names]
            for slot, names in op.inputs.items()}


def op_reads_writes(op: Operator):
    """(names op reads, names op writes): its declared slots, and for an
    op with a sub-block also what the body reads before writing it and
    everything the body writes, walked recursively."""
    reads = [n for n in op.input_arg_names() if n != EMPTY_VAR_NAME]
    writes = [n for n in op.output_arg_names() if n != EMPTY_VAR_NAME]
    idx = op.attr("sub_block", None)
    if idx is not None and op.block is not None:
        sub_reads, sub_writes = block_reads_writes(
            op.block.program.blocks[idx])
        reads += [n for n in sub_reads if n not in reads]
        writes += [n for n in sub_writes if n not in writes]
    return reads, writes


def block_reads_writes(block, defined=()):
    """(names the block reads before it writes them, names it writes),
    each in first-seen order, sub-blocks walked recursively; `defined`
    names count as written before the first op."""
    defined = set(defined)
    reads, writes = [], []
    seen_r, seen_w = set(), set()
    for op in block.ops:
        r, w = op_reads_writes(op)
        for n in r:
            if n not in defined and n not in seen_r:
                seen_r.add(n)
                reads.append(n)
        for n in w:
            if n not in seen_w:
                seen_w.add(n)
                writes.append(n)
            defined.add(n)
    return reads, writes


def _bind_outs(op: Operator, outs: InsOuts, env) -> None:
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for i, name in enumerate(names):
            if name == EMPTY_VAR_NAME:
                continue
            if i < len(vals) and vals[i] is not None:
                env[name] = vals[i]


def lower_op(ctx: LowerCtx, op: Operator, env: Dict[str, Any]) -> None:
    if op.attr("fwd_op_id", None) is not None:
        _lower_grad_op(ctx, op, env)
        return
    fn = forward_rule(op.type)
    ins = _gather_ins(op, env)
    if op.id in ctx.need_vjp:
        outs = _eval_with_vjp(ctx, op, fn, ins)
    elif ctx.record:  # in a differentiated sub-block: keep the graph
        outs = fn(ctx, op, ins)
    else:
        with torch.no_grad():
            outs = fn(ctx, op, ins)
    _bind_outs(op, outs, env)


def _eval_with_vjp(ctx: LowerCtx, op: Operator, fn, ins: InsOuts) -> InsOuts:
    """Run a forward op on detached leaves of its float inputs under
    autograd, keep (outputs, paths, leaves) for its grad op, and hand back
    detached outputs."""
    diff_paths, leaves = [], []
    merged = {s: list(vs) for s, vs in ins.items()}
    for slot, vals in ins.items():
        for i, v in enumerate(vals):
            if _is_diff(v):
                leaf = v.detach().requires_grad_()
                merged[slot][i] = leaf
                diff_paths.append((slot, i))
                leaves.append(leaf)
    with torch.enable_grad():
        outs = fn(ctx, op, merged)
    ctx.vjp_cache[op.id] = (outs, diff_paths, leaves)
    return {s: [v.detach() if isinstance(v, torch.Tensor) else v
                for v in vs] for s, vs in outs.items()}


def _lower_grad_op(ctx: LowerCtx, op: Operator, env) -> None:
    fwd_type = op.attr("fwd_op_type")
    fwd_id = op.attr("fwd_op_id")
    fwd_ins: InsOuts = {}
    fwd_outs: InsOuts = {}
    out_grads: InsOuts = {}
    fwd_in_slots = set(op.attr("fwd_input_slots", []))
    fwd_out_slots = set(op.attr("fwd_output_slots", []))
    for slot, names in op.inputs.items():
        vals = [env.get(n) if n != EMPTY_VAR_NAME else None for n in names]
        if slot.endswith("@GRAD"):
            out_grads[slot[: -len("@GRAD")]] = vals
        elif slot in fwd_in_slots:
            fwd_ins[slot] = vals
        elif slot in fwd_out_slots:
            fwd_outs[slot] = vals

    custom = _GRAD.get(fwd_type)
    if custom is not None:
        in_grads = custom(ctx, op, fwd_ins, fwd_outs, out_grads)
        _bind_outs(op, {f"{s}@GRAD": v for s, v in in_grads.items()}, env)
        return

    cached = ctx.vjp_cache.pop(fwd_id, None)
    if cached is None:
        # a backward-only block: run the forward op under autograd now
        fwd_op = Operator(op.block, fwd_id, fwd_type, {}, {},
                          {k: v for k, v in op.attrs.items()
                           if k not in ("fwd_op_id", "fwd_op_type",
                                        "fwd_input_slots",
                                        "fwd_output_slots")})
        fwd_op.inputs = {s: [f"__in_{s}_{i}" for i in range(len(v))]
                         for s, v in fwd_ins.items()}
        _eval_with_vjp(ctx, fwd_op, forward_rule(fwd_type), fwd_ins)
        cached = ctx.vjp_cache.pop(fwd_id)

    outs, diff_paths, leaves = cached
    # outputs without a cotangent contribute nothing (the reference feeds
    # them zeros)
    ys, cts = [], []
    for slot, vals in outs.items():
        g = out_grads.get(slot)
        for i, v in enumerate(vals):
            gi = g[i] if g is not None and i < len(g) else None
            if gi is not None and isinstance(v, torch.Tensor) \
                    and v.requires_grad:
                ys.append(v)
                cts.append(gi)
    got = [None] * len(leaves)
    if ys and leaves:
        with torch.enable_grad():
            got = torch.autograd.grad(ys, leaves, cts, allow_unused=True)
    grads: InsOuts = {}
    for (slot, i), leaf, g in zip(diff_paths, leaves, got):
        lst = grads.setdefault(f"{slot}@GRAD", [])
        while len(lst) <= i:
            lst.append(None)
        lst[i] = torch.zeros_like(leaf) if g is None else g
    _bind_outs(op, grads, env)


# ---------------------------------------------------------------------------
# Build-time shape inference on meta tensors (Block._infer_shapes)
# ---------------------------------------------------------------------------

class ShapeInferBail(Exception):
    """The op's rule could not run on meta tensors; declared shapes stay
    authoritative for its outputs."""

    def __init__(self, op_type: str, reason: str):
        self.op_type = op_type
        self.reason = reason
        super().__init__(f"{op_type}: {reason}")


class ShapeInferSkip(ShapeInferBail):
    """No rule is registered for the op type: the caller owns the shapes
    (not counted as a bailout)."""


# Inferred dtypes are recorded as the reference records them: it runs with
# 64-bit types off, so a 64-bit result is written down as its 32-bit twin.
_NARROW_64 = {"int64": "int32", "uint64": "uint32", "float64": "float32",
              "complex128": "complex64"}


def canon_dtype(name) -> str:
    s = core.convert_dtype(name)
    return _NARROW_64.get(s, s)


def eval_op_shape(op: Operator, block, batch_probe: int) -> InsOuts:
    """Run one op's rule on meta tensors, -1 dims replaced by
    `batch_probe`; returns {slot: [meta tensor, ...]}."""
    specs: InsOuts = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR_NAME:
                vals.append(None)
                continue
            v = block._var_recursive(n)
            if v.shape is None:
                raise ValueError(f"input {n} has unknown shape")
            shape = tuple(batch_probe if d == -1 else d for d in v.shape)
            vals.append(torch.empty(shape, dtype=tdt(v.dtype),
                                    device="meta"))
        specs[slot] = vals
    ctx = LowerCtx(0, device="meta", abstract=True)
    with torch.no_grad():
        return forward_rule(op.type)(ctx, op, specs)


def _grad_fallback(op, block) -> Dict[str, tuple]:
    """A cotangent has the shape/dtype of the value it differentiates:
    `X@GRAD` (and the `X@GRAD@RENAME@i` temps) mirror `X`."""
    out = {}
    for name in op.output_arg_names():
        if name == EMPTY_VAR_NAME or "@GRAD" not in name:
            continue
        base = block._var_recursive(name.split("@GRAD", 1)[0])
        if base.shape is not None:
            out[name] = (tuple(base.shape), canon_dtype(base.dtype))
    return out


def _declared_shape(block, name) -> tuple:
    try:
        return tuple(block._var_recursive(name).shape or ())
    except ValueError:
        return ()


def infer_op_outputs(op: Operator, block) -> Dict[str, tuple]:
    """{output var name: (shape, dtype)} for one op from its declared
    inputs.  Raises ShapeInferSkip for an op type with no rule and
    ShapeInferBail when the rule cannot run on meta tensors."""
    if op.attr("fwd_op_id", None) is not None:
        return _grad_fallback(op, block)
    if not has_op(op.type):
        raise ShapeInferSkip(op.type, "no rule registered")
    dynamic = any(-1 in _declared_shape(block, n)
                  for names in op.inputs.values() for n in names
                  if n != EMPTY_VAR_NAME)
    results = []
    for probe in ((3, 5) if dynamic else (3,)):
        try:
            results.append(eval_op_shape(op, block, probe))
        except Exception as e:  # noqa: BLE001 - value-dependent rule
            raise ShapeInferBail(op.type, f"{type(e).__name__}: {e}")
    first_r, second_r = results[0], results[-1]
    out = {}
    for slot, names in op.outputs.items():
        shapes1 = first_r.get(slot, [])
        shapes2 = second_r.get(slot, [])
        for i, name in enumerate(names):
            if name == EMPTY_VAR_NAME or i >= len(shapes1):
                continue
            s1 = shapes1[i]
            if not isinstance(s1, torch.Tensor):
                continue
            s2 = shapes2[i] if i < len(shapes2) else s1
            shape = tuple(-1 if a != b else int(a)
                          for a, b in zip(s1.shape, s2.shape))
            out[name] = (shape, canon_dtype(s1.dtype))
    return out


_LOGGED_BAIL_TYPES: set = set()


def log_bailout_once(op_type: str, reason: str) -> None:
    """One log line per op type per process for an op whose shapes could
    not be inferred."""
    if op_type in _LOGGED_BAIL_TYPES:
        return
    _LOGGED_BAIL_TYPES.add(op_type)
    logger.info("shape inference bailed out for op type %r (%s); "
                "declared shapes stay authoritative", op_type, reason)
