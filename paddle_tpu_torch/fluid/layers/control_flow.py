"""Control-flow layers (a copy of paddle_tpu/fluid/layers/
control_flow.py, which builds the reference's Program JSON): `While`
appends a `while` op over a sub-block, `while_loop` builds one from a
body function, `cond`, `case` and `switch_case` trace every branch into
the current block and select with `where`, and the tensor-array layers
append the array rules (ops/control_flow_ops.py runs them all).
"""

from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ["While", "while_loop", "cond", "case", "switch_case",
           "increment_", "array_write", "array_read", "array_length",
           "create_array"]


class While:
    """`with While(cond_var).block(): ...` — ops appended inside the guard
    go to a new sub-block executed while cond_var holds."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)
        self._sub_block = None

    def block(self):
        return _WhileGuard(self)


class _WhileGuard:
    def __init__(self, while_op: While):
        self.while_op = while_op

    def __enter__(self):
        prog = default_main_program()
        self.block = prog._create_block()
        return self.block

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        prog = default_main_program()
        sub_idx = self.block.idx
        prog._rollback()
        w = self.while_op
        # loop-carried vars = sub-block writes that exist in parent
        parent = prog.current_block()
        reads, writes = [], []
        seen_r, seen_w, defined = set(), set(), set()
        for op in self.block.ops:
            for n in op.input_arg_names():
                if n not in defined and n not in seen_r:
                    seen_r.add(n)
                    reads.append(n)
            for n in op.output_arg_names():
                seen_w.add(n)
                defined.add(n)
        outer_touch = [n for n in (set(reads) | seen_w)
                       if parent.has_var_recursive(n)]
        out_names = [n for n in seen_w if parent.has_var_recursive(n)]
        parent.append_op(
            "while",
            inputs={"X": sorted(outer_touch),
                    "Condition": [w.cond_var.name]},
            outputs={"Out": sorted(out_names),
                     "StepScopes": ["@EMPTY@"]},
            attrs={"sub_block": sub_idx, "is_test": False},
            infer_shape=False)
        return True


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Functional while_loop (reference control_flow.py:while_loop).  Builds
    the sub-block by calling `body` under a block guard."""
    from .nn import logical_not  # noqa: F401  (parity import)

    prog = default_main_program()
    cond_var = cond(*loop_vars)
    w = While(cond_var, is_test, name)
    with w.block():
        new_vars = body(*loop_vars)
        new_vars = new_vars if isinstance(new_vars, (list, tuple)) else [new_vars]
        from .tensor import assign

        for old, new in zip(loop_vars, new_vars):
            if new is not old:
                assign(new, old)
        # recompute condition on updated vars
        c2 = cond(*loop_vars)
        assign(c2, cond_var)
    return loop_vars


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two-branch conditional (reference layers/control_flow.py cond): both
    branches are traced into the current block and the result selected
    by `where`."""
    from .tensor import cast, where

    t_out = true_fn() if true_fn is not None else None
    f_out = false_fn() if false_fn is not None else None
    if t_out is None:
        return None
    if isinstance(t_out, (list, tuple)):
        return [where(pred, t, f) for t, f in zip(t_out, f_out)]
    # broadcast pred to output shape via where lowering
    return where(pred, t_out, f_out)


def increment_(x, value=1.0):
    from .tensor import increment

    return increment(x, value)


def create_array(dtype, capacity=None, element_shape=None):
    """LoDTensorArray handle (reference fluid/layers/control_flow.py
    create_array): a stacked buffer and a length
    (ops/control_flow_ops.py TensorArrayVal).  Pass `capacity` and
    `element_shape` when the array will be written inside a While block
    (or at any index a fill_constant does not fix): the buffer is
    allocated before the loop; writes at fill_constant indices grow
    the buffer and need neither."""
    helper = LayerHelper("create_array")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    if capacity is not None and element_shape is None:
        raise ValueError("create_array(capacity=...) also needs "
                         "element_shape")
    # Always append the allocator so the handle is BOUND (an unproduced
    # var would fail the executor's read-before-write analysis).
    # capacity=0 allocates an empty sentinel that the first trace-time
    # write replaces with a real buffer.
    helper.append_op("allocate_array", inputs={}, outputs={"Out": [out]},
                     attrs={"capacity": int(capacity or 0),
                            "element_shape": list(element_shape or []),
                            "dtype": dtype})
    return out


def array_write(x, i, array=None):
    """Write x at index i (reference array_write).  Returns the array
    (a NEW version var: functional update, not mutation)."""
    helper = LayerHelper("array_write")
    inputs = {"X": [x], "I": [i]}
    if array is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    else:
        inputs["Array"] = [array]
        out = array
    helper.append_op("write_to_array", inputs=inputs,
                     outputs={"Out": [out]})
    return out


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op("read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op("lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def case(pred_fn_pairs, default=None, name=None):
    """Run the fn of the FIRST true pred (reference
    layers/control_flow.py case:3036) — lowered as a right-fold of
    cond selects, so 'first true wins' exactly like the reference."""
    if not pred_fn_pairs:
        raise TypeError("pred_fn_pairs must be a non-empty list/tuple")
    for p in pred_fn_pairs:
        if not (isinstance(p, (list, tuple)) and len(p) == 2
                and callable(p[1])):
            raise TypeError(
                "each pred_fn_pairs element must be a (pred, callable) "
                f"pair, got {p!r}")
    if default is None:
        # reference semantics: last fn doubles as the default
        pred_fn_pairs, default = (pred_fn_pairs[:-1],
                                  pred_fn_pairs[-1][1])
    out = default()
    for pred, fn in reversed(list(pred_fn_pairs)):
        out = cond(pred, fn, (lambda o=out: o))
    return out


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Select a branch by integer index (reference
    layers/control_flow.py switch_case:3129).  branch_fns: dict
    {index: fn} or list of (index, fn) / fns."""
    from .tensor import fill_constant

    if isinstance(branch_fns, (list, tuple)):
        pairs = sorted(((i, fn) if callable(fn) else tuple(fn)
                        for i, fn in enumerate(branch_fns)),
                       key=lambda p: p[0])
    elif isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        raise TypeError("branch_fns must be list/tuple/dict")
    keys = [k for k, _ in pairs]
    if len(set(keys)) != len(keys):
        raise ValueError(f"duplicate branch indices: {keys}")
    if default is None:
        default = pairs[-1][1]  # reference: max-index fn is default
        pairs = pairs[:-1]
    out = default()
    for idx, fn in reversed(pairs):
        eq = branch_index == fill_constant([1], branch_index.dtype, idx)
        out = cond(eq, fn, (lambda o=out: o))
    return out
