"""The AMP program rewrite (a copy of paddle_tpu/fluid/contrib/
mixed_precision/fp16_utils.py): cast ops inserted by the white, black and
gray lists.  A var is cast once for each dtype it is read in (one cast
copy of each weight a step); the Executor frees the copy after its last
reader, the backward's included.
"""

from __future__ import annotations

from ... import core
from ...framework import EMPTY_VAR_NAME, Operator

_CASTABLE = ("float32",)


def _cast_name(name, dest):
    return f"{name}.cast_{dest}"


def rewrite_program(main_program, amp_lists, dest_dtype="bfloat16",
                    level="O1"):
    """In-place rewrite of the forward program (call BEFORE
    append_backward so grad ops differentiate through the casts)."""
    block = main_program.global_block()
    dest = core.convert_dtype(dest_dtype)
    # runtime dtype of each var name as the rewrite progresses
    vdtype = {}
    for v in block.vars.values():
        vdtype[v.name] = v.dtype

    new_ops = []
    casted = {}  # (name, dtype) -> cast var name

    def ensure_dtype(name, want):
        cur = vdtype.get(name, "float32")
        if cur == want or cur not in _CASTABLE + ("bfloat16", "float16"):
            return name
        if not core.is_float_dtype(cur):
            return name
        key = (name, want)
        if key in casted:
            return casted[key]
        cname = _cast_name(name, want)
        src_var = block._var_recursive(name)
        block.create_var(name=cname, shape=src_var.shape, dtype=want,
                         stop_gradient=src_var.stop_gradient)
        new_ops.append(Operator(
            block, main_program._next_op_id(), "cast",
            {"X": [name]}, {"Out": [cname]},
            {"in_dtype": cur, "out_dtype": want}))
        casted[key] = cname
        return cname

    for op in block.ops:
        if op.type in amp_lists.white_list and not (
                set(op.input_arg_names()) & amp_lists.black_varnames):
            want = dest
        elif op.type in amp_lists.black_list:
            want = "float32"
        elif op.type in amp_lists.gray_list:
            in_dtypes = {vdtype.get(n, "float32")
                         for n in op.input_arg_names()
                         if n != EMPTY_VAR_NAME
                         and core.is_float_dtype(vdtype.get(n, "float32"))}
            # follow inputs: stay low-precision only if every float input is
            want = dest if in_dtypes and in_dtypes <= {dest} else None
            if want is None:
                want = "float32" if len(in_dtypes) > 1 else None
        else:
            want = "float32"  # unknown ops run in f32 for safety

        if want is not None:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [
                    ensure_dtype(n, want) if n != EMPTY_VAR_NAME
                    and core.is_float_dtype(vdtype.get(n, "int"))
                    else n
                    for n in names]
        new_ops.append(op)
        # outputs take the op's compute dtype
        out_dtype = want if want is not None else None
        for n in op.output_arg_names():
            if n == EMPTY_VAR_NAME:
                continue
            cur = vdtype.get(n, None)
            v = block.vars.get(n)
            if out_dtype is not None and core.is_float_dtype(
                    (v.dtype if v is not None else "float32")):
                vdtype[n] = out_dtype
                if v is not None:
                    v.dtype = out_dtype
            elif cur is None and v is not None:
                vdtype[n] = v.dtype

    block.ops = new_ops
    main_program._bump_version()
    return main_program


def cast_model_to_fp16(program, amp_lists=None, use_fp16_guard=False):
    """Paddle's O2 whole-model cast; the reference applies its O1
    `rewrite_program`, and so does the port."""
    from .fp16_lists import AutoMixedPrecisionLists

    return rewrite_program(program, amp_lists or AutoMixedPrecisionLists())


def find_true_prev_op(ops, cur_op, var_name):
    for op in ops:
        if var_name in op.output_arg_names():
            return op
    return None
