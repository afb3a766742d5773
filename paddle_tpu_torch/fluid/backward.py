"""append_backward: autodiff as a Program transform (a copy of
paddle_tpu/fluid/backward.py: `append_backward`, `gradients` and
`append_backward_with_checkpoints`).

One generic mechanism covers every op: each emitted `<type>_grad` op
carries `fwd_op_id`, and when the block runs, the forward op's own autograd
graph (kept by paddle_tpu_torch/ops/registry.py) gives the exact
reverse-mode gradient, reusing the forward residuals.  A var with several
consumers gets its contributions under `@GRAD@RENAME@i` names, summed by a
`sum` op.  With checkpoints (recompute), each forward segment between
two checkpoints gets one `recompute_segment_grad` op, which replays the
segment when the backward reaches it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from . import core
from .framework import (EMPTY_VAR_NAME, OpRole, Parameter, Variable,
                        grad_var_name)

_GRAD_ATTR_KEYS = ("fwd_op_id", "fwd_op_type", "fwd_input_slots",
                   "fwd_output_slots")


def _requires_grad_set(block, no_grad: set) -> set:
    """Forward-propagate 'requires grad' from trainable params / leaf vars
    with stop_gradient=False."""
    produced = {n for op in block.ops for n in op.output_arg_names()}
    req = set()
    for v in block.vars.values():
        if isinstance(v, Parameter) and v.trainable and v.name not in no_grad:
            req.add(v.name)
        elif (not v.stop_gradient
              and core.is_float_dtype(v.dtype) and v.name not in no_grad
              and v.name not in produced):
            # leaf var explicitly marked differentiable
            req.add(v.name)
    for op in block.ops:
        if any(n in req for n in op.input_arg_names()):
            for n in op.output_arg_names():
                if n == EMPTY_VAR_NAME or n in no_grad:
                    continue
                try:
                    v = block._var_recursive(n)
                except ValueError:
                    continue
                if not v.stop_gradient and core.is_float_dtype(v.dtype):
                    req.add(n)
    return req


def _create_grad_var(block, fwd_name: str, grad_name: str) -> Variable:
    if block.has_var(grad_name):
        return block.var(grad_name)
    fwd = block._var_recursive(fwd_name)
    return block.create_var(name=grad_name, shape=fwd.shape, dtype=fwd.dtype,
                            stop_gradient=True)


def _merge_grads(block, fwd_name: str, grad_map: Dict[str, List[str]],
                 op_role=OpRole.Backward) -> Optional[str]:
    """Collapse all recorded contributions for `fwd_name` into the canonical
    @GRAD var via a sum op; returns the canonical grad name or None."""
    contribs = grad_map.get(fwd_name)
    if not contribs:
        return None
    canonical = grad_var_name(fwd_name)
    if len(contribs) == 1:
        if contribs[0] != canonical:
            _create_grad_var(block, fwd_name, canonical)
            block.append_op("assign", inputs={"X": [contribs[0]]},
                            outputs={"Out": [canonical]},
                            attrs={"op_role": op_role}, infer_shape=False)
        grad_map[fwd_name] = [canonical]
        return canonical
    _create_grad_var(block, fwd_name, canonical)
    block.append_op("sum", inputs={"X": list(contribs)},
                    outputs={"Out": [canonical]},
                    attrs={"op_role": op_role}, infer_shape=False)
    grad_map[fwd_name] = [canonical]
    return canonical


def _record_grad(block, fwd_name: str, grad_map: Dict[str, List[str]]) -> str:
    """Pick a fresh output name for a new gradient contribution."""
    contribs = grad_map.setdefault(fwd_name, [])
    if not contribs:
        name = grad_var_name(fwd_name)
    else:
        name = f"{grad_var_name(fwd_name)}@RENAME@{len(contribs)}"
    contribs.append(name)
    _create_grad_var(block, fwd_name, name)
    return name



def _seed_target_grad(block, target_name: str) -> Dict[str, List[str]]:
    """Create the d(target)/d(target)=1 seed var+op; returns a fresh grad
    map."""
    target = block._var_recursive(target_name)
    loss_grad = grad_var_name(target_name)
    block.create_var(name=loss_grad, shape=target.shape, dtype=target.dtype,
                     stop_gradient=True)
    block.append_op(
        "fill_constant", outputs={"Out": [loss_grad]},
        attrs={"shape": list(target.shape or ()), "dtype": target.dtype,
               "value": 1.0, "op_role": OpRole.Backward | OpRole.Loss},
        infer_shape=False)
    return {target_name: [loss_grad]}


def _finalize_params_grads(block, program, parameter_list, grad_map):
    if parameter_list is not None:
        params = [block._var_recursive(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    params_and_grads = []
    for p in params:
        g = _merge_grads(block, p.name, grad_map)
        if g is None:
            continue
        params_and_grads.append((p, block.var(g)))
    return params_and_grads


def _append_grad_ops(block, target_name: str, req: set, no_grad: set,
                     stop_at_ops: Optional[set] = None) -> Dict[str, List[str]]:
    """Emit grad ops for every relevant forward op, in reverse order.
    Returns the grad map (fwd var -> contribution list)."""
    grad_map = _seed_target_grad(block, target_name)

    fwd_ops = [op for op in block.ops
               if "fwd_op_id" not in op.attrs
               and op.attr("op_role", 0) not in (OpRole.Backward,
                                                 OpRole.Optimize)]
    for op in reversed(fwd_ops):
        if stop_at_ops is not None and op.id not in stop_at_ops:
            continue
        out_names = [n for n in op.output_arg_names() if n != EMPTY_VAR_NAME]
        if not any(n in grad_map for n in out_names):
            continue
        in_names = [n for n in op.input_arg_names() if n != EMPTY_VAR_NAME]
        grad_targets = [n for n in in_names if n in req and n not in no_grad]
        if not grad_targets:
            continue

        # 1. merge multi-consumer contributions for this op's outputs
        grad_inputs = {}
        for slot, names in op.outputs.items():
            gs = []
            for n in names:
                if n != EMPTY_VAR_NAME and n in grad_map:
                    gs.append(_merge_grads(block, n, grad_map))
                else:
                    gs.append(EMPTY_VAR_NAME)
            grad_inputs[f"{slot}@GRAD"] = gs

        # 2. emit the grad op
        grad_outputs = {}
        seen_targets = set()
        for slot, names in op.inputs.items():
            outs = []
            for n in names:
                if n in req and n not in no_grad and n not in seen_targets:
                    seen_targets.add(n)
                    outs.append(_record_grad(block, n, grad_map))
                else:
                    outs.append(EMPTY_VAR_NAME)
            grad_outputs[f"{slot}@GRAD"] = outs

        inputs = {}
        for slot, names in op.inputs.items():
            inputs[slot] = list(names)
        for slot, names in op.outputs.items():
            inputs[slot] = list(names)
        inputs.update(grad_inputs)

        attrs = dict(op.attrs)
        attrs.update({
            "fwd_op_id": op.id,
            "fwd_op_type": op.type,
            "fwd_input_slots": list(op.inputs),
            "fwd_output_slots": list(op.outputs),
            "op_role": OpRole.Backward,
        })
        block.append_op(f"{op.type}_grad", inputs=inputs,
                        outputs=grad_outputs, attrs=attrs, infer_shape=False)
    return grad_map


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append grad ops computing d(loss)/d(param); returns
    [(param, grad_var), ...] like the reference (backward.py:1275)."""
    block = loss.block
    program = block.program
    assert block.idx == 0, "append_backward operates on the global block"
    no_grad = set(no_grad_set or ())
    req = _requires_grad_set(block, no_grad)
    if loss.name not in req:
        req.add(loss.name)

    grad_map = _append_grad_ops(block, loss.name, req, no_grad)

    return _finalize_params_grads(block, program, parameter_list, grad_map)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(targets)/d(inputs) as new grad vars (backward.py:1864)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    assert len(targets) == 1, "multi-target gradients: sum targets first"
    block = targets[0].block
    no_grad = set(no_grad_set or ())
    req = _requires_grad_set(block, no_grad)
    for v in inputs:
        req.add(v.name)
    # re-propagate with inputs as roots
    for op in block.ops:
        if any(n in req for n in op.input_arg_names()):
            for n in op.output_arg_names():
                if n == EMPTY_VAR_NAME:
                    continue
                try:
                    var = block._var_recursive(n)
                except ValueError:
                    continue
                if not var.stop_gradient and core.is_float_dtype(var.dtype):
                    req.add(n)
    grad_map = _append_grad_ops(block, targets[0].name, req, no_grad)
    outs = []
    for v in inputs:
        g = _merge_grads(block, v.name, grad_map)
        outs.append(block.var(g) if g else None)
    return outs


def append_backward_with_checkpoints(loss, checkpoints, parameter_list=None,
                                     no_grad_set=None):
    """Recompute-aware backward (backward.py:244-316 of the reference):
    the forward ops are cut into segments after each op that writes a
    checkpoint var; each segment gets one `recompute_segment_grad` op,
    which re-runs the segment from its inputs when the backward reaches
    it, so between forward and backward only the segments' inputs (the
    checkpoints, the feeds and the parameters) stay live."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())
    req = _requires_grad_set(block, no_grad)
    req.add(loss.name)
    ckpt_names = {c.name if isinstance(c, Variable) else str(c)
                  for c in checkpoints}

    fwd_ops = [op for op in block.ops
               if "fwd_op_id" not in op.attrs
               and op.attr("op_role", 0) not in (OpRole.Backward,
                                                 OpRole.Optimize)]
    # segment boundaries: after the op that produces each checkpoint var
    cut_after = set()
    for i, op in enumerate(fwd_ops):
        if set(op.output_arg_names()) & ckpt_names:
            cut_after.add(i)
    segments = []
    start = 0
    for i in sorted(cut_after):
        segments.append((start, i + 1))
        start = i + 1
    if start < len(fwd_ops):
        segments.append((start, len(fwd_ops)))

    grad_map = _seed_target_grad(block, loss.name)

    for a, b in reversed(segments):
        seg_ops = fwd_ops[a:b]
        produced = set()
        seg_inputs = []
        seen = set()
        for op in seg_ops:
            for n in op.input_arg_names():
                if n != EMPTY_VAR_NAME and n not in produced and n not in seen:
                    seen.add(n)
                    seg_inputs.append(n)
            produced |= set(op.output_arg_names())
        seg_outputs = [n for n in dict.fromkeys(
            n for op in seg_ops for n in op.output_arg_names())
            if n in grad_map]
        if not seg_outputs:
            continue
        targets = [n for n in seg_inputs if n in req and n not in no_grad]
        if not targets:
            continue
        out_grad_names = [_merge_grads(block, n, grad_map)
                          for n in seg_outputs]
        in_grad_names = []
        for n in seg_inputs:
            if n in targets:
                in_grad_names.append(_record_grad(block, n, grad_map))
            else:
                in_grad_names.append(EMPTY_VAR_NAME)
        block.append_op(
            "recompute_segment_grad",
            inputs={"Inputs": seg_inputs, "OutGrads": out_grad_names},
            outputs={"InGrads": in_grad_names},
            attrs={"seg_op_ids": [o.id for o in seg_ops],
                   "seg_inputs": seg_inputs, "seg_outputs": seg_outputs,
                   "op_role": OpRole.Backward},
            infer_shape=False)

    return _finalize_params_grads(block, program, parameter_list, grad_map)
