"""Optimizer update rules (counterpart of paddle_tpu/ops/optimizer_ops.py):
sgd, momentum and adam.

Each rule returns the new value under `ParamOut` (whose variable name is
`Param`'s) and the new accumulators under their `*Out` slots; the Executor
writes them back into the Scope after the step.
"""

from __future__ import annotations

import torch

from .registry import first, register_op


@register_op("sgd")
def _sgd(ctx, op, ins):
    p, g, lr = first(ins, "Param"), first(ins, "Grad"), \
        first(ins, "LearningRate")
    return {"ParamOut": [p - lr.to(p.dtype) * g.to(p.dtype)]}


@register_op("momentum")
def _momentum(ctx, op, ins):
    """optimizer_ops.py:31-47: g += coeff * p under
    regularization_method "l2_decay"; v = mu v + g; p -= lr v, or the
    Nesterov form p -= (g + mu v) lr."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    v = first(ins, "Velocity")
    lr = first(ins, "LearningRate").to(p.dtype)
    mu = op.attr("mu", 0.9)
    if op.attr("regularization_method", "") == "l2_decay":
        g = g + op.attr("regularization_coeff", 0.0) * p
    v_out = mu * v + g
    if op.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("adam")
def _adam(ctx, op, ins):
    """optimizer_ops.py:50-70, the beta powers advanced by one step."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    m1, m2 = first(ins, "Moment1"), first(ins, "Moment2")
    b1p, b2p = first(ins, "Beta1Pow"), first(ins, "Beta2Pow")
    beta1 = first(ins, "Beta1Tensor", op.attr("beta1", 0.9))
    beta2 = first(ins, "Beta2Tensor", op.attr("beta2", 0.999))
    eps = op.attr("epsilon", 1e-8)
    m1o = beta1 * m1 + (1 - beta1) * g
    m2o = beta2 * m2 + (1 - beta2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p.to(p.dtype)) / (1 - b1p.to(p.dtype))
    p_out = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return {
        "ParamOut": [p_out],
        "Moment1Out": [m1o],
        "Moment2Out": [m2o],
        "Beta1PowOut": [b1p * beta1],
        "Beta2PowOut": [b2p * beta2],
    }
