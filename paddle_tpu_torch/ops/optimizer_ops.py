"""Optimizer update rules (counterpart of paddle_tpu/ops/optimizer_ops.py):
sgd, momentum, adam, adamw, adagrad, rmsprop, adadelta, adamax, lamb,
lars_momentum, dpsgd, dgc, decayed_adagrad, proximal_gd,
proximal_adagrad and ftrl, and the AMP rules check_finite_and_unscale and
update_loss_scaling.

Each rule returns the new value under `ParamOut` (whose variable name is
`Param`'s) and the new accumulators under their `*Out` slots; the Executor
writes them back into the Scope after the step.  The whole-tensor norms
of lamb, lars_momentum and dpsgd, and the AMP found flag, stay on the
device: no rule reads a value back to the host.
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


@register_op("adamw")
def _adamw(ctx, op, ins):
    """optimizer_ops.py:73-84: Param decayed by (1 - lr lr_ratio coeff),
    then the adam rule; with_decay False is plain adam."""
    if not op.attr("with_decay", True):
        return _adam(ctx, op, ins)
    p = first(ins, "Param")
    lr = first(ins, "LearningRate").to(p.dtype)
    decay = 1.0 - lr * op.attr("lr_ratio", 1.0) * op.attr("coeff", 0.01)
    return _adam(ctx, op, dict(ins, Param=[p * decay]))


@register_op("adagrad")
def _adagrad(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    m_out = first(ins, "Moment") + torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + op.attr("epsilon", 1e-6))
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_op("rmsprop")
def _rmsprop(ctx, op, ins):
    """optimizer_ops.py:100-121: MeanGrad is zeros when absent, and
    passes through unless centered."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    ms = first(ins, "MeanSquare")
    mg = first(ins, "MeanGrad")
    if mg is None:
        mg = torch.zeros_like(p)
    lr = first(ins, "LearningRate").to(p.dtype)
    rho, eps = op.attr("decay", 0.95), op.attr("epsilon", 1e-6)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    if op.attr("centered", False):
        mg_out = rho * mg + (1 - rho) * g
        denom = ms_out - torch.square(mg_out) + eps
    else:
        mg_out, denom = mg, ms_out + eps
    mom_out = op.attr("momentum", 0.0) * first(ins, "Moment") \
        + lr * g / torch.sqrt(denom)
    return {"ParamOut": [p - mom_out], "MomentOut": [mom_out],
            "MeanSquareOut": [ms_out], "MeanGradOut": [mg_out]}


@register_op("adadelta")
def _adadelta(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    ag, au = first(ins, "AvgSquaredGrad"), first(ins, "AvgSquaredUpdate")
    rho, eps = op.attr("rho", 0.95), op.attr("epsilon", 1e-6)
    ag_out = rho * ag + (1 - rho) * torch.square(g)
    update = -torch.sqrt((au + eps) / (ag_out + eps)) * g
    au_out = rho * au + (1 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [ag_out],
            "AvgSquaredUpdateOut": [au_out]}


@register_op("adamax")
def _adamax(ctx, op, ins):
    """optimizer_ops.py:141-156: Beta1Pow is read, not advanced (the
    reference's op has no Beta1PowOut)."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    b1p = first(ins, "Beta1Pow").to(p.dtype)
    beta1, beta2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    m_out = beta1 * first(ins, "Moment") + (1 - beta1) * g
    inf_out = torch.maximum(beta2 * first(ins, "InfNorm"), torch.abs(g))
    p_out = p - (lr / (1 - b1p)) * m_out / (inf_out
                                           + op.attr("epsilon", 1e-8))
    return {"ParamOut": [p_out], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


@register_op("lamb")
def _lamb(ctx, op, ins):
    """optimizer_ops.py:159-182: the trust ratio ||p|| / ||r|| of the
    whole tensor, 1 where either norm is 0."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    b1p, b2p = first(ins, "Beta1Pow"), first(ins, "Beta2Pow")
    beta1, beta2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
    m1o = beta1 * first(ins, "Moment1") + (1 - beta1) * g
    m2o = beta2 * first(ins, "Moment2") + (1 - beta2) * torch.square(g)
    m1h = m1o / (1 - b1p.to(p.dtype))
    m2h = m2o / (1 - b2p.to(p.dtype))
    r = m1h / (torch.sqrt(m2h) + op.attr("epsilon", 1e-6)) \
        + op.attr("weight_decay", 0.01) * p
    w_norm, r_norm = _norm(p), _norm(r)
    one = torch.ones((), dtype=p.dtype, device=p.device)
    trust = torch.where(w_norm > 0, torch.where(r_norm > 0, w_norm / r_norm,
                                                one), one)
    return {"ParamOut": [p - lr * trust * r], "Moment1Out": [m1o],
            "Moment2Out": [m2o], "Beta1PowOut": [b1p * beta1],
            "Beta2PowOut": [b2p * beta2]}


@register_op("lars_momentum")
def _lars_momentum(ctx, op, ins):
    """optimizer_ops.py:185-201: local lr = lr coeff ||p|| / (||g|| + wd
    ||p|| + eps) where both norms are positive, else lr."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    coeff = op.attr("lars_coeff", 0.001)
    wd = op.attr("lars_weight_decay", 0.0005)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + wd * p_norm
                               + op.attr("epsilon", 0.0)), lr)
    v_out = op.attr("mu", 0.9) * first(ins, "Velocity") \
        + local_lr * (g + wd * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


@register_op("dpsgd")
def _dpsgd(ctx, op, ins):
    """optimizer_ops.py:204-221: the gradient clipped to norm `clip`,
    plus N(0, (sigma clip)^2) noise over batch_size.  The noise is
    torch's, from the op's generator: other bits than the reference's."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    clip = op.attr("clip", 10.0)
    scale = torch.clamp(clip / torch.clamp(_norm(g), min=1e-12), max=1.0)
    noise = torch.empty_like(g)
    if not ctx.abstract:
        noise.normal_(generator=ctx.generator(op))
    noise = noise * (op.attr("sigma", 1.0) * clip)
    g_priv = g * scale + noise / op.attr("batch_size", 16.0)
    return {"ParamOut": [p - lr * g_priv]}


# -- AMP rules (operators/amp/ in Paddle) -------------------------------------

@register_op("check_finite_and_unscale")
def _check_finite_and_unscale(ctx, op, ins):
    """optimizer_ops.py:224-235: every X divided by Scale; FoundInfinite
    a (1,) bool on the device, true when any X holds an inf or a NaN."""
    xs, scale = ins.get("X", []), first(ins, "Scale")
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for x in xs:
        found = found | ~torch.all(torch.isfinite(x))
        outs.append(x / scale.to(x.dtype))
    return {"Out": outs, "FoundInfinite": [found.reshape(1)]}


@register_op("update_loss_scaling")
def _update_loss_scaling(ctx, op, ins):
    """optimizer_ops.py:238-262: on an overflow the good count restarts,
    the bad count grows and, at decr_every_n_nan_or_inf, the scale
    shrinks by decr_ratio; else the good count grows and, at
    incr_every_n_steps, the scale grows by incr_ratio.  The scale stays
    at least 1; the X come out zeroed on an overflow."""
    found = first(ins, "FoundInfinite").reshape(())
    prev = first(ins, "PrevLossScaling")
    good, bad = first(ins, "InGoodSteps"), first(ins, "InBadSteps")
    good_new = torch.where(found, torch.zeros_like(good), good + 1)
    bad_new = torch.where(found, bad + 1, torch.zeros_like(bad))
    grow = good_new >= op.attr("incr_every_n_steps", 1000)
    shrink = bad_new >= op.attr("decr_every_n_nan_or_inf", 2)
    scale = torch.where(
        found, torch.where(shrink, prev * op.attr("decr_ratio", 0.5), prev),
        torch.where(grow, prev * op.attr("incr_ratio", 2.0), prev))
    scale = torch.clamp(scale, min=1.0)
    good_new = torch.where(grow, torch.zeros_like(good_new), good_new)
    bad_new = torch.where(shrink, torch.zeros_like(bad_new), bad_new)
    outs = [torch.where(found, torch.zeros_like(x), x)
            for x in ins.get("X", [])]
    return {"Out": outs, "LossScaling": [scale],
            "OutGoodSteps": [good_new], "OutBadSteps": [bad_new]}


@register_op("dgc")
def _dgc(ctx, op, ins):
    """optimizer_ops.py:265-311, Deep Gradient Compression: momentum
    correction u = m u + g, error feedback v = v + u, and the elements
    of v with |v| at least the k-th largest, k = max(1, round(n (1 -
    ratio))), sent (EncodeGrad) and cleared from u and v; ties at the
    threshold are all kept.  With a ratio_list and a CurrentStep the
    ratio is ratio_list[clip(step // max(1, rampup_step // len), 0,
    len - 1)], chosen on the device."""
    u, v = first(ins, "U"), first(ins, "V")
    g = first(ins, "Grad").to(torch.float32)
    step = first(ins, "CurrentStep")
    m = float(op.attr("m") or 0.9)
    ratios = op.attr("ratio_list") or [float(op.attr("ratio") or 0.999)]
    u_new = m * u + g
    v_new = v + u_new
    flat = torch.abs(v_new).reshape(-1)

    def thr_for(ratio):
        keep = max(1, int(round(flat.shape[0] * (1.0 - float(ratio)))))
        return torch.topk(flat, keep).values[-1]

    if len(ratios) == 1 or step is None:
        thr = thr_for(ratios[-1])
    else:
        per = max(1, int(op.attr("rampup_step") or 1) // len(ratios))
        idx = torch.clamp(step.reshape(()).to(torch.int64) // per, 0,
                          len(ratios) - 1)
        thrs = torch.stack([thr_for(r) for r in ratios])
        thr = thrs[idx]
    mask = (torch.abs(v_new) >= thr).to(v_new.dtype)
    return {"U_out": [u_new * (1.0 - mask)], "V_out": [v_new * (1.0 - mask)],
            "EncodeGrad": [v_new * mask]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    decay = op.attr("decay", 0.95)
    m_out = decay * first(ins, "Moment") + (1 - decay) * torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + op.attr("epsilon", 1e-6))
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


def _prox(prox, lr, l1, l2):
    """The l1 / l2 proximal shrink of proximal_gd and proximal_adagrad."""
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                          min=0.0) / (1.0 + lr * l2)


@register_op("proximal_gd")
def _proximal_gd(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    return {"ParamOut": [_prox(p - lr * g, lr, op.attr("l1", 0.0),
                               op.attr("l2", 0.0))]}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx, op, ins):
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    lr = first(ins, "LearningRate").to(p.dtype)
    m_out = first(ins, "Moment") + torch.square(g)
    lr_t = lr / torch.sqrt(m_out)
    return {"ParamOut": [_prox(p - lr_t * g, lr_t, op.attr("l1", 0.0),
                               op.attr("l2", 0.0))],
            "MomentOut": [m_out]}


@register_op("ftrl")
def _ftrl(ctx, op, ins):
    """optimizer_ops.py:357-382 (FTRL-proximal)."""
    p = first(ins, "Param")
    g = first(ins, "Grad").to(p.dtype)
    sq, lin = first(ins, "SquaredAccumulator"), first(ins,
                                                      "LinearAccumulator")
    lr = first(ins, "LearningRate").to(p.dtype)
    l1, l2 = op.attr("l1", 0.0), op.attr("l2", 0.0)
    lr_power = op.attr("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        y = torch.sqrt(new_sq) / lr + 2.0 * l2
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq, -lr_power)) / lr
        y = torch.pow(new_sq, -lr_power) / lr + 2.0 * l2
    lin_out = lin + g - sigma * p
    x = l1 * torch.sign(lin_out) - lin_out
    p_out = torch.where(torch.abs(lin_out) > l1, x / y, torch.zeros_like(p))
    return {"ParamOut": [p_out], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}
