"""`paddle.optimizer`: eager optimizers over a Layer's parameters
(counterpart of paddle_tpu/optimizer/__init__.py).

Each optimizer's `_update(p, g, state, lr, t, wd)` is a plain function
on lists of float32 tensors: parameters, gradients, the state by slot,
a learning rate and a decay coefficient for each parameter.  It runs
over the whole list with `torch._foreach_*` and returns new tensors,
so one caller may commit them (`step`) and another keep the old ones
where a gradient was not finite (hapi's static-mode adapter).  The
state stays float32 whatever the parameters' dtype.

`step` keeps the reference's order: the grad clip on the gradients,
then coupled L2 decay (`weight_decay` given as a float) added to the
float32 gradient, then the update with the rate scaled by each
parameter's learning-rate multiplier.  As in the reference, a
`weight_decay` that is not a float (a `regularizer.L2Decay` object, an
int) is ignored.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import lr as lr_module
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "lr",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]

lr = lr_module

_f32 = np.float32


def _as_f32(t):
    return t if t.dtype == torch.float32 else t.float()


def _scaled(tensors, scales):
    """[t * s] for per-tensor Python scalars s."""
    return torch._foreach_mul(tensors, [float(s) for s in scales])


class ClipGradByGlobalNorm:
    """g * min(1, clip_norm / max(||all grads||, 1e-6)), the norm taken
    in float32 over every gradient; no host read."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def _apply(self, grads):
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        gnorm = torch.sqrt(torch.stack(sq).sum())
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-6),
                            max=1.0)
        return [g * scale.to(g.dtype) for g in grads]


class ClipGradByNorm:
    """Each gradient times min(1, clip_norm / max(||g||, 1e-6))."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _apply(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-6),
                                max=1.0)
            out.append(g * scale.to(g.dtype))
        return out


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _apply(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class Optimizer:
    """Base optimizer (reference: optimizer/__init__.py:74).  Subclasses
    define `_init_state(param) -> {slot: f32 tensor}` and `_update`."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, float):
            self._l2_coef = weight_decay
            self._coupled_decay = True
        else:
            self._l2_coef = 0.0
            self._coupled_decay = False
        self._state: Dict[int, dict] = {}
        self._step_count = 0

    # -- learning rate -------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- state ---------------------------------------------------------------
    def _init_state(self, param) -> dict:
        return {}

    def _zeros(self, param, value=0.0):
        return torch.full_like(param, value, dtype=torch.float32,
                               requires_grad=False)

    def _update(self, p, g, state, lr, t, wd):
        raise NotImplementedError

    def _param_state(self, param):
        key = id(param)
        if key not in self._state:
            self._state[key] = self._init_state(param)
        return self._state[key]

    def _decay_coef(self, param) -> float:
        """Per-parameter decay coefficient: the coupled-L2 float."""
        return self._l2_coef

    @staticmethod
    def _lr_mult(param) -> float:
        return float(getattr(param, "optimize_attr", {}).get(
            "learning_rate", 1.0))

    def _apply(self, params, grads, values, lr_value, t):
        """The update of `params` (their current values `values`, any
        dtype) by `grads`, already clipped: coupled decay on the f32
        gradient, then `_update` at lr * multiplier.  Returns (new f32
        values, {slot: new f32 states}); commits nothing."""
        p32 = [_as_f32(v.detach()) for v in values]
        g32 = [_as_f32(g) for g in grads]
        wds = [float(self._decay_coef(p)) for p in params]
        if self._coupled_decay:  # g + w p, summed in a fresh list
            decayed = _scaled(p32, wds)
            torch._foreach_add_(decayed, g32)
            g32 = decayed
        lrs = [_f32(lr_value) * _f32(self._lr_mult(p)) for p in params]
        slots = self._param_state(params[0]).keys()
        states = {k: [self._param_state(p)[k] for p in params]
                  for k in slots}
        return self._update(p32, g32, states, lrs, int(t), wds)

    def _commit(self, params, new_states):
        for k, vals in new_states.items():
            for p, v in zip(params, vals):
                self._state[id(p)][k] = v

    # -- step ----------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        params = [p for p in self._parameter_list or []
                  if getattr(p, "trainable", p.requires_grad)
                  and p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip._apply(grads)
        self._step_count += 1
        new_p, new_s = self._apply(params, grads, params, self.get_lr(),
                                   self._step_count)
        torch._foreach_copy_([p.data for p in params], new_p)
        self._commit(params, new_s)

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or []:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad = torch.zeros_like(p.grad)
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if loss.grad_fn is not None and all(
                p.grad is None for p in self._parameter_list):
            loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    # -- checkpoints ---------------------------------------------------------
    def state_dict(self):
        """{f"{param.name}_{slot}": f32 tensor, "global_step": int,
        "LR_Scheduler": the scheduler's state (when there is one)}."""
        sd = {}
        for p in self._parameter_list or []:
            for k, v in (self._state.get(id(p)) or {}).items():
                sd[f"{p.name}_{k}"] = v
        sd["global_step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for p in self._parameter_list or []:
            st = self._param_state(p)
            for k in list(st):
                key = f"{p.name}_{k}"
                if key in state_dict:
                    v = torch.as_tensor(np.asarray(state_dict[key])) \
                        if not isinstance(state_dict[key], torch.Tensor) \
                        else state_dict[key]
                    st[k] = torch.empty_like(st[k]).copy_(v)

    set_dict = set_state_dict


def _bias_corr(beta, t) -> float:
    """1 - beta^t in float32, as the reference computes it."""
    return float(_f32(1.0) - np.power(_f32(beta), _f32(t)))


def _descend(p, step, lr):
    """p - lr * step for each tensor, as (-lr) * step + p (the same
    floats) in one fresh list."""
    out = _scaled(step, [-a for a in lr])
    torch._foreach_add_(out, p)
    return out


class SGD(Optimizer):
    def _update(self, p, g, state, lr, t, wd):
        return _descend(p, g, lr), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, param):
        return {"velocity": self._zeros(param)}

    def _update(self, p, g, state, lr, t, wd):
        v = torch._foreach_mul(state["velocity"], self._momentum)
        torch._foreach_add_(v, g)
        step = (torch._foreach_add(g, torch._foreach_mul(v, self._momentum))
                if self._nesterov else v)
        return _descend(p, step, lr), {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, name=None,
                 multi_precision=False, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, param):
        return {"moment1": self._zeros(param), "moment2": self._zeros(param)}

    def _moments(self, g, state, t):
        """(m, v, m-hat, v-hat) of the Adam family."""
        b1, b2 = self._beta1, self._beta2
        m = torch._foreach_mul(state["moment1"], b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_mul(state["moment2"], b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        mhat = torch._foreach_div(m, _bias_corr(b1, t))
        vhat = torch._foreach_div(v, _bias_corr(b2, t))
        return m, v, mhat, vhat

    def _update(self, p, g, state, lr, t, wd):
        m, v, mhat, vhat = self._moments(g, state, t)
        den = torch._foreach_add(torch._foreach_sqrt(vhat), self._eps)
        upd = torch._foreach_div(_scaled(mhat, lr), den)
        return torch._foreach_sub(p, upd), {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Decoupled weight decay: p - lr * wd * p after Adam's step, skipped
    for the parameters `apply_decay_param_fun(name)` refuses."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, apply_decay_param_fun=None,
                 name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, name)
        self._wd = weight_decay if isinstance(weight_decay, float) else 0.01
        self._decay_fn = apply_decay_param_fun

    def _decay_coef(self, param):
        if self._decay_fn is not None and not self._decay_fn(param.name):
            return 0.0
        return self._wd

    def _update(self, p, g, state, lr, t, wd):
        new_p, new_s = super()._update(p, g, state, lr, t, wd)
        torch._foreach_sub_(new_p, _scaled(p, [_f32(a) * _f32(w)
                                               for a, w in zip(lr, wd)]))
        return new_p, new_s


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, param):
        return {"moment": self._zeros(param), "inf_norm": self._zeros(param)}

    def _update(self, p, g, state, lr, t, wd):
        b1 = self._beta1
        m = torch._foreach_mul(state["moment"], b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        u = torch._foreach_maximum(
            torch._foreach_mul(state["inf_norm"], self._beta2),
            torch._foreach_abs(g))
        corr = _bias_corr(b1, t)
        upd = torch._foreach_div(
            _scaled(m, [_f32(a) / _f32(corr) for a in lr]),
            torch._foreach_add(u, self._eps))
        return torch._foreach_sub(p, upd), {"moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, param):
        return {"moment": self._zeros(param, self._init_acc)}

    def _update(self, p, g, state, lr, t, wd):
        acc = torch._foreach_add(state["moment"], torch._foreach_mul(g, g))
        upd = torch._foreach_div(_scaled(g, lr), torch._foreach_add(
            torch._foreach_sqrt(acc), self._eps))
        return torch._foreach_sub(p, upd), {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, param):
        return {"avg_squared_grad": self._zeros(param),
                "avg_squared_update": self._zeros(param)}

    def _update(self, p, g, state, lr, t, wd):
        rho, eps = self._rho, self._eps
        ag = torch._foreach_mul(state["avg_squared_grad"], rho)
        torch._foreach_add_(ag, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - rho))
        upd = torch._foreach_div(
            torch._foreach_mul(g, torch._foreach_sqrt(torch._foreach_add(
                state["avg_squared_update"], eps))),
            torch._foreach_sqrt(torch._foreach_add(ag, eps)))
        au = torch._foreach_mul(state["avg_squared_update"], rho)
        torch._foreach_add_(au, torch._foreach_mul(
            torch._foreach_mul(upd, upd), 1 - rho))
        return (torch._foreach_sub(p, _scaled(upd, lr)),
                {"avg_squared_grad": ag, "avg_squared_update": au})


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, param):
        return {"mean_square": self._zeros(param),
                "mean_grad": self._zeros(param),
                "momentum": self._zeros(param)}

    def _update(self, p, g, state, lr, t, wd):
        rho, eps = self._rho, self._eps
        ms = torch._foreach_mul(state["mean_square"], rho)
        torch._foreach_add_(ms, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - rho))
        mg = state["mean_grad"]
        if self._centered:
            mg = torch._foreach_mul(mg, rho)
            torch._foreach_add_(mg, torch._foreach_mul(g, 1 - rho))
            denom = torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_sub(ms, torch._foreach_mul(mg, mg)), eps))
        else:
            denom = torch._foreach_sqrt(torch._foreach_add(ms, eps))
        mom = torch._foreach_mul(state["momentum"], self._momentum)
        torch._foreach_add_(mom, torch._foreach_div(_scaled(g, lr), denom))
        return (torch._foreach_sub(p, mom),
                {"mean_square": ms, "mean_grad": mg, "momentum": mom})


class Lamb(Adam):
    """Layer-adaptive large-batch optimizer: Adam's direction plus decay,
    scaled by the trust ratio ||p|| / ||r|| of each tensor."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, name=name)
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_coef(self, param):
        if self._exclude_fn is not None and self._exclude_fn(param.name):
            return 0.0
        return self._lamb_wd

    def _update(self, p, g, state, lr, t, wd):
        m, v, mhat, vhat = self._moments(g, state, t)
        r = torch._foreach_div(mhat, torch._foreach_add(
            torch._foreach_sqrt(vhat), self._eps))
        r = torch._foreach_add(r, _scaled(p, wd))
        new_p = []
        for pi, ri, a in zip(p, r, lr):
            w_norm, r_norm = torch.linalg.norm(pi), torch.linalg.norm(ri)
            trust = torch.where((w_norm > 0) & (r_norm > 0),
                                w_norm / r_norm, torch.ones_like(w_norm))
            new_p.append(pi - (a * trust) * ri)
        return new_p, {"moment1": m, "moment2": v}
