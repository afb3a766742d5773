"""`paddle.amp`: automatic mixed precision for eager code (counterpart
of paddle_tpu/amp/__init__.py).

`auto_cast` installs a thread-local policy that the port's own
functional ops consult at their cast points (`cast_inputs`): under O1
the white-list ops (matmul_v2, conv2d, ...) take their float32 inputs
in `dtype`; under O2 every op but the black list does.  The lists are
the reference's, not torch.autocast's.  `GradScaler` is the reference's
dynamic loss-scaling state machine; `decorate` casts models for O2.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_AMP = threading.local()

WHITE_LIST = {
    "matmul", "matmul_v2", "mul", "bmm", "mv", "addmm",
    "conv2d", "conv3d", "conv2d_transpose", "depthwise_conv2d",
}
BLACK_LIST = {
    "exp", "log", "square", "reduce_sum", "reduce_mean", "mean", "sum",
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "cross_entropy2", "layer_norm", "batch_norm",
    "p_norm", "frobenius_norm", "cumsum", "logsumexp",
}

_LOW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def amp_state():
    return getattr(_AMP, "state", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """level O1: white-list ops compute in `dtype`; O2: every float op
    except the black list."""
    if not enable:
        yield
        return
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    old = amp_state()
    _AMP.state = {"level": level, "dtype": dtype, "white": white,
                  "black": black}
    try:
        yield
    finally:
        _AMP.state = old



amp_guard = auto_cast  # the fluid.dygraph name


def cast_inputs(op_type, *tensors):
    """The op's inputs under the active policy: each float32 tensor in
    the low dtype when the policy casts `op_type`, else as given."""
    state = amp_state()
    if state is None:
        return tensors
    if state["level"] == "O2":
        do = op_type not in state["black"]
    else:
        do = op_type in state["white"]
    if not do:
        return tensors
    low = _LOW[state["dtype"]]
    return tuple(t.to(low) if isinstance(t, torch.Tensor)
                 and t.dtype == torch.float32 else t for t in tensors)


def cast_inputs_if_amp(op_type, ins_vals):
    """The reference tracer's form of cast_inputs: `ins_vals` maps each
    input slot to its list of values; returns (the slots under the active
    policy, whether it cast)."""
    state = amp_state()
    if state is None or (op_type in state["black"] if state["level"] == "O2"
                         else op_type not in state["white"]):
        return ins_vals, False
    return {s: list(cast_inputs(op_type, *vs))
            for s, vs in ins_vals.items()}, True


class GradScaler:
    """Dynamic loss scaling (reference: paddle/amp/grad_scaler.py; the
    check_finite_and_unscale and update_loss_scaling ops)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        return loss * self._scale if self._enable else loss

    def unscale_(self, optimizer):
        """Divide every gradient by the scale and note whether any is
        not finite: one host sync."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        torch._foreach_div_(grads, self._scale)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self._found_inf = not bool(finite)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        return None, []

    def update(self):
        """The update_loss_scaling state machine."""
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def set_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)



def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration: cast the models' parameters to `dtype`."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        m.astype(dtype)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


AmpScaler = GradScaler  # the fluid.dygraph name
