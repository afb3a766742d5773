"""Learning-rate schedules as ops of the program (counterpart of
paddle_tpu/fluid/layers/learning_rate_scheduler.py): noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay and linear_lr_warmup.
Each returns an lr Variable computed from a persistable float32 step
counter, `@LR_DECAY_COUNTER@`, that an `increment` op at the top of the
main block raises by 1 at every run: the first run reads step 1.
"""

from __future__ import annotations

import math

from ..framework import default_main_program

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"]


def _global_step():
    """Create (once per program) a persistable step counter incremented at
    the top of the main block."""
    from .tensor import create_global_var, increment

    prog = default_main_program()
    name = "@LR_DECAY_COUNTER@"
    block = prog.global_block()
    if block.has_var(name):
        return block.var(name)
    counter = create_global_var(shape=[1], value=0.0, dtype="float32",
                                persistable=True, name=name)
    block._prepend_op("increment", inputs={"X": [counter]},
                      outputs={"Out": [counter]}, attrs={"step": 1.0},
                      infer_shape=False)
    return counter


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    from .nn import elementwise_min, pow as pow_layer, rsqrt, scale
    from .tensor import fill_constant

    step = _global_step()
    a = pow_layer(step, -0.5)
    b = step * (warmup_steps ** -1.5)
    lr = elementwise_min(a, b) * (d_model ** -0.5) * learning_rate
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from .nn import floor, pow as pow_layer

    step = _global_step()
    div = step * (1.0 / decay_steps)
    if staircase:
        div = floor(div)
    from .tensor import fill_constant

    base = fill_constant([1], "float32", decay_rate)
    return (base ** div) * learning_rate


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    from .nn import exp, floor

    step = _global_step()
    div = step * (1.0 / decay_steps)
    if staircase:
        div = floor(div)
    return exp(div * (-decay_rate)) * learning_rate


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    from .nn import floor

    step = _global_step()
    div = step * (1.0 / decay_steps)
    if staircase:
        div = floor(div)
    denom = div * decay_rate + 1.0
    from .tensor import fill_constant

    one = fill_constant([1], "float32", learning_rate)
    return one / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from .nn import elementwise_min, pow as pow_layer
    from .tensor import fill_constant

    step = _global_step()
    cap = fill_constant([1], "float32", float(decay_steps))
    s = elementwise_min(step, cap)
    frac = (cap - s) * (1.0 / decay_steps)
    return (learning_rate - end_learning_rate) * (frac ** power) \
        + end_learning_rate


def piecewise_decay(boundaries, values):
    """Sum of masked constants: lr = Σ values[i]·1[b_{i-1} ≤ step < b_i]."""
    from .nn import less_than, logical_and, logical_not
    from .tensor import cast, fill_constant

    step = _global_step()
    lr = fill_constant([1], "float32", 0.0)
    prev_mask = None
    for i, v in enumerate(values):
        if i < len(boundaries):
            b = fill_constant([1], "float32", float(boundaries[i]))
            below = cast(less_than(step, b), "float32")
        else:
            below = fill_constant([1], "float32", 1.0)
        if prev_mask is None:
            seg = below
        else:
            seg = below - prev_mask
        lr = lr + seg * v
        prev_mask = below
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    from .nn import cos, floor

    step = _global_step()
    epoch = floor(step * (1.0 / step_each_epoch))
    return 0.5 * learning_rate * (cos(epoch * (math.pi / epochs)) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from .nn import less_than
    from .tensor import cast, fill_constant

    step = _global_step()
    w = fill_constant([1], "float32", float(warmup_steps))
    in_warmup = cast(less_than(step, w), "float32")
    warm = start_lr + (end_lr - start_lr) * (step * (1.0 / warmup_steps))
    if isinstance(learning_rate, float):
        learning_rate = fill_constant([1], "float32", learning_rate)
    return warm * in_warmup + learning_rate * (1.0 - in_warmup)
