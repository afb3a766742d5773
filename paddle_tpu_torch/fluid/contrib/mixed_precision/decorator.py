"""OptimizerWithMixedPrecision, the static-graph AMP decorator (a copy
of paddle_tpu/fluid/contrib/mixed_precision/decorator.py): it rewrites the
forward program with casts (`rewrite_program`), scales the loss, and in
float16 wraps the update in check_finite_and_unscale and
update_loss_scaling, with the optimizer's ops in a `conditional_block`
that runs only when no gradient overflowed.

dtype="bfloat16" (the reference's default) skips loss scaling: bfloat16
has float32's exponent range.  On the card the skipped update reads its
condition once a step, the one host read of such a step.
"""

from __future__ import annotations

from ... import unique_name
from ...framework import OpRole, default_startup_program, program_guard
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=32768.0,
                 use_dynamic_loss_scaling=True, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
                 dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dtype = dtype
        self._use_loss_scaling = (dtype == "float16")
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        from ...layers import nn, tensor

        main = loss.block.program
        rewrite_program(main, self._amp_lists, self._dtype)
        with program_guard(main, startup_program
                           or default_startup_program()):
            if self._use_loss_scaling:
                self._loss_scaling = tensor.create_global_var(
                    [1], self._init_loss_scaling, "float32",
                    persistable=True,
                    name=unique_name.generate("loss_scaling"))
                self._good_steps = tensor.create_global_var(
                    [1], 0, "int32", persistable=True,
                    name=unique_name.generate("good_steps"))
                self._bad_steps = tensor.create_global_var(
                    [1], 0, "int32", persistable=True,
                    name=unique_name.generate("bad_steps"))
                scaled_loss = nn.elementwise_mul(loss, self._loss_scaling)
            else:
                scaled_loss = loss
            params_grads = self._optimizer.backward(
                scaled_loss, startup_program, parameter_list, no_grad_set,
                callbacks)
        self._scaled_loss = scaled_loss
        return params_grads

    def apply_gradients(self, params_grads):
        if not self._use_loss_scaling:
            return self._optimizer.apply_gradients(params_grads)
        from ...framework import EMPTY_VAR_NAME, default_main_program
        from ...layer_helper import LayerHelper
        from ...layers import nn

        helper = LayerHelper("amp_check_finite")
        grads = [g for _, g in params_grads]
        found_inf = helper.create_variable_for_type_inference(
            dtype="bool", stop_gradient=True)
        helper.append_op(
            "check_finite_and_unscale",
            inputs={"X": grads, "Scale": [self._loss_scaling]},
            outputs={"Out": grads, "FoundInfinite": [found_inf]},
            attrs={"op_role": OpRole.Backward}, infer_shape=False)
        if self._use_dynamic_loss_scaling:
            helper.append_op(
                "update_loss_scaling",
                inputs={"X": grads, "FoundInfinite": [found_inf],
                        "PrevLossScaling": [self._loss_scaling],
                        "InGoodSteps": [self._good_steps],
                        "InBadSteps": [self._bad_steps]},
                outputs={"Out": grads,
                         "LossScaling": [self._loss_scaling],
                         "OutGoodSteps": [self._good_steps],
                         "OutBadSteps": [self._bad_steps]},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf":
                           self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio,
                       "op_role": OpRole.Backward},
                infer_shape=False)
        # an overflow step skips the update entirely (zeroed grads would
        # still advance Adam's moments and powers), so the optimizer ops
        # live in a conditional sub-block on ~found_inf
        ok = nn.logical_not(found_inf)
        # the unscaled gradients are clipped and regularized as the
        # optimizer's own apply_gradients would (the reference's decorator
        # appends the bare update ops, ROADMAP queue 3 item 25)
        params_grads = self._optimizer._clip_and_regularize(params_grads)
        main = default_main_program()
        block = main.global_block()
        sub = main._create_block()
        for pg in params_grads:
            self._optimizer._append_optimize_op(sub, pg)
        main._rollback()
        from ...framework import block_io

        reads, writes = block_io(sub)
        outer_reads = sorted(n for n in reads if block.has_var_recursive(n))
        outer_writes = sorted(n for n in writes
                              if block.has_var_recursive(n))
        block.append_op(
            "conditional_block",
            inputs={"Cond": [ok], "Input": outer_reads},
            outputs={"Out": outer_writes, "Scope": [EMPTY_VAR_NAME]},
            attrs={"sub_block": sub.idx, "is_scalar_condition": True,
                   "op_role": OpRole.Optimize},
            infer_shape=False)
        return []

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        self._optimizer._startup_program = startup_program
        with program_guard(loss.block.program, startup_program
                           or default_startup_program()):
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=32768.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5,
             use_dynamic_loss_scaling=True, dtype="bfloat16"):
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dtype=dtype)
