"""Gradient-merge meta-optimizer: accumulate gradients over k micro-steps
and apply the inner optimizer every k-th step.  The accumulators are
persistable vars; the optimizer ops live in a conditional_block
sub-block gated on (step % k == 0)."""

from __future__ import annotations

from .meta_optimizer_base import MetaOptimizerBase


class GradientMergeOptimizer(MetaOptimizerBase):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.meta_optimizers_white_list = ["GraphExecutionOptimizer"]

    def _can_apply(self):
        return (self.user_defined_strategy.gradient_merge
                and self.user_defined_strategy
                .gradient_merge_configs.get("k_steps", 1) > 1)

    def _disable_strategy(self, dist_strategy):
        dist_strategy.gradient_merge = False

    def minimize_impl(self, loss, startup_program=None, parameter_list=None,
                      no_grad_set=None):
        from ....fluid import unique_name
        from ....fluid.framework import (EMPTY_VAR_NAME, OpRole,
                                         default_startup_program,
                                         program_guard)
        from ....fluid.layers import nn, tensor

        cfg = self.user_defined_strategy.gradient_merge_configs
        k = int(cfg.get("k_steps", 1))
        avg = cfg.get("avg", True)
        main = loss.block.program
        startup = startup_program or default_startup_program()
        self.inner_opt._startup_program = startup_program

        with program_guard(main, startup):
            params_grads = self.inner_opt.backward(
                loss, startup_program, parameter_list, no_grad_set)

            step = tensor.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate("@GRAD_MERGE_STEP@"))
            tensor.increment(step, 1.0)
            kf = tensor.fill_constant([1], "float32", float(k))
            rem = step - nn.floor(step / kf) * kf
            do_apply = nn.less_than(
                rem, tensor.fill_constant([1], "float32", 0.5))

            # accumulate grads into persistable buffers
            merged = []
            for p, g in params_grads:
                acc = tensor.create_global_var(
                    list(p.shape), 0.0, p.dtype, persistable=True,
                    name=unique_name.generate(f"{p.name}@GRAD_MERGE"))
                main.global_block().append_op(
                    "sum", inputs={"X": [acc, g]}, outputs={"Out": [acc]},
                    attrs={"op_role": OpRole.Backward}, infer_shape=False)
                merged.append((p, acc))

            # optimizer ops + buffer reset in a conditional sub-block
            block = main.global_block()
            sub = main._create_block()
            for p, acc in merged:
                if avg:
                    eff_name = unique_name.generate(f"{acc.name}@AVG")
                    sub.create_var(name=eff_name, shape=acc.shape,
                                   dtype=acc.dtype, stop_gradient=True)
                    sub.append_op("scale", inputs={"X": [acc.name]},
                                  outputs={"Out": [eff_name]},
                                  attrs={"scale": 1.0 / k, "bias": 0.0,
                                         "bias_after_scale": True,
                                         "op_role": OpRole.Optimize},
                                  infer_shape=False)
                    eff = sub.var(eff_name)
                else:
                    eff = acc
                self.inner_opt._append_optimize_op(sub, (p, eff))
                sub.append_op("fill_constant", outputs={"Out": [acc.name]},
                              attrs={"shape": list(acc.shape),
                                     "dtype": acc.dtype, "value": 0.0,
                                     "op_role": OpRole.Optimize},
                              infer_shape=False)
            main._rollback()

            from ....fluid.framework import block_io

            reads, writes = block_io(sub)
            outer_reads = sorted(n for n in reads
                                 if block.has_var_recursive(n))
            outer_writes = sorted(n for n in writes
                                  if block.has_var_recursive(n))
            block.append_op(
                "conditional_block",
                inputs={"Cond": [do_apply], "Input": outer_reads},
                outputs={"Out": outer_writes, "Scope": [EMPTY_VAR_NAME]},
                attrs={"sub_block": sub.idx, "is_scalar_condition": True,
                       "op_role": OpRole.Optimize},
                infer_shape=False)
        return [], params_grads
