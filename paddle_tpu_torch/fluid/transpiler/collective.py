"""Collective transpilers: rewrite a one-rank train program into the
per-rank program of collective data parallelism (counterpart of
paddle_tpu/fluid/transpiler/collective.py).

They write the reference's ops, attributes and order, so a transpiled
Program's JSON is the reference's: `c_comm_init_all` a ring in the
startup program, and before the first optimize op, for each gradient a
`scale` by 1/(the data axis's size) (`divide_by_axis_size`) and a
`c_allreduce_sum` on the calculation stream.  The port's Executor runs
that program in every rank on the rank's own batch; the rules call
`torch.distributed` on the data axis's group (ops/collective_ops.py).
FP16AllReduce casts each gradient to a half type around its all-reduce
(bf16 by default); LocalSGD averages the parameters every k steps.
"""

from __future__ import annotations

from ..framework import OpRole


class Collective:
    def __init__(self, nrings=1):
        self.nrings = nrings
        self.nranks = 1

    def transpile(self, startup_program, main_program, rank, endpoints,
                  current_endpoint, wait_port=True):
        self.nranks = len(endpoints) if endpoints else 1
        self.rank = rank
        self.startup_program = startup_program
        self.main_program = main_program
        self._transpile_startup_program()
        self._transpile_main_program()
        return main_program

    def _transpile_startup_program(self):
        # the communicator comes up with the process group; the op checks
        # that the mesh names its ring
        block = self.startup_program.global_block()
        for ring_id in range(self.nrings):
            block.append_op("c_comm_init_all", attrs={"ring_id": ring_id},
                            infer_shape=False)

    def _transpile_main_program(self):
        raise NotImplementedError


class GradAllReduce(Collective):
    """Insert grad allreduce after the backward section."""

    def __init__(self, nrings=1, scale_gradient=True):
        super().__init__(nrings)
        self.scale_gradient = scale_gradient

    def _mk_op(self, block, type_, ins, outs, attrs):
        from ..framework import Operator

        return Operator(block, self.main_program._next_op_id(), type_,
                        ins, outs, dict(attrs, op_role=OpRole.Backward))

    def _comm_ops_for_grad(self, block, g, ring):
        """Build the comm ops for one gradient var (hook point:
        FP16AllReduce wraps the allreduce in casts)."""
        return [self._mk_op(
            block, "c_allreduce_sum", {"X": [g]}, {"Out": [g]},
            {"ring_id": ring % self.nrings, "use_calc_stream": True})]

    def _transpile_main_program(self):
        block = self.main_program.global_block()
        # find grad vars produced by backward ops that feed optimizer ops
        grad_names = set()
        for op in block.ops:
            if op.attr("op_role", 0) == OpRole.Optimize:
                for n in op.input("Grad"):
                    grad_names.add(n)
        if not grad_names:
            return
        # insert scale + allreduce right before the first optimize op
        first_opt = next(i for i, op in enumerate(block.ops)
                         if op.attr("op_role", 0) == OpRole.Optimize)
        new_ops = []
        ring = 0
        for g in sorted(grad_names):
            if self.scale_gradient:
                # scale by the data axis's size at run time
                # (divide_by_axis_size), as the reference does
                new_ops.append(self._mk_op(
                    block, "scale", {"X": [g]}, {"Out": [g]},
                    {"scale": 1.0, "bias": 0.0, "bias_after_scale": True,
                     "divide_by_axis_size": "data"}))
            new_ops.extend(self._comm_ops_for_grad(block, g, ring))
            ring += 1
        block.ops[first_opt:first_opt] = new_ops
        self.main_program._bump_version()


class FP16AllReduce(GradAllReduce):
    """Communicate gradients in half precision: cast each grad to
    fp16/bf16 before c_allreduce_sum and back after; bf16 (the
    reference's default) halves the bytes with f32's exponent range."""

    def __init__(self, nrings=1, scale_gradient=True, wire_dtype="bfloat16"):
        super().__init__(nrings, scale_gradient)
        self.wire_dtype = wire_dtype

    def _comm_ops_for_grad(self, block, g, ring):
        gv = block.var(g)
        half = block.create_var(dtype=self.wire_dtype, shape=gv.shape)
        return [
            self._mk_op(block, "cast", {"X": [g]}, {"Out": [half.name]},
                        {"in_dtype": gv.dtype,
                         "out_dtype": self.wire_dtype}),
            self._mk_op(block, "c_allreduce_sum", {"X": [half.name]},
                        {"Out": [half.name]},
                        {"ring_id": ring % self.nrings,
                         "use_calc_stream": True}),
            self._mk_op(block, "cast", {"X": [half.name]}, {"Out": [g]},
                        {"in_dtype": self.wire_dtype,
                         "out_dtype": gv.dtype}),
        ]


class LocalSGD(Collective):
    """Periodically average params instead of grads (every k steps)."""

    def __init__(self, nrings=1, k_steps=1):
        super().__init__(nrings)
        self.k_steps = k_steps

    def _transpile_main_program(self):
        from ..layers import tensor as tl
        from .. import framework as fw

        main = self.main_program
        block = main.global_block()
        params = [p.name for p in main.all_parameters() if p.trainable]
        if not params:
            return
        with fw.program_guard(main, self.startup_program):
            step = tl.create_global_var([1], 0.0, "float32", persistable=True,
                                        name="@LOCALSGD_STEP@")
            tl.increment(step, 1.0)
            # every k steps: p <- sum(p)/nranks via allreduce, selected by
            # mask
            from ..layers import nn

            kvar = tl.fill_constant([1], "float32", float(self.k_steps))
            rem = nn.elementwise_sub(
                step, nn.elementwise_mul(
                    nn.floor(nn.elementwise_div(step, kvar)), kvar))
            mask = tl.cast(nn.less_than(rem, tl.fill_constant(
                [1], "float32", 0.5)), "float32")
            for p in params:
                pvar = block.var(p)
                # divide by the data axis's size at run time, as
                # GradAllReduce does
                avg = block.create_var(dtype=pvar.dtype, shape=pvar.shape)
                block.append_op("scale", inputs={"X": [pvar]},
                                outputs={"Out": [avg]},
                                attrs={"scale": 1.0, "bias": 0.0,
                                       "bias_after_scale": True,
                                       "divide_by_axis_size": "data"},
                                infer_shape=False)
                block.append_op("c_allreduce_sum", inputs={"X": [avg]},
                                outputs={"Out": [avg]},
                                attrs={"ring_id": 0}, infer_shape=False)
                mixed = nn.elementwise_add(
                    nn.elementwise_mul(avg, mask),
                    nn.elementwise_mul(pvar, nn.scale(mask, -1.0, 1.0)))
                block.append_op("assign", inputs={"X": [mixed]},
                                outputs={"Out": [pvar]}, infer_shape=False)
