"""Ops of the port (counterpart of paddle_tpu/ops): the op rule registry
(`registry.py`) and its rules (`math_ops`, `tensor_ops`, `nn_ops`,
`random_ops`, `optimizer_ops`), which the Fluid Executor and the 2.x
tensor API run, and the hand-written kernels (`kernels/`)."""
