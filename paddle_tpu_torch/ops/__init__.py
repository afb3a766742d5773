"""Kernels of the port (ops/kernels) — counterparts of paddle_tpu/ops."""
