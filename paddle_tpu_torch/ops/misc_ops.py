"""Rules of the misc bucket (counterpart of paddle_tpu/ops/misc_ops.py).
So far `bilinear_tensor_product`, which `nn.BilinearTensorProduct`
and the 1.x layer of the same name reach."""

from __future__ import annotations

import torch

from .registry import first, register_op


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, op, ins):
    """misc_ops.py:180-191: out[:, k] = x W[k] y^T + bias[k], for X (B,
    M), Y (B, N) and Weight (K, M, N)."""
    x, y, w = first(ins, "X"), first(ins, "Y"), first(ins, "Weight")
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    bias = first(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": [out]}
