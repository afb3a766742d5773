"""The functional surface BERT needs (counterpart of
paddle_tpu/nn/functional/__init__.py).

Plain tensor functions in PyTorch's idiom.  `linear` keeps Paddle's
layout: weight is (in, out) and y = x @ W + b.  The two seams that reach
hand-written kernels are `scaled_dot_product_attention` (flash forward)
and `fused_feedforward` (fused FFN forward).
"""

from __future__ import annotations

import torch

from ..ops.kernels import attention as _attn
from ..ops.kernels import ffn as _ffn


def linear(x, weight, bias=None):
    """y = x @ weight + bias with weight (in_features, out_features)."""
    out = torch.matmul(x, weight)
    return out + bias if bias is not None else out


def embedding(x, weight):
    """Rows of `weight` at the ids `x`."""
    return torch.nn.functional.embedding(x, weight)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Paddle's layer_norm: biased variance, (x - mean) * rsqrt(var + eps),
    over the trailing `normalized_shape` dims, in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def gelu(x, approximate=False):
    """Exact-erf gelu (jax.nn.gelu(approximate=False)), or the tanh form."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def dropout(x, p=0.5, training=True, generator=None):
    """upscale_in_train dropout: the identity in eval or at p == 0."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _kernel_seed(generator=None) -> int:
    """A 31-bit seed for an in-kernel dropout hash, drawn from
    `generator` (or torch's default CPU generator)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Fused attention over (batch, seq, heads, head_dim) inputs: the
    flash kernel on CUDA tensors, its plain version on CPU tensors.
    Attention dropout runs in the kernel, seeded from `generator`."""
    p = dropout_p if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _attn.scaled_dot_product_attention(
        query, key, value, mask=attn_mask, is_causal=is_causal,
        dropout_p=p, dropout_seed=seed)


def fused_feedforward(x, w1, b1, w2, b2, activation="gelu",
                      act_dropout=0.0, training=True, generator=None):
    """Fused transformer FFN: dropout(act(x@w1+b1), p) @ w2 + b2, with the
    d_ff activation kept on chip by the kernel on CUDA tensors."""
    p = act_dropout if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _ffn.fused_ffn(x, w1, b1, w2, b2, activation=activation,
                          dropout_p=p, dropout_seed=seed)
