"""The functional surface BERT needs (counterpart of
paddle_tpu/nn/functional/__init__.py).

Plain tensor functions in PyTorch's idiom.  `linear` keeps Paddle's
layout: weight is (in, out) and y = x @ W + b.  The two seams that reach
hand-written kernels are `scaled_dot_product_attention` (flash forward
and backward) and `fused_feedforward` (fused FFN forward and backward);
both are differentiable.

Randomness (counterpart of `rng_key_scope`,
paddle_tpu/fluid/dygraph/tracer.py:91).  Layers hold the host (CPU)
generator they were initialized from.  Inside `rng_scope(seed)` every
draw comes from one host generator seeded with `seed` instead, so a train
step is deterministic in its seed.  Element dropout draws its mask on the
tensor's own device, from a device generator seeded by a host draw; the
seeds of the in-kernel dropout hashes are host integers from the host
generator.  Neither ever reads a device tensor back, so no draw costs a
host sync.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

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


_RNG = threading.local()


@contextlib.contextmanager
def rng_scope(seed: int):
    """Draw every dropout mask and kernel seed of this thread from one
    host generator seeded with `seed` (the port's `rng_key_scope`)."""
    old = getattr(_RNG, "host", None)
    _RNG.host = torch.Generator().manual_seed(int(seed))
    try:
        yield
    finally:
        _RNG.host = old


def _host_generator(generator: Optional[torch.Generator]):
    """The scope's host generator, else the layer's own (None = torch's
    default CPU generator)."""
    scoped = getattr(_RNG, "host", None)
    return scoped if scoped is not None else generator


def _device_generator(host: torch.Generator,
                      device: torch.device) -> torch.Generator:
    """A generator on `device`, seeded by a draw from the host
    generator."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=host))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x, p=0.5, training=True, generator=None):
    """upscale_in_train dropout: the identity in eval or at p == 0.  The
    mask is drawn on x's device: from `generator` when it lives there
    (None: torch's default generator of that device), else from a device
    generator seeded by a host draw."""
    if not training or p == 0.0:
        return x
    gen = _host_generator(generator)
    if gen is not None and gen.device != x.device:
        gen = _device_generator(gen, x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _kernel_seed(generator=None) -> int:
    """A 31-bit seed for an in-kernel dropout hash: a host integer drawn
    from the scope's or the layer's host generator (never a device
    tensor, so no host sync)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=_host_generator(generator)))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Fused attention over (batch, seq, heads, head_dim) inputs: the
    flash kernels (forward and backward) on CUDA tensors, their plain
    versions on CPU tensors.  Attention dropout runs in the kernels,
    seeded from the host generator."""
    p = dropout_p if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _attn.scaled_dot_product_attention(
        query, key, value, mask=attn_mask, is_causal=is_causal,
        dropout_p=p, dropout_seed=seed)


def fused_feedforward(x, w1, b1, w2, b2, activation="gelu",
                      act_dropout=0.0, training=True, generator=None):
    """Fused transformer FFN: dropout(act(x@w1+b1), p) @ w2 + b2, with the
    d_ff activation kept on chip by the kernels (forward and backward) on
    CUDA tensors; differentiable in x and the four weights."""
    p = act_dropout if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _ffn.fused_ffn(x, w1, b1, w2, b2, activation=activation,
                          dropout_p=p, dropout_seed=seed)
