"""Carry a paddle_tpu model's weights over to its port.

`load_jax_state(module, state)` takes the dict that
`paddle_tpu.jit.functional_state(model)` yields, as numpy arrays (keys
like `bert.encoder.layers.0.self_attn.q_proj.weight`), and fills the
port's parameters in place, so both packages compute the same function.
Both keep Paddle's (in, out) Linear layout, so names and shapes match one
to one and nothing is transposed.  Tied parameters (BERT's MLM decoder
weight is the word-embedding table) appear once in the JAX dict and once
in `named_parameters()`; filling that one entry keeps the tie.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_jax_state(module: nn.Module, state: Dict[str, np.ndarray],
                   strict: bool = True) -> nn.Module:
    """Copy `state` into `module`'s parameters (cast to each parameter's
    dtype and device).  Raises KeyError on missing or (with strict)
    unexpected keys and ValueError on a shape mismatch; nothing is
    written unless every check passes."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing:
        raise KeyError(f"missing keys in state: {missing}")
    if strict and unexpected:
        raise KeyError(f"unexpected keys in state: {unexpected}")
    for name, p in params.items():
        shape = tuple(np.shape(state[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: state has shape {shape}, parameter "
                             f"has {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(state[name])))
    return module
