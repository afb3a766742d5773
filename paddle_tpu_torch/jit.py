"""Functional use of a module's parameters (counterpart of
paddle_tpu/jit/__init__.py's `functional_state` and `functional_call`).

PyTorch runs eagerly, so nothing here compiles: these two functions let a
train step keep its own copy of the parameters (fp32 masters, a bf16
cast of them) and run the module on it, as the JAX package's jitted step
does with its state pytree.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn


def functional_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every parameter and buffer, detached from
    autograd (sharing storage with the module).  A tied parameter appears
    once, under its first name (BERT's MLM decoder weight is listed as
    `bert.embeddings.word_embeddings.weight`)."""
    state = {name: p.detach() for name, p in module.named_parameters()}
    seen = {id(p) for p in module.parameters()}
    for name, b in module.named_buffers():
        if id(b) not in seen:
            seen.add(id(b))
            state[name] = b.detach()
    return state


def functional_call(module: nn.Module, state: Dict[str, torch.Tensor],
                    *args, **kwargs) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Run `module(*args, **kwargs)` with its parameters and buffers taken
    from `state` (torch.func.functional_call; ties kept, so a tied weight
    given once under its first name feeds every use).  Returns (outputs,
    state), the JAX package's contract; a buffer updated in place by the
    call is updated in `state`."""
    out = torch.func.functional_call(module, state, args, kwargs,
                                     tie_weights=True, strict=False)
    return out, state
