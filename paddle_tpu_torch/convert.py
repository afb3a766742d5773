"""Carry a paddle_tpu model's weights over to its port.

`load_jax_state(module, state)` takes the dict that
`paddle_tpu.jit.functional_state(model)` yields, as numpy arrays (keys
like `bert.encoder.layers.0.self_attn.q_proj.weight` or, for a buffer,
`layer1.0.bn1._mean`), and fills the port's parameters and buffers in
place, so both packages compute the same function.
Both keep Paddle's (in, out) Linear layout, so names and shapes match one
to one and nothing is transposed.  Tied parameters (BERT's MLM decoder
weight is the word-embedding table) appear once in the JAX dict and once
in `named_parameters()`; filling that one entry keeps the tie.

`load_jax_train_state(module, jax_state)` carries a train state over: the
{"params", "m", "v", "t"} of paddle_tpu's `build_pretrain_step` (or of
the WMT `build_train_step`), as numpy, becomes the state of the port's
step, so a JAX run can continue in the port.

`load_jax_scope(scope, arrays)` does the same for the static graph: the
persistable values of a paddle_tpu `fluid.Scope` (numpy, by variable name)
replace those of a port `fluid.Scope` that the port's own startup program
has filled, so the same Program continues in the port's Executor.

Sharded state (the compiler's SPMD arm, the tensor-parallel BERT step)
crosses in both directions: `shard_jax_array(a, spec, mesh)` is this
rank's shard of one of the reference's full arrays under a
PartitionSpec, `load_jax_scope_sharded` fills a scope the SPMD arm has
sharded, and `gather_shards` / `gather_sharded_scope` give the full
arrays back, through an all-gather over the spec's axes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .jit import functional_state


def _check(params: Dict[str, torch.Tensor], state: Dict[str, np.ndarray],
           strict: bool, what: str = "state") -> None:
    """KeyError on missing or (with strict) unexpected keys, ValueError on
    a shape mismatch."""
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing:
        raise KeyError(f"missing keys in {what}: {missing}")
    if strict and unexpected:
        raise KeyError(f"unexpected keys in {what}: {unexpected}")
    for name, p in params.items():
        shape = tuple(np.shape(state[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: {what} has shape {shape}, parameter "
                             f"has {tuple(p.shape)}")


def load_jax_state(module: nn.Module, state: Dict[str, np.ndarray],
                   strict: bool = True) -> nn.Module:
    """Copy `state` into `module`'s parameters and buffers (BN's `_mean`
    and `_variance`), each cast to its tensor's dtype and device.  Raises
    KeyError on missing or (with strict) unexpected keys and ValueError
    on a shape mismatch; nothing is written unless every check passes."""
    tensors = functional_state(module)  # detached, sharing storage
    _check(tensors, state, strict)
    with torch.no_grad():
        for name, t in tensors.items():
            t.copy_(torch.from_numpy(np.array(state[name])))
    return module


def load_jax_train_state(module: nn.Module, jax_state) -> dict:
    """The port's train state from paddle_tpu's: `jax_state` is the
    {"params", "m", "v", "t"} of its `build_pretrain_step` or of the WMT
    `build_train_step` (numpy arrays).  Returns {"params", "m", "v": f32
    tensors on the module's device, by name; "t": host int}, the state the
    port's step_fn takes.  The names are those of `functional_state`:
    every parameter and buffer (the WMT step's state holds, and trains,
    its two position tables `src_pos.pe` and `tgt_pos.pe`).  Each of
    params, m and v is checked against them as `load_jax_state` checks
    (all keys, no extra ones, shapes); nothing is built unless every
    check passes.  The module's own weights are not touched."""
    params = functional_state(module)
    missing = sorted({"params", "m", "v", "t"} - set(jax_state))
    if missing:
        raise KeyError(f"missing keys in train state: {missing}")
    for part in ("params", "m", "v"):
        _check(params, jax_state[part], True, f"train state[{part!r}]")
    device = next(iter(module.parameters())).device
    out = {part: {name: torch.tensor(np.asarray(jax_state[part][name]),
                                     dtype=torch.float32, device=device)
                  for name in params}
           for part in ("params", "m", "v")}
    out["t"] = int(np.asarray(jax_state["t"]))
    return out


def load_jax_scope(scope, arrays: Dict[str, np.ndarray]):
    """Replace the values of a port `fluid.Scope` by a paddle_tpu scope's
    persistable values: `arrays` maps each variable name to its value as
    numpy (`np.asarray(jax_scope.get(name))` for every name of the
    reference's scope).  The port's scope must hold the same names, as its
    own startup program leaves them.  Raises KeyError when a name is on
    one side only and ValueError on a shape or dtype mismatch; nothing is
    written unless every check passes.  Each value keeps the port tensor's
    dtype and device.  Returns the scope."""
    # the reference runs with 64-bit types off: a 64-bit var's value is
    # its 32-bit twin there
    from .ops.registry import canon_dtype
    have = {n: scope.get(n) for n in scope.local_var_names()
            if scope.get(n) is not None}
    missing = sorted(set(have) - set(arrays))
    unexpected = sorted(set(arrays) - set(have))
    if missing or unexpected:
        raise KeyError(f"scope names differ: missing from the arrays "
                       f"{missing}, not in the port's scope {unexpected}")
    for name, t in have.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: arrays hold shape {tuple(a.shape)}, "
                             f"the port's scope {tuple(t.shape)}")
        if canon_dtype(a.dtype) != canon_dtype(t.dtype):
            raise ValueError(f"{name}: arrays hold {a.dtype}, the port's "
                             f"scope {t.dtype}")
    for name, t in have.items():
        scope.set(name, torch.from_numpy(np.array(arrays[name])).to(
            device=t.device, dtype=t.dtype))
    return scope


def shard_jax_array(a, spec, mesh) -> torch.Tensor:
    """This rank's shard (a CPU tensor) of the full array `a` laid out by
    `spec` over `mesh` (parallel/spec_layout.py): each dim cut into the
    product of its entry's axes, as the SPMD arm cuts the scope."""
    from .parallel.compiler import shard_of

    return shard_of(torch.from_numpy(np.array(a)), spec, mesh)


def gather_shards(t: torch.Tensor, spec, mesh) -> np.ndarray:
    """The full array, as numpy, from every rank's shard `t` laid out by
    `spec` (an all-gather over each sharded axis: every rank calls it)."""
    from .parallel.compiler import gather_full

    return gather_full(t, spec, mesh).detach().cpu().numpy() \
        if tuple(spec) else t.detach().cpu().numpy()


def _scope_specs(program, mesh, names):
    from .parallel import spec_layout

    block = program.global_block()
    out = {}
    for n in names:
        try:
            v = block._var_recursive(n)
        except ValueError:
            continue
        if v.shape and all(d >= 0 for d in v.shape):
            out[n] = spec_layout.spec_for(n, v.shape, mesh, var=v)
    return out


def load_jax_scope_sharded(scope, arrays: Dict[str, np.ndarray], program,
                           mesh):
    """`load_jax_scope` for a scope the SPMD arm holds in shards: each
    var whose spec over `mesh` (from `program`'s variables) is not P()
    takes this rank's shard of the reference's full array; the others
    take the whole array."""
    specs = _scope_specs(program, mesh, arrays)
    cut = {n: (shard_jax_array(a, specs[n], mesh).numpy()
               if tuple(specs.get(n, ())) else np.asarray(a))
           for n, a in arrays.items()}
    return load_jax_scope(scope, cut)


def gather_sharded_scope(scope, program, mesh) -> Dict[str, np.ndarray]:
    """Every value of the scope as a full numpy array: the shards of the
    SPMD arm's sharded vars gathered over their axes (every rank calls
    it, in the same order), the others as they are."""
    names = sorted(n for n in scope.local_var_names()
                   if scope.get(n) is not None)
    specs = _scope_specs(program, mesh, names)
    out = {}
    for n in names:
        v = scope.get(n)
        full = tuple(program.global_block()._var_recursive(n).shape) \
            if n in specs else None
        if tuple(specs.get(n, ())) and tuple(v.shape) != full:
            out[n] = gather_shards(v, specs[n], mesh)
        else:
            out[n] = v.detach().cpu().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v)
    return out
