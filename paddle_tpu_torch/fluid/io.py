"""Checkpoint and inference-model save and load (counterpart of
paddle_tpu/fluid/io.py:31-150).

The same files as the reference: a program's persistable state as one
`params.npz` (a float32 array for a bfloat16 var, as the reference
writes it), the program as `program.json` (the `to_dict` JSON both
packages read), and `meta.json` with the feed and fetch names and
`"format": "paddle_tpu.inference.v1"`; so an inference model saved by
either package loads and runs in the other.  State is read from and
written to `global_scope()`, as in the reference (`scope_guard` picks
another).  Inference export prunes the program to what the targets need
from the feeds and clones it for test (framework/prune.cc in Paddle).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from . import core
from .executor import global_scope
from .framework import Program, Variable, default_main_program

_PARAMS_FILE = "params.npz"
_PROGRAM_FILE = "program.json"
_META_FILE = "meta.json"
FORMAT = "paddle_tpu.inference.v1"


def _persistable_names(program: Program) -> List[str]:
    return [v.name for v in program.list_vars() if v.persistable]


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def save_persistables(executor, dirname, main_program: Optional[Program] =
                      None, filename=None):
    """Every persistable var of `main_program` that the scope holds, into
    `dirname/params.npz` (or `filename`)."""
    os.makedirs(dirname, exist_ok=True)
    program = main_program or default_main_program()
    scope = global_scope()
    arrays = {name: _host(scope.get(name))
              for name in _persistable_names(program)
              if scope.has(name) and scope.get(name) is not None}
    np.savez(os.path.join(dirname, filename or _PARAMS_FILE), **arrays)


save_params = save_persistables


def load_persistables(executor, dirname, main_program: Optional[Program] =
                      None, filename=None):
    """The saved values of `main_program`'s persistable vars into the
    scope, each in its var's dtype; names the program lacks are left."""
    program = main_program or default_main_program()
    scope = global_scope()
    path = os.path.join(dirname, filename or _PARAMS_FILE)
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    wanted = {v.name: v for v in program.list_vars() if v.persistable}
    with np.load(path) as data:
        for name in data.files:
            if name in wanted:
                scope.set(name, torch.from_numpy(data[name]).to(
                    core.torch_dtype(wanted[name].dtype)))


load_params = load_persistables


def _prune_for_targets(program: Program, feed_names, target_names):
    """The ops the targets need, walking back from them and stopping at
    the feeds (a feed's producer is dropped: the model reads the feed);
    a feed that reaches no target raises."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    feeds = set(feed_names)
    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        if set(op.output_arg_names()) & (needed - feeds):
            kept.append(op)
            needed |= set(op.input_arg_names())
    kept = set(map(id, kept))
    block.ops = [op for op in block.ops if id(op) in kept]
    unused = feeds - needed
    if unused:
        raise ValueError(
            f"feed variables {sorted(unused)} do not reach any of the "
            f"target vars {sorted(target_names)}")
    pruned._bump_version()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None,
                         export_for_deployment=True, program_only=False):
    """The program pruned to `target_vars` from `feeded_var_names`, its
    meta and (unless `program_only`) its persistable state; returns the
    target names."""
    os.makedirs(dirname, exist_ok=True)
    program = main_program or default_main_program()
    target_names = [v.name if isinstance(v, Variable) else str(v)
                    for v in target_vars]
    pruned = _prune_for_targets(program, feeded_var_names, target_names)
    with open(os.path.join(dirname, model_filename or _PROGRAM_FILE),
              "w") as f:
        f.write(pruned.to_json())
    with open(os.path.join(dirname, _META_FILE), "w") as f:
        json.dump({"feed": list(feeded_var_names), "fetch": target_names,
                   "format": FORMAT}, f)
    if not program_only:
        save_persistables(executor, dirname, pruned, params_filename)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch vars) of a saved model, its state
    loaded into the scope."""
    with open(os.path.join(dirname, model_filename or _PROGRAM_FILE)) as f:
        program = Program.from_json(f.read())
    with open(os.path.join(dirname, _META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{dirname}: format {meta.get('format')!r}, "
                         f"want {FORMAT!r}")
    load_persistables(executor, dirname, program, params_filename)
    block = program.global_block()
    return program, meta["feed"], [block.var(n) for n in meta["fetch"]]


# -- the state_dict forms (paddle.static.save / load) -------------------------

def save(state_dict_or_program, path):
    """A Program as its JSON at `path`; a {name: array} dict as
    `path`.npz."""
    if isinstance(state_dict_or_program, Program):
        with open(path, "w") as f:
            f.write(state_dict_or_program.to_json())
        return
    arrays = {k: _host(v) for k, v in state_dict_or_program.items()}
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def load(path):
    """What `save` wrote: a Program from a .json path, else the arrays."""
    if path.endswith(".json"):
        with open(path) as f:
            return Program.from_json(f.read())
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {k: data[k] for k in data.files}
