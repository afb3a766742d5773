"""`paddle.save` / `paddle.load` (counterpart of
paddle_tpu/framework_io.py).

The format is the reference's: a pickle (protocol 4) of the nested
object with every tensor as a numpy array (bfloat16 as float32, which
numpy lacks), so a `.pdparams` or `.pdopt` written by either package
loads in the other; `Layer.set_state_dict` and
`Optimizer.set_state_dict` cast the arrays back onto the live dtypes.
"""

from __future__ import annotations

import os
import pickle

import torch


def _to_storable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle a (nested) state dict to `path`, tensors as numpy."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_storable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        return pickle.load(f)
