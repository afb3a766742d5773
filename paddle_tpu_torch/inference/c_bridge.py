"""Python side of the inference C ABI (csrc/c_api.cc; counterpart of
paddle_tpu/inference/c_bridge.py).

The C layer hands raw pointers and shapes across the ABI; this module
views them as arrays, drives the Predictor and writes the float32 output
where the caller wants it.  It knows nothing of the C structs: the whole
contract is (address, shape) in, (an output buffer's address and
capacity) out.

The device is the export's: a model exported on the card runs on the
card, one exported on the CPU on the CPU (ROADMAP queue 3 item 35).  No
environment variable selects it and nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import EXPORTED, Config, Predictor
from .. import profiler


def new_predictor(prefix: str) -> Predictor:
    return Predictor(Config(prefix, device=EXPORTED))


def _floats(addr: int, n: int) -> np.ndarray:
    """The caller's n floats at `addr`, viewed, not copied."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(int(addr)))


def _output(pred: Predictor, addr: int, shape) -> torch.Tensor:
    """The model's float32 output, still on its device, for the one f32
    input at `addr`.  The input is viewed: the bucketed runner's copy to
    the device is its one read, made before this returns, while the
    caller's buffer is alive.  A bfloat16 output is widened on the
    device, as Predictor.run widens it on the host."""
    specs = pred.manifest["inputs"]
    if len(specs) != 1 or specs[0]["dtype"] != "float32":
        raise ValueError(
            f"run_f32: the model takes {[s['dtype'] for s in specs]}; the "
            f"C ABI feeds one float32 input (export with a float32 input "
            f"and cast inside)")
    dims = [int(s) for s in shape]
    x = _floats(addr, int(np.prod(dims))).reshape(dims)
    return pred.run_handles([x])[0].torch().float()


def _copy_out(out: torch.Tensor, dst: np.ndarray) -> None:
    """The output's one host copy, into `dst` (a sanctioned sync)."""
    with profiler.timed("sync_ms"):
        profiler.count_sync()
        torch.from_numpy(dst).view(out.shape).copy_(out)


def run_f32_into(pred: Predictor, addr: int, shape, out_addr: int,
                 out_capacity: int) -> tuple:
    """One f32 tensor in, one f32 tensor out, copied straight into the
    caller's buffer of `out_capacity` floats at `out_addr`: the output's
    one host copy, at the ABI boundary.  Returns (the output's element
    count, its shape); when the count exceeds `out_capacity` nothing is
    written (PT_PredictorRun's -2)."""
    out = _output(pred, addr, shape)
    n = out.numel()
    if out_addr and 0 < n <= out_capacity:
        _copy_out(out, _floats(out_addr, n))
    return n, [int(s) for s in out.shape]


def run_f32(pred: Predictor, addr: int, shape) -> tuple:
    """The reference's form: (a C-contiguous float32 array, its shape)."""
    out = _output(pred, addr, shape)
    host = np.empty(tuple(out.shape), np.float32)
    _copy_out(out, host)
    return host, [int(s) for s in out.shape]
