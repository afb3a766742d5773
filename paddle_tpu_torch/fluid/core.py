"""Core dtype and Place utilities of the port's Fluid front end
(counterpart of paddle_tpu/fluid/core.py and the Places of
paddle_tpu/fluid/__init__.py:24-55).

Dtypes are the reference's canonical name strings (the framework-wide
currency of Program JSON), each mapped onto a `torch.dtype` here.  A Place
names where an Executor runs: `CUDAPlace(i)` is the card
`torch.device("cuda", i)`, `CPUPlace()` the host; `TPUPlace` stays a name
for `CUDAPlace`, as the reference aliases the two the other way round.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPE_ALIASES = {
    "float32": "float32",
    "fp32": "float32",
    "float": "float32",
    "float64": "float64",
    "fp64": "float64",
    "double": "float64",
    "float16": "float16",
    "fp16": "float16",
    "half": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "uint8": "uint8",
    "uint16": "uint16",
    "uint32": "uint32",
    "bool": "bool",
    "complex64": "complex64",
    "complex128": "complex128",
}

FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")
INT_DTYPES = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32")

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


class VarType:
    """Variable kind tags (the reference's VarType enum names)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


def convert_dtype(dtype) -> str:
    """Normalize any dtype spec (alias string, numpy or torch dtype,
    python type) to a canonical dtype name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "name", None) or getattr(
                dtype, "__name__", None)
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    if name is None and "bfloat16" in str(dtype):
        return "bfloat16"
    raise ValueError(f"unsupported dtype: {dtype!r}")


def torch_dtype(name) -> torch.dtype:
    """Canonical dtype name (or any spec) -> torch.dtype."""
    return _TORCH_DTYPES[convert_dtype(name)]


def is_float_dtype(name) -> bool:
    return convert_dtype(name) in FLOAT_DTYPES


def is_int_dtype(name) -> bool:
    return convert_dtype(name) in INT_DTYPES


class CPUPlace:
    """The host."""

    def __repr__(self):
        return "CPUPlace"

    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace:
    """CUDA card `device_id` (torch.device("cuda", device_id))."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"

    def device(self) -> torch.device:
        return torch.device("cuda", self.device_id)


# The reference's accelerator place is the TPU, with CUDAPlace as its
# alias; here the accelerator is the card, and TPUPlace names it.
TPUPlace = CUDAPlace


class CUDAPinnedPlace:
    """Pinned host memory: feeds placed here behave as CPUPlace feeds."""

    def __repr__(self):
        return "CUDAPinnedPlace"

    def device(self) -> torch.device:
        return torch.device("cpu")
