"""Device selection (counterpart of paddle_tpu/device.py).

The accelerator is the CUDA card.  The default device is `cuda`; asking
for it on a machine without CUDA raises instead of carrying on silently
on the CPU.  The CPU is used only when a caller names it (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_CURRENT = [None]  # the device set by set_device(); None = default cuda

DeviceLike = Union[str, torch.device, None]


def _checked(device: DeviceLike) -> torch.device:
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(d)!r} requested but CUDA is not available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; use 'cuda[:i]' or "
                         "'cpu'")
    return d


def set_device(device: DeviceLike) -> torch.device:
    """'cuda[:i]' | 'gpu[:i]' | 'cpu' — the default device of the port's
    entry points from now on."""
    _CURRENT[0] = _checked(device)
    return _CURRENT[0]


def get_device() -> torch.device:
    """The current default device: what set_device() chose, else cuda
    (raising when CUDA is absent)."""
    if _CURRENT[0] is not None:
        return _CURRENT[0]
    return _checked("cuda")


def resolve(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on: the caller's, else the
    default (cuda)."""
    return get_device() if device is None else _checked(device)
