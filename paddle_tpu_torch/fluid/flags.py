"""Global runtime flags (the part of paddle_tpu/fluid/flags.py that the
port's modules read).

A registry seeded from `FLAGS_<name>` environment variables, read with
`flag(name)` and set with `set_flags({"FLAGS_<name>": value})`; unknown
names raise, as in the reference.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, dict] = {}


def _define(name, default, help_str=""):
    typ = type(default)
    value = default
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        value = env.lower() in ("1", "true", "yes") if typ is bool \
            else typ(env)
    _REGISTRY[name] = {"value": value, "default": default, "help": help_str,
                       "type": typ}


_define("op_callstack", False,
        "record the Python construction stack on every appended op "
        "(attrs['op_callstack'])")


def get_flags(flags):
    """get_flags(['FLAGS_x', ...]) -> {name: value}."""
    single = isinstance(flags, str)
    names = [flags] if single else list(flags)
    out = {}
    for n in names:
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        out[n] = _REGISTRY[key]["value"]
    return out[names[0]] if single else out


def set_flags(flags: Dict[str, Any]):
    """set_flags({'FLAGS_x': v})."""
    for n, v in flags.items():
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        entry = _REGISTRY[key]
        entry["value"] = entry["type"](v) if entry["type"] is not bool \
            else bool(v)


def flag(name, default=None):
    """Internal fast read."""
    e = _REGISTRY.get(name)
    return e["value"] if e is not None else default
