"""Global runtime flags (counterpart of paddle_tpu/fluid/flags.py).

A registry of every flag name of the reference, each with the
reference's default, seeded from `FLAGS_<name>` environment variables,
read with `flag(name)` and set with `set_flags({"FLAGS_<name>": value})`;
unknown names raise, as in the reference.  Three kinds:

- honoured: `check_nan_inf` (the Executor's non-finite monitor),
  `op_callstack` (the construction stack on every appended op),
  `cudnn_deterministic` (torch.backends.cudnn.deterministic) and the
  `ckpt_*` flags of train_from_dataset's auto-checkpoint, seeded as in
  the reference from PADDLE_CKPT_* before FLAGS_ckpt_*, and
  `quant_collectives` / `quant_collectives_min_bytes` (the int8
  collectives of parallel/quant_collectives.py, which read
  PADDLE_QUANT_COLLECTIVES* first at each call);
- kept for parity, as the reference keeps them (allocator and threading
  knobs that neither package acts on): any value is accepted;
- the reference's machinery that the port lacks (telemetry, the AOT
  cache, autotuning, the program verifier and
  transform passes, per-op numerics): the default is accepted, and
  another value raises NotImplementedError naming its ROADMAP item, when
  it is set and, for a value from the environment, where the machinery
  would run (`check_unported`).  The reference's PADDLE_* aliases of
  these (PADDLE_AOT_CACHE_DIR, PADDLE_OBS_*, ...) are not read.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, dict] = {}

# ROADMAP items of the machinery behind the flags the port lacks
_AOT = "queue 1 item 11 (fluid/aot_cache.py)"
_TOOLS = "queue 1 item 13 (tooling: obs, analysis, transforms, tune)"


def _define(name, default, help_str="", on_set: Callable = None,
            typ=None, unported: str = None, env_var: str = None):
    """`env_var` names an environment variable read before
    FLAGS_<name>, as the reference reads PADDLE_CKPT_*."""
    typ = typ or type(default)
    value = default
    env = os.environ.get(env_var) if env_var is not None else None
    if env is None:
        env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        value = env.lower() in ("1", "true", "yes") if typ is bool \
            else typ(env)
    _REGISTRY[name] = {"value": value, "default": default, "help": help_str,
                       "type": typ, "on_set": on_set, "unported": unported}
    if on_set is not None and value != default:
        on_set(value)


def _set_deterministic(v):
    import torch

    torch.backends.cudnn.deterministic = bool(v)


# -- honoured ----------------------------------------------------------------
_define("check_nan_inf", False,
        "one device-side non-finite flag per float output and state array "
        "of every Executor.run, read behind an event and raised at the "
        "next run() entry or at sync() / a dataset loop's exit")
_define("op_callstack", False,
        "record the Python construction stack on every appended op "
        "(attrs['op_callstack'])")
_define("cudnn_deterministic", False,
        "deterministic cuDNN algorithms (torch.backends.cudnn."
        "deterministic)", _set_deterministic)
# train_from_dataset's auto-checkpoint (paddle_tpu_torch.ckpt)
_define("ckpt_dir", "", "auto-checkpoint root of train_from_dataset",
        env_var="PADDLE_CKPT_DIR")
_define("ckpt_every_steps", 0,
        "auto-checkpoint every N steps (0 = only the end-of-pass save)",
        env_var="PADDLE_CKPT_EVERY_STEPS")
_define("ckpt_every_secs", 0.0,
        "auto-checkpoint every N seconds (0 = off; whichever of the two "
        "fires first)", env_var="PADDLE_CKPT_EVERY_SECS")
_define("ckpt_keep", 3, "checkpoints kept", env_var="PADDLE_CKPT_KEEP")
_define("ckpt_max_in_flight", 2,
        "snapshots pending before save_async backpressures",
        env_var="PADDLE_CKPT_MAX_IN_FLIGHT")
_define("ckpt_resume", True, "resume from the newest checkpoint",
        env_var="PADDLE_CKPT_RESUME")
# -- kept for parity (the reference acts on none of them either) -------------
_define("allocator_strategy", "auto_growth", "host-staging allocator")
_define("eager_delete_tensor_gb", 0.0, "GC threshold")
_define("fraction_of_gpu_memory_to_use", 0.92, "device memory fraction")
_define("paddle_num_threads", 1, "intra-op host threads")
_define("sync_nccl_allreduce", True, "collective sync mode")
_define("quant_collectives", "off", "quantized collectives: off | int8")
_define("quant_collectives_min_bytes", 1024,
        "quantized collectives' floor: smaller payloads stay full width")
_define("benchmark", False, "per-op benchmark mode")
_define("max_inplace_grad_add", 0, "grad accumulation inplace threshold")
_define("sort_sum_gradient", False, "deterministic gradient sum order")
_define("use_pinned_memory", True, "host staging uses pinned buffers")
_define("init_allocated_mem", False, "poison fresh allocations")
_define("free_idle_chunk", False, "release idle allocator chunks")
_define("tracer_profile_fname", "", "imperative tracer profile output")
# -- the reference's machinery the port lacks --------------------------------
_define("check_numerics", False, "per-op numeric check", unported=_TOOLS)
_define("verify_program", "on", "program verifier passes", unported=_TOOLS)
_define("graph_transforms", "on", "transform pass pipeline",
        unported=_TOOLS)
_define("transform_debug", False, "per-pass transform bisection",
        unported=_TOOLS)
_define("obs_sample_s", 1.0, "telemetry sampler period", unported=_TOOLS)
_define("obs_http_port", -1, "telemetry HTTP port", unported=_TOOLS)
_define("obs_flight_dir", "artifacts/flight", "flight-recorder dir",
        unported=_TOOLS)
_define("obs_flight_keep", 5, "flight-recorder retention", unported=_TOOLS)
_define("obs_flight_min_interval_s", 60.0, "flight-recorder rate limit",
        unported=_TOOLS)
_define("aot_cache", "on", "persistent AOT executable cache",
        unported=_AOT)
_define("aot_cache_dir", "artifacts/aot_cache", "AOT cache root",
        unported=_AOT)
_define("autotune", "on", "self-tuning compile pipeline", unported=_TOOLS)
_define("autotune_dir", "", "tuning-record root", unported=_TOOLS)
_define("autotune_trial_steps", 3, "measured steps a candidate",
        unported=_TOOLS)
_define("autotune_max_candidates", 6, "candidates a search",
        unported=_TOOLS)

# checked at each Executor compile, as the reference consults them there
COMPILE_FLAGS = ("check_numerics", "verify_program", "graph_transforms",
                 "transform_debug", "aot_cache", "aot_cache_dir", "autotune",
                 "autotune_dir", "autotune_trial_steps",
                 "autotune_max_candidates")
# checked at each train_from_dataset, where the reference arms them
LOOP_FLAGS = ("obs_sample_s", "obs_http_port", "obs_flight_dir",
              "obs_flight_keep", "obs_flight_min_interval_s")


def _key(n):
    key = n[6:] if n.startswith("FLAGS_") else n
    if key not in _REGISTRY:
        raise ValueError(f"unknown flag {n!r}")
    return key


def _refuse(key, value):
    entry = _REGISTRY[key]
    raise NotImplementedError(
        f"FLAGS_{key}={value!r}: the port lacks what it acts on (ROADMAP "
        f"{entry['unported']}); only its default {entry['default']!r} is "
        f"accepted")


def get_flags(flags):
    """get_flags(['FLAGS_x', ...]) -> {name: value}."""
    single = isinstance(flags, str)
    names = [flags] if single else list(flags)
    out = {n: _REGISTRY[_key(n)]["value"] for n in names}
    return out[names[0]] if single else out


def set_flags(flags: Dict[str, Any]):
    """set_flags({'FLAGS_x': v}); a flag of machinery the port lacks
    takes its default only."""
    for n, v in flags.items():
        entry = _REGISTRY[_key(n)]
        value = entry["type"](v) if entry["type"] is not bool else bool(v)
        if entry["unported"] and value != entry["default"]:
            _refuse(_key(n), value)
        entry["value"] = value
        if entry["on_set"] is not None:
            entry["on_set"](value)


def check_unported(names):
    """Raise for the first of `names` whose value (from the environment)
    is not its default."""
    for key in names:
        entry = _REGISTRY[key]
        if entry["value"] != entry["default"]:
            _refuse(key, entry["value"])


def flag(name, default=None):
    """Internal fast read."""
    e = _REGISTRY.get(name)
    return e["value"] if e is not None else default
