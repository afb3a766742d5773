"""Checkpoint directory layout, manifest format and the atomic multi-file
commit protocol (a copy of paddle_tpu/ckpt/manifest.py, so that each
package reads the other's checkpoints).

One checkpoint is one directory:

    <root>/ckpt-00000042/
        shard_00000.npz     host 0's slice of the state
        manifest.json       written + fsync'd + renamed LAST

The manifest is the commit record: a checkpoint without a readable
manifest, or whose manifest lists a shard file that is missing, is not a
checkpoint; `latest_checkpoint` skips it and `read_manifest` /
`validate_complete` raise `CheckpointError` with the reason.  Writers
stage everything under `<root>/.tmp-ckpt-<step>` and publish it with one
`os.replace`, so a reader never sees a torn checkpoint and a SIGKILL in
the middle of a write leaves only a tmp dir that the next commit removes.

Arrays are stored as numpy writes them; a bfloat16 array (which numpy
cannot name without ml_dtypes) is stored as its raw 2-byte values
(`|V2`), exactly as numpy stores an ml_dtypes bfloat16 array, with
"bfloat16" in the manifest.  `to_numpy` and `to_torch` convert between
those encodings and torch tensors.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_FORMAT = "paddle_tpu.ckpt.v1"
MANIFEST_FILE = "manifest.json"
CKPT_PREFIX = "ckpt-"
TMP_PREFIX = ".tmp-ckpt-"
_STEP_RE = re.compile(r"^ckpt-(\d+)$")


class CheckpointError(RuntimeError):
    """A checkpoint could not be written, validated, or restored."""


# -- names / dtypes (npz-safe encodings) -------------------------------------

def encode_name(name: str) -> str:
    """npz member names must not contain '/' (zip path separators); var
    names may."""
    return name.replace("/", "%2F")


def decode_name(name: str) -> str:
    return name.replace("%2F", "/")


def dtype_name(value) -> str:
    """The manifest's dtype string of a tensor or array: numpy's name
    ("float32", "int64", "bfloat16", ...)."""
    if isinstance(value, torch.Tensor):
        return str(value.dtype).replace("torch.", "")
    return str(np.asarray(value).dtype)


def to_numpy(value) -> np.ndarray:
    """A host array as it goes into a shard file: a torch tensor's values
    (bfloat16 as its raw `|V2` bytes), or the array itself."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(value)


def to_torch(arr: np.ndarray, name: str) -> torch.Tensor:
    """A shard file's array as a CPU tensor of the manifest's dtype `name`
    (the raw `|V2` bytes of a bfloat16 array viewed back)."""
    if name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise CheckpointError(f"a bfloat16 var stored as {arr.dtype}")
        raw = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    want = np.dtype(name)
    if arr.dtype != want:
        arr = arr.view(want) if arr.dtype.kind == "V" and \
            arr.dtype.itemsize == want.itemsize else arr.astype(want)
    return torch.from_numpy(np.ascontiguousarray(arr))


# -- shard map ---------------------------------------------------------------

def shard_assignment(names, count: int) -> Dict[str, int]:
    """Var -> host: round-robin over the sorted names; disjoint and
    exhaustive for any count, the same on every host."""
    count = max(1, int(count))
    return {n: i % count for i, n in enumerate(sorted(names))}


def shard_file(index: int) -> str:
    return f"shard_{int(index):05d}.npz"


# -- fsync'd writes ----------------------------------------------------------

def fsync_dir(path: str) -> None:
    """Durability for the rename itself (POSIX: renaming is atomic;
    persisting it needs the parent dir fsync'd)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_file_atomic(path: str, data: bytes) -> None:
    """write tmp + flush + fsync + rename: no reader sees a torn file."""
    tmp = f"{path}.partial.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_npz_atomic(path: str, arrays: Dict[str, Any]) -> None:
    tmp = f"{path}.partial.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# -- manifest read / validate ------------------------------------------------

def write_manifest(ckpt_dir: str, manifest: Dict[str, Any]) -> None:
    data = json.dumps(manifest, indent=1, sort_keys=True).encode()
    write_file_atomic(os.path.join(ckpt_dir, MANIFEST_FILE), data)
    fsync_dir(ckpt_dir)


def read_manifest(path: str) -> Dict[str, Any]:
    mf = os.path.join(path, MANIFEST_FILE)
    if not os.path.isfile(mf):
        raise CheckpointError(
            f"{path}: no {MANIFEST_FILE} — this is not a committed "
            f"checkpoint (a half-written tmp dir, or not a checkpoint "
            f"at all); refusing to load partial state")
    try:
        with open(mf) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path}: unreadable manifest: {e}") from e
    fmt = manifest.get("format")
    if fmt != MANIFEST_FORMAT:
        raise CheckpointError(
            f"{path}: manifest format {fmt!r} is not {MANIFEST_FORMAT!r}")
    return manifest


def validate_complete(path: str, manifest: Dict[str, Any]) -> None:
    """Refuse partial checkpoints: every shard the manifest names must
    exist."""
    missing = [s for s in manifest.get("shards", [])
               if not os.path.isfile(os.path.join(path, s))]
    if missing:
        raise CheckpointError(
            f"{path}: partial checkpoint — manifest lists shard(s) "
            f"{missing} that do not exist; refusing to load partial "
            f"state")


def step_of(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def checkpoint_dir_name(step: int) -> str:
    return f"{CKPT_PREFIX}{int(step):08d}"


def tmp_dir_name(step: int) -> str:
    return f"{TMP_PREFIX}{int(step):08d}"


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """(step, path) of every complete checkpoint under root, ascending by
    step; tmp dirs and dirs failing validation are skipped."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        step = step_of(name)
        if step is None:
            continue
        path = os.path.join(root, name)
        try:
            validate_complete(path, read_manifest(path))
        except CheckpointError:
            continue
        out.append((step, path))
    out.sort()
    return out


def latest_checkpoint(root: str) -> Optional[str]:
    """Path of the newest complete checkpoint under `root`, or None."""
    done = list_checkpoints(root)
    return done[-1][1] if done else None


def flag_signature() -> str:
    """The flag state a checkpoint was trained under (restore warns on a
    mismatch).  The port has no graph-transform pipeline yet (ROADMAP
    queue 1 item 13), so its list is empty."""
    from ..fluid.flags import flag

    return json.dumps({"check_nan_inf": bool(flag("check_nan_inf")),
                       "graph_transforms": []}, sort_keys=True)
