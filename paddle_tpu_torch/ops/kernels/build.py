"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source under `paddle_tpu_torch/csrc/` has a plain C interface and
is compiled on first use, by `nvcc` for `sm_90a`, into its own shared
library under `paddle_tpu_torch/_build/` (listed in .gitignore), then
loaded with ctypes.  Pointers and the CUDA stream cross as `c_void_p`;
every C entry returns `cudaGetLastError()` after its launch and the
wrapper raises on anything but 0.  Library names carry a hash of the
source, so an edited kernel is never served from a stale build.

All sources build in parallel (one nvcc each, started together) under
one lock: the serving engine's threads can race to the first launch.
Nothing here runs at import time — the CPU tests import every module on
a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per-source nvcc output (ptxas register / shared-memory report)
BUILD_LOG: Dict[str, str] = {}


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches,
    and nowhere else, so a run can show its path went through it."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built from csrc/ on first use and need the CUDA "
                       "toolkit")


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every csrc/*.cu that has no up-to-date library yet, all in
    parallel; returns {source stem: seconds} for what was compiled.
    Raises RuntimeError with nvcc's output if any compile fails."""
    with _LOCK:
        return _build_locked()


def _build_locked() -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sorted(CSRC.glob("*.cu")) if not _target(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    for src in todo:
        out = _target(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    done, errors = {}, []
    for src, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        done[src.stem] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (building first if
    needed)."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(stem)
    if lib is not None:
        return lib
    with _LOCK:
        if stem not in _LIBS:
            src = CSRC / f"{stem}.cu"
            if not src.exists():
                raise FileNotFoundError(f"no kernel source {src}")
            if not _target(src).exists():
                _build_locked()
            _LIBS[stem] = ctypes.CDLL(str(_target(src)))
        return _LIBS[stem]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry (each source
    exports `error_string` for the message)."""
    if err != 0:
        fn = lib.error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"({fn(err).decode()})")
