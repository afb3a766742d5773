"""Native host runtime (counterpart of paddle_tpu/core_native): host C++
built by `g++` on first use and loaded with ctypes.

- `BlockingQueue`: a bounded MPMC queue of Python objects over the byte
  queue of `csrc/blocking_queue.cc` (the reference's `ptq_*` ABI; Paddle's
  LoDTensorBlockingQueue role).  Waits happen in C++ with the GIL
  released.  `io.DataLoader.from_generator` and `io.PyReader` prefetch
  through it.
- `build_c_api(embed=False)`: the inference C ABI (`csrc/c_api.cc`, the
  `PT_*` functions over `inference.c_bridge`) as
  `libpaddle_tpu_torch_c.so`; `embed=True` links libpython, so a pure-C
  host can start the interpreter behind `PT_Init`.

Both build into `paddle_tpu_torch/_build/` (listed in .gitignore), never
beside the sources, under a directory named by a hash of the source and
of the compiler's command (the link flags included): an edited source, or
a build without libpython where one with it is asked for, is never
served.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import subprocess
import sysconfig
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
C_API_NAME = "libpaddle_tpu_torch_c.so"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_LIB_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()


def _compile(src: Path, name: str, extra=()) -> str:
    """g++ `src` into BUILD_DIR/<stem>-<hash>/<name> (unless built) and
    return the path.  The hash covers the source and the command, so each
    (source, flags) pair has its own library; the output is written to a
    temporary name and renamed, so concurrent builds never load half a
    file."""
    flags = [*_FLAGS, *extra]
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()
                          ).hexdigest()[:12]
    out = BUILD_DIR / f"{src.stem}-{digest}" / name
    with _BUILD_LOCK:
        if out.exists():
            return str(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{name}.{os.getpid()}.tmp")
        done = subprocess.run(["g++", str(src), *flags, "-o", str(tmp)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name} (exit "
                               f"{done.returncode}):\n{done.stderr}")
        os.replace(tmp, out)
    return str(out)


def _build_and_load():
    lib = ctypes.CDLL(_compile(CSRC / "blocking_queue.cc", "libptq.so",
                               ["-pthread"]))
    lib.ptq_create.restype = ctypes.c_void_p
    lib.ptq_create.argtypes = [ctypes.c_int]
    lib.ptq_push.restype = ctypes.c_int
    lib.ptq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_long]
    lib.ptq_pop.restype = ctypes.c_long
    lib.ptq_pop.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    lib.ptq_pop_timed.restype = ctypes.c_long
    lib.ptq_pop_timed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.c_long]
    lib.ptq_free_buf.restype = None
    lib.ptq_free_buf.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.ptq_close.restype = None
    lib.ptq_close.argtypes = [ctypes.c_void_p]
    lib.ptq_size.restype = ctypes.c_int
    lib.ptq_size.argtypes = [ctypes.c_void_p]
    lib.ptq_capacity.restype = ctypes.c_int
    lib.ptq_capacity.argtypes = [ctypes.c_void_p]
    lib.ptq_destroy.restype = None
    lib.ptq_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                _LIB = _build_and_load()
    return _LIB


def native_available() -> bool:
    """True when the queue's library builds and loads here."""
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False


class BlockingQueue:
    """Bounded blocking queue of Python objects over the native byte
    queue (the reference's LoDTensorBlockingQueue role).  Producers may
    be threads; waits happen in C++ with the GIL released."""

    def __init__(self, capacity: int):
        self._l = _lib()
        self._q = ctypes.c_void_p(self._l.ptq_create(int(capacity)))
        self._closed = False

    def push(self, obj) -> bool:
        """Blocks while the queue is full; False once it is closed."""
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        return self._l.ptq_push(self._q, payload, len(payload)) == 0

    def pop(self, timeout=None):
        """Blocks; returns the object, raises StopIteration when the
        queue is closed and drained, or TimeoutError when `timeout`
        seconds pass with the queue still open and empty."""
        out = ctypes.POINTER(ctypes.c_char)()
        if timeout is None:
            size = self._l.ptq_pop(self._q, ctypes.byref(out))
        else:
            size = self._l.ptq_pop_timed(self._q, ctypes.byref(out),
                                         int(timeout * 1000))
            if size == -2:
                raise TimeoutError(
                    f"BlockingQueue.pop: no data for {timeout}s")
        if size < 0:
            raise StopIteration
        try:
            data = ctypes.string_at(out, size)
        finally:
            self._l.ptq_free_buf(out)
        return pickle.loads(data)  # bytes this process pushed

    def close(self):
        if not self._closed:
            self._closed = True
            self._l.ptq_close(self._q)

    def size(self) -> int:
        return self._l.ptq_size(self._q)

    @property
    def capacity(self) -> int:
        return self._l.ptq_capacity(self._q)

    def __del__(self):
        try:
            self.close()
            self._l.ptq_destroy(self._q)
        except (AttributeError, OSError):
            pass


# -- inference C ABI (csrc/c_api.cc) ------------------------------------------

def build_c_api(embed: bool = False) -> str:
    """Compile the inference C ABI (csrc/c_api.cc) into
    `libpaddle_tpu_torch_c.so` under paddle_tpu_torch/_build/ and return
    its path.  embed=True links libpython, so a pure-C host can run
    without a Python process around it; its library lives in its own
    directory (the link flags are part of the build's hash)."""
    extra = [f"-I{sysconfig.get_path('include')}"]
    if embed:
        extra += [f"-L{sysconfig.get_config_var('LIBDIR')}",
                  f"-lpython{sysconfig.get_config_var('LDVERSION')}"]
    return _compile(CSRC / "c_api.cc", C_API_NAME, extra)


__all__ = ["BlockingQueue", "build_c_api", "native_available"]
