"""ctypes wrapper for the C++ frame pump (csrc/framepump.cpp; the port's
copy of lzzx_nerf_tpu/native).

Builds the shared library on first use (g++, about a second) into
``_build/`` of this package, named by a hash of the source, and loads it.
`FramePump(fd, frame_bytes)` decouples the render cadence from encoder
stalls: push() memcpys into a C++ ring buffer and returns; a native thread
writes to the fd, applying backpressure only when the ring (default 50
frames = 2 s at 25 FPS) is full, and it blocks without the GIL, so the
render loop keeps running.

Builds in several processes at once (test workers) are safe: each writes
its own temporary file and renames it into place, so a process never
loads a half-written library or renames another's file away.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "framepump.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")


def build_library(build_dir: str = BUILD_DIR) -> str:
    """Compile the pump into `build_dir` unless it is there; returns the
    library's path. The file is named by a hash of the source and flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    so = os.path.join(build_dir, f"libframepump-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        try:
            subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def load_library(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (if needed) and load the pump with its signatures declared."""
    lib = ctypes.CDLL(build_library(build_dir))
    lib.fp_create.restype = ctypes.c_void_p
    lib.fp_create.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_long]
    lib.fp_push.restype = ctypes.c_int
    lib.fp_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fp_pending.restype = ctypes.c_long
    lib.fp_pending.argtypes = [ctypes.c_void_p]
    lib.fp_error.restype = ctypes.c_int
    lib.fp_error.argtypes = [ctypes.c_void_p]
    lib.fp_close.restype = ctypes.c_long
    lib.fp_close.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    global _lib, _lib_err
    with _lock:
        if _lib is None and _lib_err is None:
            try:
                _lib = load_library()
            except (OSError, subprocess.CalledProcessError) as e:
                # no g++ or a failed load: the sinks write from Python
                _lib_err = f"{type(e).__name__}: {e}"
        return _lib


def native_available() -> bool:
    return _load() is not None


class FramePump:
    """Ring-buffered native writer to a file descriptor."""

    def __init__(self, fd: int, frame_bytes: int, capacity: int = 50):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"framepump library unavailable: {_lib_err}")
        self._lib = lib
        self._h = lib.fp_create(fd, frame_bytes, capacity)
        if not self._h:
            raise RuntimeError("fp_create failed")
        self.frame_bytes = frame_bytes

    def push(self, data: bytes) -> None:
        if self._h is None:
            # a None handle would reach C as NULL and segfault, not raise
            raise ValueError("push() after close()")
        if len(data) != self.frame_bytes:
            raise ValueError(
                f"frame must be {self.frame_bytes} bytes, got {len(data)}")
        rc = self._lib.fp_push(self._h, data)
        if rc != 0:
            raise BrokenPipeError(f"frame sink failed (errno {rc})")

    def pending(self) -> int:
        return 0 if self._h is None else self._lib.fp_pending(self._h)

    def close(self) -> int:
        """Drain + stop; returns frames written (raises if the sink died)."""
        if self._h is None:
            return 0
        n = self._lib.fp_close(self._h)
        self._h = None
        if n < 0:
            raise BrokenPipeError(f"frame sink failed (errno {-n})")
        return int(n)
