"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, loaded with
ctypes. Outputs live in ``_build/`` next to this file, named by a hash of
the source and flags, so a library is rebuilt only when its source changes.
No PyTorch headers are included, which keeps a cold build to seconds.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# one library per source
SOURCES = {"fused_field": "fused_field.cu", "march_select": "march_select.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: the march select must round every
              # product and sum like the JAX reference (the field kernel
              # writes its FMAs explicitly)
              "-fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the kernels' entries: name -> (library, C entry point, argument types);
# a library also declares <name>_info for each of its entries
_SIGNATURES = {
    "fused_field": ("fused_field", "fused_field_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _F, _P]),
    # the field kernel's entry that reads enc_x (the hash head)
    "fused_field_enc": ("fused_field", "fused_field_enc_launch",
                        [_P, _P, _P, _P, _I, _P]),
    "march_select": ("march_select", "march_select_launch",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _F, _F, _I, _I, _P]),
}

# launches of each entry; a wrapper adds one where it launches its kernel
launches: Dict[str, int] = {name: 0 for name in _SIGNATURES}
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}
last_build: Dict[str, dict] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _lib_path(name: str, extra_flags=()) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(extra_flags=()) -> Dict[str, dict]:
    """Compile every missing library (all nvcc processes in parallel).
    Returns {name: {"path", "cached", "seconds", "log"}}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {}
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        t0 = time.perf_counter()
        for name, src in SOURCES.items():
            path = _lib_path(name, extra_flags)
            if os.path.exists(path):
                out[name] = {"path": path, "cached": True, "seconds": 0.0,
                             "log": ""}
                continue
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
                   os.path.join(CSRC, src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), path, tmp)
        for name, (proc, path, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                for p, _, _ in procs.values():
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
            os.replace(tmp, path)
            out[name] = {"path": path, "cached": False,
                         "seconds": time.perf_counter() - t0, "log": log}
    last_build.update(out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source (SOURCES), built on first use."""
    lib = _libs.get(name)
    if lib is None:
        info = last_build.get(name) or build()[name]
        lib = ctypes.CDLL(info["path"])
        _libs[name] = lib
    return lib


def _entry(name: str):
    """The C entry point of one kernel entry, its types declared."""
    fn = _entries.get(name)
    if fn is None:
        lib_name, fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def info(name: str, *shape: int) -> Dict[str, int]:
    """Registers and spill bytes per thread, shared memory per block and
    resident warps per SM of one kernel entry as compiled, from the CUDA
    runtime (its library's ``<name>_info`` entry point). `shape` is what
    that entry point takes after its output array: the launch sizes its
    shared memory depends on (march_select: G, S; the field entries:
    none)."""
    fn = getattr(library(_SIGNATURES[name][0]), f"{name}_info")
    fn.argtypes = [_P] + [_I] * len(shape)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    status = fn(ctypes.cast(out, _P), *shape)
    if status != 0:
        raise RuntimeError(f"{name}_info failed with CUDA error {status}")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "warps_per_sm"), out))


def launch(name: str, *args) -> None:
    """Call a kernel entry's C entry point and raise on a nonzero CUDA
    status."""
    status = _entry(name)(*args)
    if status != 0:
        raise RuntimeError(f"{_SIGNATURES[name][1]} failed with CUDA error "
                           f"{status}")
    launches[name] += 1
