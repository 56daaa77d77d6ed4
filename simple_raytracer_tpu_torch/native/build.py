"""Build and load the native host library (``native.cpp``).

``g++ -O3`` compiles ``native.cpp`` at first use into
``simple_raytracer_tpu_torch/_build/`` (next to the CUDA kernels' libraries),
under a name that holds a content hash of the source and the flags, so an
edited source is never served a stale build.  The compiler writes to a name
of its own process and the library is then renamed into place, so processes
that build at once (test workers, torchrun's ranks) never load a half-written
file.  Nothing here runs at import.

``SRT_NO_NATIVE=1`` turns the library off, and without ``g++``, or when it
fails, the loader says so on stderr: the callers then take the Python paths,
which give the same arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Optional

SRC = os.path.join(os.path.dirname(__file__), "native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsrt_native_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile ``native.cpp`` unless this version is built.  Returns
    {"path", "seconds" (of the compile; 0 when cached), "cached", "log"
    (g++'s output)}; raises RuntimeError when g++ is missing or fails."""
    path = lib_path()
    if os.path.isfile(path):
        log = ""
        if os.path.isfile(path + ".log"):
            with open(path + ".log") as f:
                log = f.read()
        return {"path": path, "seconds": 0.0, "cached": True, "log": log}
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native build: g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.time()
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build: g++ did not run: {e}") from e
    seconds = time.time() - t0
    log = r.stdout + r.stderr
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed ({r.returncode}):\n{log}")
    with open(tmp + ".log", "w") as f:
        f.write(log)
    os.replace(tmp + ".log", path + ".log")
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "cached": False, "log": log}


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(build()["path"])
    except (RuntimeError, OSError) as e:
        print(f"native library unavailable, using the Python paths: {e}",
              file=sys.stderr)
        return None
    _configure(lib)
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built at first use; None under
    ``SRT_NO_NATIVE`` or when it cannot be built or loaded."""
    if os.environ.get("SRT_NO_NATIVE"):
        return None
    with _lock:
        return _load()


def _configure(lib: ctypes.CDLL) -> None:
    import numpy as np
    from numpy.ctypeslib import ndpointer

    f32 = ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [
        f32, ctypes.c_int64, ctypes.c_int, f32, f32, i32, i32, i32, i32,
        ctypes.c_int, i32]

    lib.obj_scan.restype = ctypes.c_int
    lib.obj_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]


def native_available() -> bool:
    """Whether the native paths run: the library is built and loaded, and
    ``SRT_NO_NATIVE`` is not set."""
    return get_lib() is not None
