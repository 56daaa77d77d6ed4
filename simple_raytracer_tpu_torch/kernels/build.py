"""Build and bind the CUDA kernels in ``csrc/``.

The sources have a plain C interface.  ``nvcc`` compiles each ``.cu`` file
for Hopper (``sm_90a``) into a shared library of its own, all of them at
once, and each is loaded with ``ctypes``.  Nothing here runs at import: the
first CUDA launch calls :func:`library`, which builds once per source
version into ``simple_raytracer_tpu_torch/_build/`` (a content hash names
each library, so an edited source is never served a stale build) and loads
them.

Floating-point contraction is off (``--fmad=false``): the kernels then round
each multiply and add separately, as the plain PyTorch versions do, and the
two agree to the last bit wherever they evaluate the same expression.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import types

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures by source; each function returns a cudaError_t
SIGNATURES = {
    "nearest.cu": {
        "srt_nearest_k1": (
            _P, _I, _I,          # plan, plan_w, n_tiles
            _P, _P, _I,          # tri, tri_attr, n_windows
            _P, _I,              # mat, n_obj
            _P, _I, _I, _F,      # cam, tile_px, window_tris, eps
            _I, _I,              # double_sided, specular_nl
            _I, _P,              # attribute mode (-1 fetch), attr_map
            _P, _P, _P, _P, _P,  # t, idx, obj, rgb or comp, bounds
            _P,                  # attr_out (fetch mode)
            _P, _P, _I,          # keys, sched, rows_max
            _I, _I,              # range span, list span
            _I, _P),             # stages, stream
        "srt_k1_shape": (_I, _P),  # window_tris, out[5]
        "srt_nearest_rays": (
            _P, _I, _I, _I,      # plan, plan_w, n_tiles, sub-groups
            _P, _I,              # tri, n_windows
            _P, _P, _I,          # o, d, rays per tile
            _I, _F,              # window_tris, eps
            _P, _P,              # t, idx
            _P, _P,              # tri_attr, attr_out (fetch mode) or 0, 0
            _P, _P, _I,          # keys, sched, rows_max
            _I, _I,              # range span, list span
            _I, _P),             # stages, stream
        "srt_nearest_rays_shape": (_I, _I, _I, _P),  # wt, m, groups, out[5]
    },
    "anyhit.cu": {
        "srt_anyhit_from_t": (
            _P, _I, _I,          # plan, plan_w, n_tiles
            _P, _P, _I,          # tri, block_obj, n_windows
            _P, _P,              # t, obj
            _P, _I, _I, _I,      # cam, tile_px, window_tris, block_size
            _F, _I,              # eps, no_max_t
            _P, _P, _I,          # found, sched, rows_max
            _I, _I,              # range span, list span
            _I, _P),             # stages, stream
        "srt_anyhit_rays": (
            _P, _I, _I, _I,      # plan, plan_w, n_tiles, sub-groups
            _P, _P, _I,          # tri, block_obj, n_windows
            _P, _P, _P, _I,      # o, d, self_obj, rays per tile
            _I, _I, _F, _I,      # window_tris, block_size, eps, no_max_t
            _P, _P, _I,          # found, sched, rows_max
            _I, _I,              # range span, list span
            _I, _P),             # stages, stream
        "srt_anyhit_rays_shape": (_I, _I, _I, _I, _P),  # wt, bs, m, groups,
                                                       # out[5]
        "srt_anyhit_from_t_shape": (_I, _I, _I, _P),   # wt, bs, m, out[5]
    },
    "prepass.cu": {
        "srt_prepass": (
            _P, _I, _I,          # plan, plan_w, n_tiles
            _P, _I,              # gram, n_windows
            _P, _P, _I,          # o, d, rays per tile
            _I, _F, _F,          # window_tris, eps, margin factor
            _P, _P, _I,          # flags, sched, rows_max
            _I, _I,              # range span, list span
            _I, _P),             # stages, stream
        "srt_prepass_shape": (_I, _I, _P),  # window_tris, m, out[5]
    },
    "plan.cu": {
        "srt_plan": (
            ctypes.POINTER(_L),  # operands: (pointer, stride 0, stride 1)s
            _P, _P, _P,          # block_min, block_max, block_obj
            _I, _I, _I, _I,      # n_blocks, window blocks, apex, hourglass
            _I, _I, _I,          # maxv, plan_w, n_tiles
            _I, _I, _I, _I,      # tiles_x, tile_px, half width, half height
            _P, _P, _P,          # block scratch, window scratch, plan
            _P),                 # stream
        "srt_camera": (
            _P, _L, _L, _F,      # view, its strides, focal
            _P, _L,              # light, its stride
            _P, _P, _I,          # block_min, block_max, n_blocks
            _P, _P),             # cam, stream
        "srt_tile_bounds": (
            _P, _I, _I, _I, _I,  # cam, width, height, tile_px, n_tiles
            _P, _P, _P,          # out, tile_bad, scratch
            _P),                 # stream
        "srt_shadow_bounds": (
            _P, _I, _P,          # K1's bounds rows, n_tiles, cam
            _P, _P, _P,          # out, excl, live
            _P),                 # stream
    },
    "shade.cu": {
        "srt_shade": (
            _P, _P, _P, _P, _I,  # o, d, t, idx, rays
            _P, _P, _P,          # verts, normals (vertex or flat), uvs
            _P, _P,              # tri_obj, tri_tex
            _P, _P, _P, _P,      # obj_color, ambient, specular, shininess
            _P, _P, _P, _P,      # tex_data, tex_offset, width, height
            _P, _I, _P,          # samples, light samples, found or 0
            ctypes.POINTER(_F),  # light colour [3]
            _F, _F, _F, _I,      # 1 / shadow_dim, reinhard offset, gamma,
                                 # gamma kind
            _I, _I, _I,          # smooth, textured, tonemap
            _I, _I,              # double_sided, specular_nl
            _P, _P),             # out, stream
    },
    "probe_fixed.cu": {
        "srt_fixed_probe": (
            _I,                  # variant (probes/fixed.py::VARIANTS)
            _P, _P, _P, _P, _F,  # o, d, cam, tile origins, a
            _I, _I, _I, _I,      # n_tiles, tile_px, width, height
            _P, _P,              # t, idx
            _I, _P),             # threads, stream
    },
    "probe_attr.cu": {
        "srt_attr_gather": (
            _P, _P, _L, _P,      # bid, attribute table, rays, out
            _I, _P),             # threads, stream
        "srt_attr_window": (
            _P, _I, _P, _P,      # starts, windows per tile, bid, table
            _I, _I, _P,          # tiles, rays per tile, out
            _I, _P),             # threads, stream
    },
}
SOURCES = tuple(SIGNATURES)


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + (source,):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libsrt_{stem}_{_digest(source)}.so")


def build() -> dict:
    """Compile every source whose version is not built yet, one nvcc
    process per source, all started together.  Returns {"paths" (one
    library per source), "seconds" (wall time of the build), "log",
    "cached"}; ``log`` holds nvcc's output (with ``-Xptxas -v``: registers,
    shared memory and spills of each kernel)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {s: _lib_path(s) for s in SOURCES}
    todo = [s for s in SOURCES if not os.path.isfile(paths[s])]
    # a temporary name of this process's own: processes that build at once
    # never write one file
    tmp = {s: f"{paths[s]}.{os.getpid()}.tmp" for s in todo}
    t0 = time.time()
    procs = {s: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp[s],
         os.path.join(CSRC, s)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for s in todo}
    failed = []
    for s, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {s} failed ({proc.returncode}):\n{out}")
            continue
        with open(paths[s] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp[s], paths[s])
    if failed:
        raise RuntimeError("\n".join(failed))
    log = ""
    for s in SOURCES:
        if os.path.isfile(paths[s] + ".log"):
            with open(paths[s] + ".log") as f:
                log += f.read()
    return {"paths": [paths[s] for s in SOURCES],
            "seconds": time.time() - t0 if todo else 0.0, "log": log,
            "cached": not todo}


@functools.lru_cache(maxsize=1)
def library() -> types.SimpleNamespace:
    """The built kernels' C functions by name, loaded once per process."""
    build()
    fns = {}
    for source, sigs in SIGNATURES.items():
        lib = ctypes.CDLL(_lib_path(source))
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(**fns)


def check_operands(device, tile_px: int, threads: int, **operands) -> None:
    """Raise ValueError unless every operand, given as name=(tensor, dtype),
    is a contiguous tensor of that dtype on ``device``, and a tile of
    tile_px**2 rays splits into 1, 2, 4, 8 or 16 rays per thread."""
    check_tensors(device, **operands)
    tile = tile_px * tile_px
    if threads % 32 or tile % threads or tile // threads not in (1, 2, 4, 8,
                                                                 16):
        raise ValueError(f"tile {tile} does not split over {threads} threads")


def check_tensors(device, **operands) -> None:
    """Raise ValueError unless every operand, given as name=(tensor, dtype),
    is a contiguous tensor of that dtype on ``device``."""
    for name, (x, dtype) in operands.items():
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                             f"{device}, got {x.dtype} on {x.device}")


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
