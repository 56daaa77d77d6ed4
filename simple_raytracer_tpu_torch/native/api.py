"""numpy-facing wrappers over the native library (ctypes)."""

from __future__ import annotations

import codecs
import locale

import numpy as np

from .build import get_lib


def bvh_build_native(verts_cart: np.ndarray, leaf_size: int):
    """Native median BVH build; returns the Python builder's fields as
    (node_min, node_max, skip, leaf_first, leaf_count, perm, max_leaf,
    depth), or None if the library is unavailable or a vertex is NaN (the
    C++ sort has no order for NaN; numpy's puts it last)."""
    lib = get_lib()
    if lib is None:
        return None
    T = int(verts_cart.shape[0])
    v = np.ascontiguousarray(verts_cart.reshape(T, 9), dtype=np.float32)
    if np.isnan(v).any():
        return None
    max_nodes = max(2 * T + 2, 8)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    skip = np.empty((max_nodes,), np.int32)
    leaf_first = np.empty((max_nodes,), np.int32)
    leaf_count = np.empty((max_nodes,), np.int32)
    perm = np.empty((max(T, 1),), np.int32)
    stats = np.zeros((2,), np.int32)
    M = lib.bvh_build(v, T, int(leaf_size), node_min, node_max, skip,
                      leaf_first, leaf_count, perm, max_nodes, stats)
    if M < 0:
        return None
    return (node_min[:M].copy(), node_max[:M].copy(), skip[:M].copy(),
            leaf_first[:M].copy(), leaf_count[:M].copy(), perm[:T].copy(),
            int(stats[0]), int(stats[1]))


def _text_is_utf8() -> bool:
    # the encoding of open(path, "r"), as the Python scan opens the file
    return codecs.lookup(locale.getpreferredencoding(False)).name == "utf-8"


def obj_parse_native(path: str):
    """Native OBJ scan, the same arrays as
    ``scene/obj_loader.py::_parse_obj_python``: (positions [NV,3] f32,
    texcoords [NT,2] f32, normals [NN,3] f32, faces [NF,3,3] i32 (corner x
    (v,t,n)), face_mtl [NF] i32, usemtl names).  None when the library is
    unavailable or the scan defers (a line it cannot read exactly as
    Python does, or on which Python raises; see native.cpp::obj_scan), and
    the caller then runs the Python scan."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    # bytes outside ASCII decode as UTF-8 in the scan's model of Python
    if not data.isascii() and not _text_is_utf8():
        return None
    counts = np.zeros((5,), np.int64)
    if lib.obj_scan(data, len(data), counts, None, None, None, None, None,
                    None) != 0:
        return None
    nv, nt, nn, nf, nb = (int(c) for c in counts)
    # one row at least: the fill pass is told apart by a non-null pointer
    positions = np.zeros((max(nv, 1), 3), np.float32)
    texcoords = np.zeros((max(nt, 1), 2), np.float32)
    normals = np.zeros((max(nn, 1), 3), np.float32)
    faces = np.zeros((max(nf, 1), 9), np.int32)
    face_mtl = np.zeros((max(nf, 1),), np.int32)
    names = np.zeros((max(nb, 1),), np.uint8)
    if lib.obj_scan(data, len(data), counts, positions.ctypes.data,
                    texcoords.ctypes.data, normals.ctypes.data,
                    faces.ctypes.data, face_mtl.ctypes.data,
                    names.ctypes.data) != 0:
        return None
    usemtl = names[:nb].tobytes().decode("ascii").split("\n")[:-1]
    return (positions[:nv], texcoords[:nt], normals[:nn],
            faces[:nf].reshape(nf, 3, 3), face_mtl[:nf], usemtl)
