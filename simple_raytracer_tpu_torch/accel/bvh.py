"""Host-side BVH build + flattening to a stackless (skip-pointer) layout.

The reference builds a pointer-based binary tree per object (Object.cpp:225-284)
and traverses it recursively, returning candidate-triangle COPIES per ray
(simple_raytracer.cpp:296-317) — hostile to lockstep SIMD hardware.  Here:

* Build (host, the median rule in C++: native/): same topology as the
  reference — sort triangle indices by ``pointOne`` along the node box's
  longest axis (Object.cpp:240-248, including its quirky tie rule), split
  at the count median (:254-255), leaf when count <= 8 (:261), and the
  root is ALWAYS split once (:282).
* Flatten: preorder node arrays with a skip ("miss") pointer.  Traversal is a
  bounded loop:  hit-interior -> i+1,  otherwise -> skip[i];  leaves test a
  contiguous triangle range.  Triangles are permuted leaf-contiguous so leaf
  ranges are gathers of consecutive rows.
* Multi-object scenes concatenate per-object subtrees; each subtree's skip
  pointers chain into the next object's root, so the WHOLE scene is one
  stackless walk (vs. the reference's per-object loop,
  simple_raytracer.cpp:409).

Also builds fixed-size triangle BLOCKS (post-reorder) with AABBs — the
culling granularity of the tiled renderer (kernels/plan.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..native import bvh_build_native

FLT_MAX = np.float32(3.4028235e38)


@dataclasses.dataclass
class FlatBVHHost:
    """Host (numpy) flattened BVH over the GLOBAL reordered triangle array."""

    node_min: np.ndarray    # [M, 3] f32
    node_max: np.ndarray    # [M, 3] f32
    skip: np.ndarray        # [M] i32 — next node on miss (or after a leaf)
    leaf_first: np.ndarray  # [M] i32 — first triangle (reordered index); -1 interior
    leaf_count: np.ndarray  # [M] i32 — 0 for interior nodes
    perm: np.ndarray        # [T] i32 — reordered_idx -> original triangle idx
    max_leaf: int
    depth: int


def _longest_axis(bmin: np.ndarray, bmax: np.ndarray) -> int:
    """Reference axis pick (Object.cpp:240-248): x only if strictly largest,
    else y only if strictly larger than BOTH others, else z.  (Ties fall
    through to z even when z is smallest — reproduced deliberately.)"""
    sx, sy, sz = np.abs(bmax - bmin)
    if sx > sy and sx > sz:
        return 0
    if sy > sx and sy > sz:
        return 1
    return 2


def _aabb(verts: np.ndarray, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """AABB over all vertices of the indexed triangles (Object.cpp:205-221).
    Empty sets produce the reference's inverted (FLT_MAX, -FLT_MAX) box, which
    no slab test ever hits."""
    if len(idx) == 0:
        return np.full(3, FLT_MAX, np.float32), np.full(3, -FLT_MAX, np.float32)
    v = verts[idx].reshape(-1, 3)
    return v.min(axis=0).astype(np.float32), v.max(axis=0).astype(np.float32)


def _sah_split(verts_cart: np.ndarray, cent: np.ndarray, idx: np.ndarray,
               n_bins: int = 16):
    """Binned surface-area-heuristic split of ``idx`` by triangle centroid.

    Returns (left_idx, right_idx) or None when no useful split exists
    (degenerate centroid extent / all-one-side) — caller falls back to the
    median rule.  The SAH tree is the 'sah' option of BVHConfig.split: the
    improvement over the reference's count-median
    (Object.cpp:254-255), giving tighter boxes for tile culling.
    """
    c = cent[idx]
    cmin, cmax = c.min(0), c.max(0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 0.0:
        return None
    bins = np.minimum(
        ((c[:, axis] - cmin[axis]) / ext[axis] * n_bins).astype(np.int64),
        n_bins - 1)
    tmin = verts_cart[idx].min(axis=1)        # per-tri AABB
    tmax = verts_cart[idx].max(axis=1)

    big = np.full(3, FLT_MAX, np.float32)
    bmin = np.full((n_bins, 3), FLT_MAX, np.float32)
    bmax = np.full((n_bins, 3), -FLT_MAX, np.float32)
    cnt = np.zeros(n_bins, np.int64)
    for b in range(n_bins):
        m = bins == b
        cnt[b] = m.sum()
        if cnt[b]:
            bmin[b] = tmin[m].min(0)
            bmax[b] = tmax[m].max(0)

    def area(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + \
            e[..., 2] * e[..., 0]

    lmin = np.minimum.accumulate(bmin, 0)
    lmax = np.maximum.accumulate(bmax, 0)
    rmin = np.minimum.accumulate(bmin[::-1], 0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], 0)[::-1]
    lcnt = np.cumsum(cnt)
    rcnt = cnt.sum() - lcnt
    # split AFTER bin s (s = 0..n_bins-2)
    cost = (area(lmin[:-1], lmax[:-1]) * lcnt[:-1] +
            area(rmin[1:], rmax[1:]) * rcnt[:-1])
    cost = np.where((lcnt[:-1] == 0) | (rcnt[:-1] == 0), np.inf, cost)
    s = int(np.argmin(cost))
    if not np.isfinite(cost[s]):
        return None
    lmask = bins <= s
    return idx[lmask], idx[~lmask]


def build_bvh(verts_cart: np.ndarray, leaf_size: int = 8,
              split: str = "median", *,
              use_native: bool = True) -> FlatBVHHost:
    """Build + flatten one object's BVH (see module docstring).

    ``split='median'`` reproduces the reference topology (Object.cpp:240-255),
    in the C++ builder (native/native.cpp::bvh_build: the same arrays, bit
    for bit) unless ``use_native`` is False, ``SRT_NO_NATIVE`` is set or the
    library cannot be built; then in numpy.  ``split='sah'`` is the binned
    surface-area-heuristic improvement, in numpy.

    Args:
      verts_cart: [T, 3, 3] Cartesian triangle vertices.
      leaf_size: reference triangleSizeStop = 8 (Object.cpp:261).
    """
    if split not in ("median", "sah"):
        raise ValueError(f"unknown BVH split rule: {split!r}")
    if use_native and split == "median":
        res = bvh_build_native(verts_cart, leaf_size)
        if res is not None:
            return FlatBVHHost(*res)
    T = verts_cart.shape[0]
    cent = verts_cart.mean(axis=1) if (split == "sah" and T) else None
    mins: List[np.ndarray] = []
    maxs: List[np.ndarray] = []
    skip: List[int] = []
    leaf_first: List[int] = []
    leaf_count: List[int] = []
    perm: List[int] = []
    stats = {"max_leaf": 0, "depth": 0}

    def emit(idx: np.ndarray, bmin, bmax, force_split: bool, depth: int) -> None:
        stats["depth"] = max(stats["depth"], depth)
        me = len(mins)
        mins.append(bmin)
        maxs.append(bmax)
        skip.append(-1)          # patched below
        if len(idx) > leaf_size or force_split:
            leaf_first.append(-1)
            leaf_count.append(0)
            left = right = None
            if split == "sah" and len(idx) > 1:
                lr = _sah_split(verts_cart, cent, idx)
                if lr is not None:
                    left, right = lr
            if left is None:
                # reference sort: by pointOne along the longest axis (stable
                # argsort; std::sort is unstable — topology may differ on
                # exact ties, candidate correctness does not)
                axis = _longest_axis(bmin, bmax)
                order = idx[np.argsort(verts_cart[idx, 0, axis],
                                       kind="stable")]
                half = len(order) // 2
                left, right = order[:half], order[half:]
            lmin, lmax = _aabb(verts_cart, left)
            rmin, rmax = _aabb(verts_cart, right)
            emit(left, lmin, lmax, False, depth + 1)
            emit(right, rmin, rmax, False, depth + 1)
        else:
            leaf_first.append(len(perm))
            leaf_count.append(len(idx))
            stats["max_leaf"] = max(stats["max_leaf"], len(idx))
            perm.extend(int(i) for i in idx)
        skip[me] = len(mins)     # preorder: skip = index after my subtree

    root_idx = np.arange(T, dtype=np.int64)
    rmin, rmax = _aabb(verts_cart, root_idx)
    # the reference ALWAYS splits the root once (Object.cpp:282), even for
    # tiny objects; empty objects become a single empty leaf
    emit(root_idx, rmin, rmax, force_split=T > 0, depth=0)

    return FlatBVHHost(
        node_min=np.stack(mins).astype(np.float32),
        node_max=np.stack(maxs).astype(np.float32),
        skip=np.asarray(skip, np.int32),
        leaf_first=np.asarray(leaf_first, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        perm=np.asarray(perm, np.int32),
        max_leaf=max(stats["max_leaf"], 1),
        depth=stats["depth"],
    )


def concat_bvhs(bvhs: List[FlatBVHHost], tri_offsets: List[int]) -> FlatBVHHost:
    """Concatenate per-object flattened BVHs into one global stackless array.

    ``tri_offsets[k]`` is object k's first triangle index in the global array.
    Node indices and skip pointers shift by the running node count, so every
    subtree's exit pointer chains to the next object's root; triangle indices
    shift by the object's triangle offset.
    """
    node_off = 0
    mins, maxs, skips, firsts, counts, perms = [], [], [], [], [], []
    max_leaf, depth = 1, 0
    for b, toff in zip(bvhs, tri_offsets):
        mins.append(b.node_min)
        maxs.append(b.node_max)
        skips.append(b.skip + node_off)
        firsts.append(np.where(b.leaf_first >= 0, b.leaf_first + toff, -1))
        counts.append(b.leaf_count)
        perms.append(b.perm + toff)
        node_off += len(b.skip)
        max_leaf = max(max_leaf, b.max_leaf)
        depth = max(depth, b.depth)
    return FlatBVHHost(
        node_min=np.concatenate(mins), node_max=np.concatenate(maxs),
        skip=np.concatenate(skips).astype(np.int32),
        leaf_first=np.concatenate(firsts).astype(np.int32),
        leaf_count=np.concatenate(counts).astype(np.int32),
        perm=np.concatenate(perms).astype(np.int32),
        max_leaf=max_leaf, depth=depth)


def triangle_blocks(verts_cart_reordered: np.ndarray, block_size: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Fixed-size triangle blocks over the BVH-reordered array.

    BVH preorder makes consecutive triangles spatially coherent, so block
    AABBs stay tight.  Returns (block_min [NB,3], block_max [NB,3], NB); the
    last block's slack is padded by the caller (degenerate triangles).
    """
    T = verts_cart_reordered.shape[0]
    NB = max(1, -(-T // block_size))
    bmin = np.full((NB, 3), FLT_MAX, np.float32)
    bmax = np.full((NB, 3), -FLT_MAX, np.float32)
    for b in range(NB):
        chunk = verts_cart_reordered[b * block_size:(b + 1) * block_size]
        if chunk.size:
            v = chunk.reshape(-1, 3)
            bmin[b] = v.min(axis=0)
            bmax[b] = v.max(axis=0)
    return bmin, bmax, NB
