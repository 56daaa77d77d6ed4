"""PreparedScene: the scene in BVH order + the tensors the tiled kernels read.

``prepare`` is a HOST step: the BVH build, the reorder and the padding run in
numpy, and the finished arrays are put on the device the caller names
(CUDA unless asked otherwise); ``PreparedScene.to(device)`` moves them.

Counterpart of the JAX package's ``accel/prepared.py::prepare``.  The JAX
PreparedScene also carries TPU matrix-unit operands (``gram``, ``gram_t``,
``gram_s``, ``attr_t``: Möller–Trumbore factors and bf16 attribute limbs laid
out for MXU contractions).  The port keeps the flattened BVH of the ``bvh``
mode (``node_min``, ``node_max``, ``skip``, ``leaf_first``,
``leaf_count``: the skip-pointer walk of accel/traverse.py) and one Gram
table, ``gram`` [Tp, 40]: each triangle's factors
(ops/intersect.py::pack_mt_gram, rows d, o×d, o, 1 by columns det, u, v, t)
in the order of ``tri``, because the bf16 classification walk K3
(kernels/prepass.py) states its error bound on the Gram contraction.  The
TPU layouts ``gram_t``, ``gram_s`` and ``attr_t`` stay out.  The other
kernels read a plain triangle layout: ``tri`` holds each triangle's first
vertex and two edges (w-divided here, so no kernel divides by w), and
``tri_attr`` the flat normal and object id that the nearest kernel gathers
by winner id.

The nearest kernel's textured and smooth-normal modes read one more row per
hit, by winner id: ``tri_tex_map`` and ``tri_nrm_map`` [Tp, 12] f32, the
per-triangle affine maps of :func:`uv_affine_np` (texel = A p + c for the
baked UVs, n_raw = An p + cn for the vertex normals).  JAX carries the same
values in ``attr_t`` as three bf16 limbs whose f32 sum is exact; here they
are plain f32, 48-byte rows the kernel reads as three float4 loads.

The paged walks (K6, K7; kernels/paged.py) read the same ``tri`` table in
PAGES of ``page_tris`` consecutive triangles (``page_tris / block_size``
consecutive blocks).  The JAX package packs each page into a Gram page and
keeps the per-triangle object ids in its row 10 for the occlusion kernel's
own-object skip; here ``block_obj`` already holds them, because per-object
padding to a ``page_tris`` multiple makes every block, hence every page,
single-object.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.intersect import pack_mt_gram
from ..scene.scene import Scene, scene_from_numpy
from ..utils.metrics import span
from .bvh import build_bvh, concat_bvhs, triangle_blocks


@dataclasses.dataclass
class PreparedScene:
    """Scene in BVH order, padded, with the cull blocks and kernel tables."""

    scene: Scene                # triangle arrays permuted leaf-contiguous, padded
    block_min: torch.Tensor     # [NB, 3] f32 — cull-block AABBs
    block_max: torch.Tensor     # [NB, 3] f32
    block_obj: torch.Tensor     # [NB] i32 — the one object of each block
    tri: torch.Tensor           # [Tp, 9] f32 — v0, e1 = v1 - v0, e2 = v2 - v0
    tri_attr: torch.Tensor      # [Tp, 4] f32 — flat normal xyz, object id
    gram: torch.Tensor          # [Tp, 40] f32 — Gram factors [10, 4] (K3)
    tri_tex_map: torch.Tensor   # [Tp, 12] f32 — Au, cu, Av, cv, tex id, 0 0 0
    tri_nrm_map: torch.Tensor   # [Tp, 12] f32 — cn xyz, An row-major
    node_min: torch.Tensor      # [M, 3] f32 — flattened BVH node AABBs,
    node_max: torch.Tensor      # [M, 3] f32   preorder over every object
    skip: torch.Tensor          # [M] i32 — next node on a miss or after a leaf
    leaf_first: torch.Tensor    # [M] i32 — a leaf's first triangle; -1 interior
    leaf_count: torch.Tensor    # [M] i32 — a leaf's triangles; 0 interior
    num_triangles: int = 0      # real (unpadded) triangle count
    block_size: int = 32
    page_tris: int = 128        # triangles per page of the paged walks
    max_leaf: int = 8           # the largest leaf (the walk's window rows)

    TENSOR_FIELDS = ("block_min", "block_max", "block_obj", "tri", "tri_attr",
                     "gram", "tri_tex_map", "tri_nrm_map", "node_min",
                     "node_max", "skip", "leaf_first", "leaf_count")

    @property
    def num_nodes(self) -> int:
        return int(self.skip.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.block_min.shape[0])

    @property
    def num_pages(self) -> int:
        return self.num_blocks * self.block_size // self.page_tris

    @property
    def device(self) -> torch.device:
        return self.tri.device

    def to(self, device) -> "PreparedScene":
        return dataclasses.replace(
            self, scene=self.scene.to(device),
            **{n: getattr(self, n).to(device) for n in self.TENSOR_FIELDS})


def target_device(device) -> torch.device:
    """``device`` as a torch.device; raises RuntimeError for a CUDA device
    on a machine without one (an entry point never carries on on the CPU
    unless asked to: pass device="cpu" for the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device "
                           f"is available (pass device='cpu' to run the "
                           f"plain PyTorch versions)")
    return dev


def kernel_tables(verts: np.ndarray, tri_normal: np.ndarray,
                  tri_obj: np.ndarray):
    """Host arrays of the padded scene -> (tri [Tp, 9], tri_attr [Tp, 4])."""
    vc = verts[..., :3] / verts[..., 3:4]
    tri = np.concatenate([vc[:, 0], vc[:, 1] - vc[:, 0], vc[:, 2] - vc[:, 0]],
                         axis=1).astype(np.float32)
    attr = np.concatenate([tri_normal, tri_obj[:, None].astype(np.float32)],
                          axis=1).astype(np.float32)
    return tri, attr


def gram_table(verts: np.ndarray) -> np.ndarray:
    """Host vertices [Tp, 3, 4] -> gram [Tp, 40]: the Gram factors [10, 4]
    of each w-divided triangle, row-major."""
    vc = (verts[..., :3] / verts[..., 3:4]).astype(np.float32)
    return pack_mt_gram(torch.from_numpy(vc)).reshape(-1, 40).numpy()


def uv_affine_np(verts_cart, uvs):
    """Per-triangle affine map of a per-vertex attribute over the triangle's
    plane: attr(p) = A p + c with A [T, K, 3], c [T, K] (JAX
    accel/prepared.py::uv_affine_np).  It is the Ericson-barycentric
    interpolation of ``uvs`` [T, 3, K] (ops/shading.py::barycentric, then
    interpolate_uv or smooth_normal's mix) refactored into constants, in
    float64, then rounded to f32.  Degenerate triangles (den ~ 0, the
    padding copies among them) take the constant map attr = uvs[:, 0]."""
    v = np.asarray(verts_cart, np.float64)
    t = np.asarray(uvs, np.float64)
    v0 = v[:, 0]
    e1 = v[:, 1] - v0
    e2 = v[:, 2] - v0
    d00 = (e1 * e1).sum(1)
    d01 = (e1 * e2).sum(1)
    d11 = (e2 * e2).sum(1)
    den = d00 * d11 - d01 * d01
    safe = np.abs(den) > 1e-30
    deni = np.where(safe, 1.0 / np.where(safe, den, 1.0), 0.0)[:, None]
    g1 = (d11[:, None] * e1 - d01[:, None] * e2) * deni  # grad of bary(v1)
    g2 = (d00[:, None] * e2 - d01[:, None] * e1) * deni  # grad of bary(v2)
    A = (t[:, 1] - t[:, 0])[:, :, None] * g1[:, None, :] \
        + (t[:, 2] - t[:, 0])[:, :, None] * g2[:, None, :]
    c = t[:, 0] - (A * v0[:, None, :]).sum(-1)
    return A.astype(np.float32), c.astype(np.float32)


def map_tables(verts: np.ndarray, uvs: np.ndarray, vnormals: np.ndarray,
               tri_tex: np.ndarray):
    """Host arrays of the padded scene -> (tri_tex_map [Tp, 12]: Au0..2,
    cu, Av0..2, cv, tex id, 0, 0, 0; tri_nrm_map [Tp, 12]: cn xyz, then An
    row-major), the rows the nearest kernel's textured and smooth-normal
    modes read by winner id."""
    vc = verts[..., :3] / verts[..., 3:4]
    n = vc.shape[0]
    A, c = uv_affine_np(vc, uvs)                         # [T, 2, 3], [T, 2]
    tex = np.concatenate([A[:, 0], c[:, 0:1], A[:, 1], c[:, 1:2],
                          tri_tex[:, None].astype(np.float32),
                          np.zeros((n, 3), np.float32)], axis=1)
    An, cn = uv_affine_np(vc, vnormals)                  # [T, 3, 3], [T, 3]
    nrm = np.concatenate([cn, An.reshape(n, 9)], axis=1)
    return tex.astype(np.float32), nrm.astype(np.float32)


# the flattened BVH's arrays (accel/bvh.py::FlatBVHHost) and their dtypes
NODE_FIELDS = {"node_min": np.float32, "node_max": np.float32,
               "skip": np.int32, "leaf_first": np.int32,
               "leaf_count": np.int32}


def _block_obj(tri_obj: np.ndarray, nb: int, bs: int) -> np.ndarray:
    """Per-block object id.  Per-object padding (``prepare``) makes every
    block single-object; padding rows (-1) do not count."""
    to = tri_obj.reshape(nb, bs)
    mx = to.max(axis=1) if nb else np.zeros((0,), np.int32)
    pure = np.all((to == mx[:, None]) | (to == -1), axis=1)
    if not pure.all():
        raise ValueError("impure cull block despite per-object padding")
    return mx.astype(np.int32)


def _finish(scene_np: Dict[str, np.ndarray], has_textures: bool,
            block_min, block_max, block_obj, nodes: Dict[str, np.ndarray],
            num_triangles: int, block_size: int, page_tris: int,
            device) -> PreparedScene:
    tri, attr = kernel_tables(scene_np["verts"], scene_np["tri_normal"],
                              scene_np["tri_obj"])
    gram = gram_table(scene_np["verts"])
    tex_map, nrm_map = map_tables(scene_np["verts"], scene_np["uvs"],
                                  scene_np["vnormals"], scene_np["tri_tex"])

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype, order="C"))
    return PreparedScene(
        scene=scene_from_numpy(scene_np, has_textures),
        block_min=t(block_min, np.float32), block_max=t(block_max, np.float32),
        block_obj=t(block_obj, np.int32), tri=t(tri, np.float32),
        tri_attr=t(attr, np.float32), gram=t(gram, np.float32),
        tri_tex_map=t(tex_map, np.float32), tri_nrm_map=t(nrm_map, np.float32),
        **{n: t(nodes[n], dt) for n, dt in NODE_FIELDS.items()},
        num_triangles=int(num_triangles),
        block_size=int(block_size), page_tris=int(page_tris),
        max_leaf=max(1, int(np.max(nodes["leaf_count"], initial=0)))
    ).to(device)


def prepare(scene: Scene, cfg: RenderConfig,
            device="cuda") -> PreparedScene:
    """Build per-object BVHs (reference topology or SAH), reorder the scene
    leaf-contiguous, pad every object to a ``page_tris`` multiple, and
    compute the cull blocks and kernel tables.  The host work runs in
    numpy; the result is put on ``device`` (raises without a CUDA device
    unless ``device`` is "cpu").

    Same arrays as the JAX package's ``prepare`` for the fields both keep
    (tests/test_torch_scene.py holds them equal)."""
    with span("srt.prepare"):
        return _prepare(scene, cfg, device)


def _prepare(scene: Scene, cfg: RenderConfig, device) -> PreparedScene:
    dev = target_device(device)
    sc = scene.numpy()
    verts_cart = sc["verts"][..., :3] / sc["verts"][..., 3:4]
    tri_obj = sc["tri_obj"]
    T = verts_cart.shape[0]

    def reorder(arrays, perm):
        out = dict(arrays)
        for name in ("verts", "vnormals", "tri_normal", "uvs", "tri_color",
                     "tri_tex", "tri_obj"):
            out[name] = arrays[name][perm]
        return out

    # object boundaries (SceneManager emits objects contiguously)
    if T and np.any(np.diff(tri_obj) < 0):
        order = np.argsort(tri_obj, kind="stable").astype(np.int32)
        sc = reorder(sc, order)
        verts_cart = verts_cart[order]
        tri_obj = tri_obj[order]

    bvhs, offsets = [], []
    start = 0
    with span("srt.prepare.bvh"):
        while start < T:
            end = start
            while end < T and tri_obj[end] == tri_obj[start]:
                end += 1
            bvhs.append(build_bvh(verts_cart[start:end], cfg.bvh.leaf_size,
                                  split=cfg.bvh.split))
            offsets.append(start)
            start = end
        if not bvhs:
            bvhs = [build_bvh(np.zeros((0, 3, 3), np.float32),
                              cfg.bvh.leaf_size)]
            offsets = [0]

    # Pad each OBJECT's triangle range to a page multiple so every cull block
    # and every aligned window of blocks is single-object: the any-hit
    # kernel's self-object skip then compares one id per block.  Pad rows
    # are degenerate copies of a real vertex of the same object: zero area
    # (MT det = 0, never hits) and inside the object's last block AABB.
    bs = cfg.bvh.block_size
    pt = cfg.bvh.page_tris
    if pt % bs:
        raise ValueError(f"page_tris {pt} must be a block_size {bs} multiple")
    counts = [len(b.perm) for b in bvhs]
    pcounts = [-(-c // pt) * pt for c in counts]
    poffsets = [0]
    for pc in pcounts[:-1]:
        poffsets.append(poffsets[-1] + pc)
    flat = concat_bvhs(bvhs, poffsets)
    Tp = poffsets[-1] + pcounts[-1]

    # gather map new padded position -> original triangle row (pads repeat
    # the object's last real triangle; their rows are degenerated below)
    src = np.zeros(Tp, np.int32)
    pad_mask = np.ones(Tp, bool)
    for b, c, pc, po, ro in zip(bvhs, counts, pcounts, poffsets, offsets):
        if c:
            src[po:po + c] = b.perm + ro
            src[po + c:po + pc] = int(b.perm[-1]) + ro
            pad_mask[po:po + c] = False
    sc = reorder(sc, src)

    # tail slack: the BVH walk's leaf windows read max_leaf rows from their
    # first triangle (accel/traverse.py), so keep the array that long
    pad_to = max(-(-max(Tp, 1) // pt) * pt, Tp + flat.max_leaf)
    pad_to = -(-pad_to // pt) * pt
    pad = pad_to - Tp
    if Tp and pad_mask.any():
        v0 = sc["verts"][pad_mask][:, 0:1, :]
        sc["verts"] = sc["verts"].copy()
        sc["verts"][pad_mask] = np.broadcast_to(
            v0, (int(pad_mask.sum()), 3, 4))
        for name, fill in (("vnormals", 0.0), ("tri_normal", 0.0),
                           ("uvs", 0.0), ("tri_color", 1.0)):
            sc[name] = sc[name].copy()
            sc[name][pad_mask] = fill
        sc["tri_tex"] = sc["tri_tex"].copy()
        sc["tri_tex"][pad_mask] = -1
        # tri_obj keeps the object id: block purity by construction
    if pad:
        last_v = (sc["verts"][-1, 0:1, :] if Tp
                  else np.array([[0, 0, 0, 1]], np.float32))
        sc["verts"] = np.concatenate(
            [sc["verts"], np.broadcast_to(last_v, (pad, 3, 4)).copy()], axis=0)
        for name, fill in (("vnormals", 0.0), ("tri_normal", 0.0),
                           ("uvs", 0.0), ("tri_color", 1.0)):
            a = sc[name]
            sc[name] = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
        for name in ("tri_tex", "tri_obj"):
            a = sc[name]
            sc[name] = np.concatenate(
                [a, np.full((pad,), -1, a.dtype)], axis=0)

    vc = sc["verts"][..., :3] / sc["verts"][..., 3:4]
    bmin, bmax, nb = triangle_blocks(vc, bs)
    return _finish(sc, scene.has_textures, bmin, bmax,
                   _block_obj(sc["tri_obj"], nb, bs),
                   {n: getattr(flat, n) for n in NODE_FIELDS}, T, bs, pt,
                   dev)


def from_jax_prepared(arrays: Dict[str, np.ndarray], has_textures: bool = False,
                      num_triangles: int = 0, block_size: int = 32,
                      page_tris: int = 128, device="cuda") -> PreparedScene:
    """The fields of a JAX ``PreparedScene`` that the port keeps, as numpy
    arrays keyed by name: every ``Scene`` field (its padded, BVH-ordered
    triangles) plus ``block_min``, ``block_max``, ``block_obj`` and the
    flattened BVH (``node_min``, ``node_max``, ``skip``, ``leaf_first``,
    ``leaf_count``) ->
    the port's :class:`PreparedScene` on ``device`` (as :func:`prepare`).
    Triangle ids then mean the same thing in both packages."""
    dev = target_device(device)
    dtypes = {"tri_tex": np.int32, "tri_obj": np.int32,
              "tex_offset": np.int32, "tex_width": np.int32,
              "tex_height": np.int32}
    sc = {n: np.asarray(arrays[n], dtypes.get(n, np.float32))
          for n in Scene.ARRAY_FIELDS}
    return _finish(sc, has_textures, arrays["block_min"], arrays["block_max"],
                   arrays["block_obj"], {n: arrays[n] for n in NODE_FIELDS},
                   num_triangles, block_size, page_tris, dev)
