"""Geometry-sharded intersection on a ring of processes (JAX
``dist/ring.py``).

For scenes too large to replicate on one card the triangles are split over
the processes of a mesh axis ("gp").  Ray blocks then rotate around the
ring (``Axis.rotate``: ``batch_isend_irecv`` to the next process), each
step walking the resident shard and folding the result into a running
nearest-hit record that travels with the block.  After ``n`` rotations
every block is home with the global nearest hit: no triangle data moves,
the winner's attributes ride in the record.

Each rotation's nearest walk is K1 over the explicit rays of the block
(kernels/nearest.py::hits: ``schedule_kernel``, ``rays_walk_kernel``,
``rays_decode_kernel`` of csrc/nearest.cu) on the shard's own plan; each
rotation of the shadow is K7, the any-hit walk over 128-triangle pages
(kernels/tiled.py::tiled_shadow_fn over kernels/paged.py: ``anyhit.cu``).
A rotation's fold keeps a shard's hit only where it is strictly nearer
than the record's, so ties between shards go to the one the block met
first, in the ring's order, as in JAX.

The shards keep JAX's split of the triangles (scene order, ``n`` equal
chunks of a page multiple) but are prepared with the port's own per-object
BVH and page padding (accel/prepared.py::prepare), so every cull block
holds one object, as the any-hit walk's own-object skip needs (JAX keeps
mixed blocks and per-triangle object ids in its Gram pages).  The shards
are padded to one length with degenerate triangles of object -1.

``ring_nearest_hit_local`` and ``ring_any_hit_other_local`` run the same
folds with all ``n`` shards in one process, home block ``i`` visiting
shards i, i+1, ... in the ring's order: the ring's value without the
processes (NCCL takes one process per card, so this is how one card holds
a ring of several shards), equal to the ring's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..accel.bvh import triangle_blocks
from ..accel.prepared import (NODE_FIELDS, PreparedScene, _block_obj,
                              _finish, prepare, target_device)
from ..config import RenderConfig, default_config
from ..kernels import nearest, tiled
from ..ops import intersect as isect
from ..ops.camera import primary_rays
from ..render import integrator
from ..scene.scene import Scene, scene_from_numpy
from ..utils import pad_rays
from .sharding import Axis, Mesh, gather_slabs, slab, slab_index

# the per-triangle fields of a Scene (the rest are object and texture tables)
TRI_FIELDS = ("verts", "vnormals", "tri_normal", "uvs", "tri_color",
              "tri_tex", "tri_obj")
# a block on the wire: origin 3, direction 3, best t 1, then the record
NEAR_HEAD = 7


@dataclasses.dataclass
class GeometryShard:
    """One shard of the triangles: ``prep`` its PreparedScene (the tables
    the walks read: ``tri``, the block AABBs, ``block_obj``, pages of
    ``page_tris``), and the per-triangle records a winner carries home, in
    the order of ``prep``: ``rec_pack`` [Tl, 26] (vertices 9, vertex
    normals 9, uvs 6, object, texture) and ``rec_flat`` [Tl, 8] (the unit
    flat normal, object, texture, 3 zeros), as JAX ``ring.py:531-550``."""

    prep: PreparedScene
    rec_pack: torch.Tensor
    rec_flat: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.prep.device

    def to(self, device) -> "GeometryShard":
        return GeometryShard(self.prep.to(device), self.rec_pack.to(device),
                             self.rec_flat.to(device))


def _pad_prepared(prep: PreparedScene, length: int) -> PreparedScene:
    """``prep`` (on the CPU) with degenerate triangles of object -1 at the
    shard's last vertex appended up to ``length`` rows (a page multiple):
    they never hit and their blocks belong to no object."""
    pad = length - prep.scene.num_triangles
    if pad == 0:
        return prep
    sc = prep.scene.numpy()
    sc["verts"] = np.concatenate(
        [sc["verts"], np.broadcast_to(sc["verts"][-1, 0:1], (pad, 3, 4))])
    for name, fill in (("vnormals", 0.0), ("tri_normal", 0.0), ("uvs", 0.0),
                       ("tri_color", 1.0), ("tri_tex", -1), ("tri_obj", -1)):
        a = sc[name]
        sc[name] = np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
    bs = prep.block_size
    bmin, bmax, nb = triangle_blocks(sc["verts"][..., :3]
                                     / sc["verts"][..., 3:4], bs)
    return _finish(sc, prep.scene.has_textures, bmin, bmax,
                   _block_obj(sc["tri_obj"], nb, bs),
                   {n: getattr(prep, n).numpy() for n in NODE_FIELDS},
                   prep.num_triangles, bs, prep.page_tris, "cpu")


def _records(prep: PreparedScene):
    """(rec_pack, rec_flat) of a prepared shard, in numpy as JAX packs
    them (the flat normal is the unit cross product of the edges)."""
    sc = prep.scene.numpy()
    vs = (sc["verts"][..., :3] / sc["verts"][..., 3:4]).astype(np.float32)
    n = vs.shape[0]
    nrm = np.cross(vs[:, 1] - vs[:, 0], vs[:, 2] - vs[:, 0])
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    tn = (nrm / np.maximum(ln, 1e-30)).astype(np.float32)
    ids = [sc["tri_obj"][:, None].astype(np.float32),
           sc["tri_tex"][:, None].astype(np.float32)]
    pack = np.concatenate([vs.reshape(n, 9), sc["vnormals"].reshape(n, 9),
                           sc["uvs"].reshape(n, 6), *ids], axis=1)
    flat = np.concatenate([tn, *ids, np.zeros((n, 3), np.float32)], axis=1)
    return (torch.from_numpy(pack.astype(np.float32)),
            torch.from_numpy(flat.astype(np.float32)))


def shard_geometry(scene: Scene, n: int, cfg: Optional[RenderConfig] = None,
                   device="cuda") -> List[GeometryShard]:
    """HOST step: the scene's triangles in ``n`` shards (JAX
    ``ring.py::shard_geometry``: scene order, chunks of ceil(T / n)
    triangles rounded up to a page multiple, the last shards short or
    empty), each prepared with ``cfg``'s BVH settings (per-object BVHs and
    page padding, accel/prepared.py::prepare), padded to the longest with
    triangles of object -1, with its records; on ``device`` (raises
    without a CUDA device unless "cpu")."""
    dev = target_device(device)
    cfg = cfg or default_config()
    sc = scene.numpy()
    T = sc["verts"].shape[0]
    pt = cfg.bvh.page_tris
    Tl = -(-max(T, 1) // n)
    Tl = -(-Tl // pt) * pt
    preps = []
    for s in range(n):
        lo, hi = min(s * Tl, T), min((s + 1) * Tl, T)
        part = {k: (v[lo:hi] if k in TRI_FIELDS else v)
                for k, v in sc.items()}
        preps.append(prepare(scene_from_numpy(part, scene.has_textures), cfg,
                             device="cpu"))
    length = max(p.scene.num_triangles for p in preps)
    shards = []
    for p in preps:
        p = _pad_prepared(p, length)
        shards.append(GeometryShard(p, *_records(p)).to(dev))
    return shards


def strip_scene_tables(scene: Scene) -> Scene:
    """The scene with only its small replicated tables (materials, texture
    atlas): the triangle arrays emptied, so a geometry-sharded render does
    not replicate them."""
    empty = {k: getattr(scene, k)[:0] for k in TRI_FIELDS}
    return dataclasses.replace(scene, **empty)


def _decode_pack(pk: torch.Tensor, lean: bool) -> dict:
    """A block's packed records [R, 26 | 8] -> the shading record (JAX
    ``ring.py:115-129``)."""
    obj_col, tex_col = (3, 4) if lean else (24, 25)
    rec = {"obj": torch.round(pk[:, obj_col]).to(torch.int32),
           "tex_id": torch.round(pk[:, tex_col]).to(torch.int32)}
    if lean:
        rec["normal"] = pk[:, :3]
    else:
        rec["tri_v"] = pk[:, 0:9].reshape(-1, 3, 3)
        rec["vnormals"] = pk[:, 9:18].reshape(-1, 3, 3)
        rec["uvs"] = pk[:, 18:24].reshape(-1, 3, 2)
    return rec


def _ring(fold, blk: torch.Tensor, group: Axis, overlap: bool):
    """``group.size`` folds of a block around the ring, home again after
    as many rotations (JAX ``ring.py:216-242``).  ``overlap``: the block
    splits into halves A and B, and each rotation's transfer of one half
    is posted before the other half's fold and waited on after it; the
    same folds in the same order, so the same values."""
    n = group.size
    if overlap and n > 1:
        Rh = blk.shape[0] // 2
        A, B = fold(blk[:Rh]), blk[Rh:]
        for _ in range(n - 1):
            flying = group.rotate_start(A)       # A travels ...
            Bf = fold(B)                         # ... while B walks
            A2 = group.rotate_wait(flying)
            flying = group.rotate_start(Bf)      # B travels ...
            Af = fold(A2)                        # ... while A walks
            A, B = Af, group.rotate_wait(flying)
        return torch.cat([group.rotate(A), group.rotate(fold(B))])
    for _ in range(n):
        blk = group.rotate(fold(blk))
    return blk


def _ring_local(folds, blk: torch.Tensor) -> torch.Tensor:
    """:func:`_ring` of every home block with every shard here: slab i of
    ``blk`` (n = len(folds) slabs) folds shards i, i+1, ..., i+n-1 (mod n),
    as it would travel the ring."""
    n = len(folds)
    homes = []
    for i in range(n):
        b = slab(blk, i, n)
        for k in range(n):
            b = folds[(i + k) % n](b)
        homes.append(b)
    return torch.cat(homes)


def _near_fold(shard: GeometryShard, cfg: RenderConfig, tile: int,
               maxv: int, lean: bool, apex: bool):
    """One rotation of the nearest walk on ``shard``: K1 over the block's
    rays, then the strict-< fold into the record."""
    table = shard.rec_flat if lean else shard.rec_pack

    def fold(blk):
        o, d, best = blk[:, 0:3], blk[:, 3:6], blk[:, 6]
        t, li = nearest.hits(shard.prep, cfg, o, d, tile, maxv, apex=apex)
        better = t < best
        rec = torch.where(better[:, None], table[li.clamp_min(0).long()],
                          blk[:, NEAR_HEAD:])
        return torch.cat([o, d, torch.minimum(best, t)[:, None], rec], 1)
    return fold


def _near_block(o, d, lean: bool) -> torch.Tensor:
    """A home block before its first fold: t = inf, the record's object
    and texture -1."""
    width = 8 if lean else 26
    blk = torch.zeros((o.shape[0], NEAR_HEAD + width), dtype=torch.float32,
                      device=o.device)
    blk[:, 0:3], blk[:, 3:6], blk[:, 6] = o, d, float("inf")
    obj_col = NEAR_HEAD + (3 if lean else 24)
    blk[:, obj_col:obj_col + 2] = -1.0
    return blk


def _near_result(blk, o, d, eps: float, lean: bool):
    """(t, record) of a home block after its ring: the fixed-topology
    recompute where the record carries vertices (JAX ``ring.py:246-254``:
    t again at the winner, under autograd, from the caller's rays)."""
    t, rec = blk[:, 6], _decode_pack(blk[:, NEAR_HEAD:], lean)
    if "tri_v" in rec:
        t_rec = isect.moller_trumbore(o, d, rec["tri_v"], eps)
        t = torch.where(torch.isfinite(t) & torch.isfinite(t_rec), t_rec, t)
    return t, rec


def _walk_cfg(cfg, eps: float, no_max_t: bool = True) -> RenderConfig:
    cfg = cfg or default_config()
    return cfg.replace(mt_eps=eps, light=dataclasses.replace(
        cfg.light, shadow_no_max_t=no_max_t))


def ring_nearest_hit(shard: GeometryShard, o, d, group: Axis,
                     eps: float = 1e-12, tile: int = 256, maxv: int = 64,
                     lean: bool = False, *, apex: bool,
                     overlap: bool = False, cfg: RenderConfig = None):
    """Global nearest hit of this process's home block o, d [R, 3] over
    the shards of the ring ``group`` (``shard`` the resident one).

    ``apex``, which has no default: True only where every ray of every
    home block leaves one origin (primary rays of one camera), which lets
    the shard-local plans use the projective test; it is unsound for other
    rays.  ``lean`` (flat, untextured shading) carries the 8-wide records;
    otherwise the 26-wide ones, and t is recomputed at the winner.
    ``cfg`` gives the walk's KernelConfig (default: the defaults); ``eps``
    its Möller–Trumbore epsilon.  The walks run under ``no_grad``.
    ``overlap`` selects the half-block schedule (JAX's default, bit-equal
    to the plain one); the port defaults to the plain schedule, because
    on H100s its halves double the host-bound planner calls while the
    transfer they hide takes a fraction of a millisecond over NVLink
    (``scripts/torch_dist_cards.py`` times both).
    Returns (t [R], record dict)."""
    fold = _near_fold(shard, _walk_cfg(cfg, eps), tile, maxv, lean, apex)
    with torch.no_grad():
        blk = _ring(fold, _near_block(o.detach(), d.detach(), lean), group,
                    overlap)
    return _near_result(blk, o, d, eps, lean)


def ring_nearest_hit_local(shards: List[GeometryShard], o, d,
                           eps: float = 1e-12, tile: int = 256,
                           maxv: int = 64, lean: bool = False, *,
                           apex: bool, cfg: RenderConfig = None):
    """:func:`ring_nearest_hit` of the ``n`` home blocks o, d [R, 3] (R a
    multiple of n, block i the i-th contiguous slab) with every shard in
    this process: block i folds shards i, i+1, ..., i+n-1 (mod n).
    Returns (t [R], record dict)."""
    c = _walk_cfg(cfg, eps)
    with torch.no_grad():
        blk = _ring_local([_near_fold(s, c, tile, maxv, lean, apex)
                           for s in shards],
                          _near_block(o.detach(), d.detach(), lean))
    return _near_result(blk, o, d, eps, lean)


def _occ_fold(shard: GeometryShard, cfg: RenderConfig, tile: int, maxv: int):
    """One rotation of the shadow on ``shard``: K7 over page plans of the
    block's rays (tiled_shadow_fn with the paged implementation, one
    sample: the light-apex test), ORed into found."""
    shadow = tiled.tiled_shadow_fn(shard.prep, cfg, tile, maxv, 1,
                                   tiled.shadow_impl("paged"))

    def fold(blk):
        o, d = blk[:, 0:3], blk[:, 3:6]
        found = shadow(o, o + d, torch.round(blk[:, 6]).to(torch.int32),
                       hit=blk[:, 7] != 0) | (blk[:, 8] != 0)
        return torch.cat([blk[:, :8], found.to(blk.dtype)[:, None]], 1)
    return fold


def _occ_block(o, d, self_obj, hit) -> torch.Tensor:
    hit = (torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
           if hit is None else hit)
    return torch.cat([o, d, self_obj.to(torch.float32)[:, None],
                      hit.to(torch.float32)[:, None],
                      torch.zeros_like(o[:, :1])], 1)


def ring_any_hit_other(shard: GeometryShard, o, d, self_obj, group: Axis,
                       eps: float = 1e-12, no_max_t: bool = True,
                       hit=None, tile: int = 256, maxv: int = 64,
                       overlap: bool = False,
                       cfg: RenderConfig = None) -> torch.Tensor:
    """Shadow predicate over the ring: any hit (t >= 0; with ``no_max_t``
    False also t <= 1) of the rays o, d [R, 3] on a triangle of an object
    other than ``self_obj`` [R], on any shard.  ``hit`` [R] marks the rays
    whose origin is a real hit point (the shadow front end repairs the
    others from their tile's first hit).  ``overlap`` as in
    :func:`ring_nearest_hit`.  Returns found [R] bool."""
    fold = _occ_fold(shard, _walk_cfg(cfg, eps, no_max_t), tile, maxv)
    with torch.no_grad():
        blk = _ring(fold, _occ_block(o, d, self_obj, hit), group, overlap)
    return blk[:, 8] != 0


def ring_any_hit_other_local(shards: List[GeometryShard], o, d, self_obj,
                             eps: float = 1e-12, no_max_t: bool = True,
                             hit=None, tile: int = 256, maxv: int = 64,
                             cfg: RenderConfig = None) -> torch.Tensor:
    """:func:`ring_any_hit_other` of the ``n`` home blocks with every shard
    in this process, as :func:`ring_nearest_hit_local`."""
    c = _walk_cfg(cfg, eps, no_max_t)
    with torch.no_grad():
        blk = _ring_local([_occ_fold(s, c, tile, maxv) for s in shards],
                          _occ_block(o, d, self_obj, hit))
    return blk[:, 8] != 0


def _shade(scene, cfg: RenderConfig, o, d, light_pos, nearest_fn,
           occl_fn):
    lean = not scene.has_textures and not cfg.shading.smooth_normals
    t, rec = nearest_fn(lean)
    shadow_fn = None
    if cfg.light.enable_shadows:
        def shadow_fn(p, l, s, hit=None):
            return occl_fn(p, l - p, s, hit)
    radiance = integrator.shade_records(scene, cfg, rec, o, d, t, light_pos,
                                        shadow_fn)
    return radiance, torch.isfinite(t)


def render_flat_ring(scene: Scene, shard: GeometryShard, cfg: RenderConfig,
                     o, d, light_pos, group: Axis, *, apex: bool):
    """Geometry-sharded renderer of this process's home block o, d [R, 3]:
    ``scene`` supplies only the small replicated tables (materials, texture
    atlas), all triangle data lives in the shards.  ``apex`` as
    :func:`ring_nearest_hit`.  Returns (radiance [R, 3], hit [R])."""
    return _shade(
        scene, cfg, o, d, light_pos,
        lambda lean: ring_nearest_hit(shard, o, d, group, cfg.mt_eps,
                                      lean=lean, apex=apex, cfg=cfg),
        lambda p, dd, s, hit: ring_any_hit_other(
            shard, p, dd, s, group, cfg.mt_eps, cfg.light.shadow_no_max_t,
            hit=hit, cfg=cfg))


def render_flat_ring_local(scene: Scene, shards: List[GeometryShard],
                           cfg: RenderConfig, o, d, light_pos, *,
                           apex: bool):
    """:func:`render_flat_ring` of all ``n`` home blocks o, d [R, 3] (R a
    multiple of n) with every shard in this process."""
    return _shade(
        scene, cfg, o, d, light_pos,
        lambda lean: ring_nearest_hit_local(shards, o, d, cfg.mt_eps,
                                            lean=lean, apex=apex, cfg=cfg),
        lambda p, dd, s, hit: ring_any_hit_other_local(
            shards, p, dd, s, cfg.mt_eps, cfg.light.shadow_no_max_t,
            hit=hit, cfg=cfg))


def ring_frame(tables: Scene, shard: GeometryShard, cfg: RenderConfig,
               light_pos, mesh: Mesh, ray_axes,
               gp_axis: str) -> torch.Tensor:
    """A frame of the camera's row-major rays, sharded over ``ray_axes``,
    each process's home slab rotating around its ``gp_axis`` ring with its
    resident ``shard`` (on the mesh's device); ``tables`` the scene's
    small tables (:func:`strip_scene_tables`).  The frame is gathered and
    finished -> [H, W, 3] uint8 on every process."""
    dev = mesh.device
    n_rays = int(np.prod([mesh.shape[a] for a in ray_axes]))
    cam = cfg.camera
    o, d = primary_rays(cam.width, cam.height, cam.focal, cam.normalize_dirs,
                        device=dev)
    o, d, R = pad_rays(o.reshape(-1, 3), d.reshape(-1, 3), n_rays)
    k = slab_index(mesh, ray_axes)
    rad, hit = render_flat_ring(
        tables, shard, cfg, slab(o, k, n_rays), slab(d, k, n_rays),
        torch.as_tensor(light_pos, dtype=torch.float32, device=dev),
        mesh.axis(gp_axis), apex=True)
    full = gather_slabs(mesh, ray_axes,
                        torch.cat([rad, hit.to(rad.dtype)[:, None]], 1))
    H, W = cam.height, cam.width
    return integrator.finalize_image(full[:R, :3].reshape(H, W, 3),
                                     (full[:R, 3] != 0).reshape(H, W), cfg)


def _ring_frame(scene: Scene, cfg: RenderConfig, light_pos, mesh: Mesh,
                ray_axes, gp_axis: str) -> torch.Tensor:
    """:func:`ring_frame` with this process's shard of ``scene`` (every
    process shards the scene on the host and keeps its own)."""
    gp = mesh.axis(gp_axis)
    shard = shard_geometry(scene, gp.size, cfg, device="cpu")[gp.index]
    return ring_frame(strip_scene_tables(scene).to(mesh.device),
                      shard.to(mesh.device), cfg, light_pos, mesh, ray_axes,
                      gp_axis)


def render_geometry_sharded(scene: Scene, cfg: RenderConfig, light_pos,
                            mesh: Mesh, axis: str = "gp") -> torch.Tensor:
    """Full-frame render with the triangles sharded over ``mesh`` ``axis``
    and the ray blocks rotating around it (the scene too big to replicate).
    Returns [H, W, 3] uint8 on every process of the axis."""
    return _ring_frame(scene, cfg, light_pos, mesh, (axis,), axis)


def render_composed(scene: Scene, cfg: RenderConfig, light_pos, mesh: Mesh,
                    dp_axis: str = "dp", gp_axis: str = "gp") -> torch.Tensor:
    """Full-frame render over a 2-D mesh: the rays sharded over both axes
    (dp major), the triangles over ``gp_axis`` and replicated over
    ``dp_axis``; every process rotates its home block around its gp ring.
    Returns [H, W, 3] uint8 on every process."""
    return _ring_frame(scene, cfg, light_pos, mesh, (dp_axis, gp_axis),
                       gp_axis)
