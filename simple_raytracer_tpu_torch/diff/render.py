"""Differentiable rendering through the fast intersectors (JAX
``diff/render.py``).

The BVH walk and the tiled kernels have no useful gradient.  The
fixed-topology recompute: run the intersector under ``torch.no_grad()`` on
detached rays to get the winning triangle of each ray, then recompute
t = Möller–Trumbore(verts[winner]) under autograd.  The recomputed t equals
the kernel's up to rounding, and gradients flow from pixels to vertices,
materials, lights and textures through the shading stack.  The backward is
autograd through that recompute, as JAX's is its jnp VJP: no kernel of
``csrc/`` runs backward.

Gradients with respect to visibility (silhouette edges, occlusion flips,
shadow boundaries) are zero, because the hit topology is frozen.

The kernels read the tables of the PreparedScene made at prepare time
(``prep.tri``, the cull blocks), so they see the vertices as they were then;
the recompute reads ``prep.scene``'s current ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..accel.prepared import PreparedScene
from ..config import RenderConfig
from ..ops import intersect as isect
from ..ops.camera import primary_rays
from ..render import integrator


def detached(scene):
    """``scene`` (a Scene) with every tensor field detached from the
    autograd graph: the operand the intersectors read."""
    return dataclasses.replace(scene, **{
        n: getattr(scene, n).detach() for n in scene.ARRAY_FIELDS})


def winner_rows(idx: torch.Tensor) -> torch.Tensor:
    """The table row each ray reads: its winner, or for a miss the largest
    winner of the frame (a real triangle, where triangle 0 may be a
    degenerate one), so the shading of a miss, masked out later, stays
    finite and passes no NaN back (its upstream gradient is 0, but 0 * NaN
    is NaN)."""
    return torch.where(idx >= 0, idx, idx.max().clamp_min(0)).long()


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` by ``index_select``, whose backward adds each ray's
    gradient into its row with atomics.  The backward of ``table[rows]``
    sorts the rows and sums each row's run in one warp, serially: a
    frame's misses all read one row, and at 1080p that one run of ~1.5M
    rays took ~0.5 s a step (PERF.md §5)."""
    return torch.index_select(table, 0, rows)


def recompute_t(tri: torch.Tensor, idx: torch.Tensor, t_walk: torch.Tensor,
                origin: torch.Tensor, direction: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Differentiable t of rays [R, 3] at their winners' vertices ``tri``
    [R, 3, 3] (idx [R], -1 = miss).  Where the walk found no hit, or the
    recompute misses its winner (a ray on an edge of a triangle that has
    moved since the walk's tables were made), the walk's own verdict
    ``t_walk`` stands, without a gradient: JAX ``diff/render.py:44-46``
    says so in its comment, though its code writes inf there and turns
    such a hit into a miss.  A miss's triangle passes no gradient: its
    local derivatives may be inf (a ray in the triangle's plane)."""
    won = idx >= 0
    tri = torch.where(won[:, None, None], tri, tri.detach())
    t = isect.moller_trumbore(origin, direction, tri, eps)
    return torch.where(won & torch.isfinite(t), t, t_walk.detach())


def differentiable_hits(hit_fn: Callable, verts_cart: torch.Tensor,
                        origin: torch.Tensor, direction: torch.Tensor,
                        eps: float = 1e-12
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Make any nearest-hit intersector differentiable at fixed topology.

    ``hit_fn`` (o, d) -> (t, idx) runs under ``no_grad`` on detached rays;
    ``verts_cart`` [T, 3, 3] are the differentiable vertices, in the order
    of the indices ``hit_fn`` reports.  Returns (t, idx) with t
    differentiable with respect to verts_cart, origin and direction."""
    with torch.no_grad():
        t_walk, idx = hit_fn(origin.detach(), direction.detach())
    tri = gather_rows(verts_cart, winner_rows(idx))
    return recompute_t(tri, idx, t_walk, origin, direction, eps), idx


def _intersectors(prep_or_scene, cfg: RenderConfig, flat: bool, apex: bool):
    """(hit_fn, shadow_fn or None) of ``cfg.mode`` over the detached
    operand; the shadow function takes the integrator's contract."""
    from ..render.renderer import brute_force_hits, brute_force_shadow
    lcfg = cfg.light
    if isinstance(prep_or_scene, PreparedScene):
        op = dataclasses.replace(prep_or_scene,
                                 scene=detached(prep_or_scene.scene))
        scene = op.scene
    else:
        op = scene = detached(prep_or_scene)
    if cfg.mode == "bruteforce":
        def hit_fn(o, d):
            return brute_force_hits(scene, o, d, cfg.mt_eps, cfg.ray_chunk)
        shadow_fn = brute_force_shadow(scene, cfg.mt_eps,
                                       lcfg.shadow_no_max_t)
    elif cfg.mode in ("bvh", "tiled") and not isinstance(op, PreparedScene):
        raise TypeError(f"mode {cfg.mode!r} needs a PreparedScene")
    elif cfg.mode == "bvh":
        from ..accel import traverse

        def hit_fn(o, d):
            return traverse.bvh_hits(op, o, d, cfg.mt_eps)
        shadow_fn = traverse.bvh_shadow_fn(op, cfg.mt_eps,
                                           lcfg.shadow_no_max_t)
    elif cfg.mode == "tiled":
        from ..kernels import nearest, paged, tiled
        from ..kernels import plan as pl
        if cfg.tiled_impl not in tiled.IMPLS:
            raise ValueError(f"unknown tiled kernel impl {cfg.tiled_impl!r}")
        tpx = pl.effective_tile_px(cfg, scene.num_triangles)
        tile = tpx * tpx
        htile = tiled._hit_tile(cfg, tile)
        maxv = pl.effective_cull_maxv(cfg, op.num_blocks,
                                      cfg.kernel.window_blocks)
        # the frame's own rays are primaries: they share one origin
        apx = apex or not flat
        paged_impl = cfg.tiled_impl == "paged"

        def hit_fn(o, d):
            if paged_impl:
                return paged.hits(op, cfg, o, d, htile, maxv, apex=apx)
            return nearest.hits(op, cfg, o, d, htile, maxv, apex=apx)
        stile = pl.shadow_tile(cfg, tile, op.num_blocks * op.block_size)
        shadow_fn = tiled.tiled_shadow_fn(
            op, cfg, stile, maxv, lcfg.num_samples,
            tiled.shadow_impl("paged" if paged_impl else None))
    else:
        raise ValueError(f"unknown render mode: {cfg.mode}")
    if not lcfg.enable_shadows:
        return hit_fn, None

    def shadow(point, light, self_obj, hit=None):
        with torch.no_grad():
            return shadow_fn(point.detach(), light.detach(), self_obj,
                             hit=hit)
    return hit_fn, shadow


def render_radiance_diff(prep_or_scene, cfg: RenderConfig, light_pos,
                         origin: Optional[torch.Tensor] = None,
                         direction: Optional[torch.Tensor] = None,
                         apex: bool = False):
    """Differentiable float render through the configured intersector.

    The output contract of ``render.renderer.render_radiance``: (radiance
    [H, W, 3], hit [H, W]) of the camera's primary rays, or flat [R, 3] and
    [R] for the rays ``origin``, ``direction`` [R, 3].  Every mode carries
    gradients to the scene's tensors (a Scene for ``"bruteforce"``, a
    PreparedScene's ``scene`` for every mode) and to ``light_pos`` through
    the fixed-topology recompute.

    ``apex``: the explicit rays share one origin (primary rays), so the
    tiled plans may use the projective test; unsound for rays that do not.
    The tiled walks are kernels/table.py's; under
    ``table.using(table.plain())`` the same render runs the plain walks.

    Untextured scenes without smooth normals and with at most 8 objects
    take the lean path (JAX ``:126-160``): one [T, 13] table (the vertices,
    whose 9 columns carry gradients, the flat normal, the object id)
    gathered once by the winners, and the materials by
    ``integrator.material_select``, so the backward scatters into one
    table.  Other scenes gather their records by
    ``integrator.gather_hit_records``."""
    is_prep = isinstance(prep_or_scene, PreparedScene)
    scene = prep_or_scene.scene if is_prep else prep_or_scene
    dev = scene.device
    cam = cfg.camera
    flat = origin is not None
    if flat:
        o, d = origin, direction
    else:
        o, d = primary_rays(cam.width, cam.height, cam.focal,
                            cam.normalize_dirs, device=dev)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    light_pos = torch.as_tensor(light_pos, dtype=d.dtype, device=dev)
    hit_fn, shadow_fn = _intersectors(prep_or_scene, cfg, flat, apex)
    verts_cart = scene.verts_cart()
    lean = (not scene.has_textures and not cfg.shading.smooth_normals
            and scene.num_objects <= 8 and scene.num_triangles > 0)
    if lean:
        with torch.no_grad():
            t_walk, idx = hit_fn(o.detach(), d.detach())
        table = torch.cat([verts_cart.reshape(-1, 9),
                           scene.tri_normal.detach(),
                           scene.tri_obj.detach().to(torch.float32)[:, None]],
                          dim=1)
        packed = gather_rows(table, winner_rows(idx))    # ONE [R, 13] gather
        t = recompute_t(packed[:, :9].reshape(-1, 3, 3), idx, t_walk, o, d,
                        cfg.mt_eps)
        obj = torch.round(packed[:, 12].detach()).to(torch.int32)
        record = {"obj": obj, "tex_id": torch.full_like(obj, -1),
                  "normal": packed[:, 9:12].detach()}
        record.update(integrator.material_select(scene, obj))
    else:
        t, idx = differentiable_hits(hit_fn, verts_cart, o, d, cfg.mt_eps)
        record = None
        if scene.num_triangles and scene.num_objects:
            record = integrator.gather_hit_records(scene, winner_rows(idx),
                                                   cfg, gather=gather_rows)
    radiance = integrator.shade(scene, cfg, o, d, t, idx, light_pos,
                                shadow_fn, record=record)
    hit = torch.isfinite(t)
    if flat:
        return radiance, hit
    return (radiance.reshape(cam.height, cam.width, 3),
            hit.reshape(cam.height, cam.width))
