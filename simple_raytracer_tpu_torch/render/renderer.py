"""Renderer front end: mode dispatch and the bruteforce oracle.

Counterpart of the JAX package's ``render/renderer.py``.  Modes
(``RenderConfig.mode``):

* ``"bruteforce"``: every ray x triangle pair, plain PyTorch; the exact
  oracle the other modes are held to.  Takes a Scene as it is (moved to the
  device) or a PreparedScene's scene.
* ``"bvh"``: the stackless flattened-BVH walk, plain PyTorch, batched over
  rays (accel/traverse.py).
* ``"tiled"``: per-tile cull plans and the hand-written CUDA kernels
  (kernels/tiled.py).

Bruteforce and BVH frames run in chunks of ``RenderConfig.ray_chunk`` rays
and launch none of the kernels in ``csrc/``: JAX runs them in jnp, with no
Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..accel.prepared import PreparedScene, prepare, target_device
from ..config import RenderConfig
from ..ops import intersect as isect
from ..ops.camera import (primary_rays, primary_rays_tiled,
                          primary_rays_world, untile_image)
from ..kernels import plan as pl
from ..kernels.tiled import render_flat_tiled, wants_rays
from ..utils import pad_rays
from ..utils.metrics import FRAME_SPAN, reset_counts, span
from . import integrator

MODES = ("bruteforce", "bvh", "tiled")

# ray x triangle pairs of one pass of the bruteforce walk.  Torch runs
# Möller–Trumbore one elementwise op at a time, and about twenty of its
# [rays, triangles] intermediates are alive at once; at 2**24 pairs each
# holds 64 MiB, so a pass stays near 1.5 GB of the card's memory.  The
# walk takes as many triangles a pass as this allows for its rays.
PAIRS_PER_PASS = 1 << 24


def _tris_per_pass(rays: int) -> int:
    return max(1, PAIRS_PER_PASS // max(rays, 1))


def brute_force_hits(scene, origin: torch.Tensor, direction: torch.Tensor,
                     eps: float = 1e-12, chunk: int = 0):
    """Nearest hit of flat rays [R, 3] against every triangle -> (t [R],
    idx [R] i32), +inf and -1 on a miss; ties go to the lowest index.

    Rays go ``chunk`` at a time (0: all at once); the triangles of each
    ray chunk go in passes of as many as ``PAIRS_PER_PASS`` allows, a
    running (t, idx) merged in ascending order with strict <, so the
    result is that of one pass over all triangles.  An empty scene (the
    missing-OBJ soft failure, Object.cpp:35-39) misses every ray."""
    verts = scene.verts_cart()
    R = origin.shape[0]
    if verts.shape[0] == 0:
        return (torch.full((R,), float("inf"), dtype=origin.dtype,
                           device=origin.device),
                torch.full((R,), -1, dtype=torch.int32,
                           device=origin.device))

    def hits(o, d):
        step = _tris_per_pass(o.shape[0])
        best_t = torch.full((o.shape[0],), float("inf"), dtype=o.dtype,
                            device=o.device)
        best_i = torch.full((o.shape[0],), -1, dtype=torch.int64,
                            device=o.device)
        for s in range(0, verts.shape[0], step):
            ts = isect.moller_trumbore(o[:, None, :], d[:, None, :],
                                       verts[None, s:s + step], eps)
            k = torch.argmin(ts, dim=-1)
            t = ts.gather(1, k[:, None])[:, 0]
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, k + s, best_i)
        return best_t, torch.where(torch.isinf(best_t), -1,
                                   best_i).to(torch.int32)

    if chunk and R > chunk:
        parts = [hits(origin[s:s + chunk], direction[s:s + chunk])
                 for s in range(0, R, chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return hits(origin, direction)


def brute_force_shadow(scene, eps: float = 1e-12, no_max_t: bool = True):
    """Shadow predicate over every triangle: (point [R, 3], light [R, 3],
    self_obj [R], hit) -> shadowed [R].  Reference semantics
    (simple_raytracer.cpp:321-342): the shadow ray starts at the hit point
    with direction light - point (unnormalized), and ANY finite
    Möller–Trumbore hit (t >= 0, no max-t) on another object shadows.
    ``no_max_t=False`` also requires t <= 1 (LightConfig.shadow_no_max_t).
    The triangles go in passes as in :func:`brute_force_hits`, the result
    an OR over them."""
    verts = scene.verts_cart()

    def shadow_fn(point, light, self_obj, hit=None):
        found = torch.zeros(point.shape[:1], dtype=torch.bool,
                            device=point.device)
        if verts.shape[0] == 0:
            return found
        d = light - point
        step = _tris_per_pass(point.shape[0])
        for s in range(0, verts.shape[0], step):
            ts = isect.moller_trumbore(point[:, None, :], d[:, None, :],
                                       verts[None, s:s + step], eps)
            occ = torch.isfinite(ts) & (scene.tri_obj[None, s:s + step]
                                        != self_obj[:, None])
            if not no_max_t:
                occ = occ & (ts <= 1.0)
            found = found | occ.any(dim=-1)
        return found

    return shadow_fn


def render_flat(scene, cfg: RenderConfig, origin, direction, light_pos,
                shadow_fn=None, hit_fn=None):
    """Bruteforce renderer over flat rays -> (radiance [R, 3], hit [R])."""
    if hit_fn is None:
        hit_fn = functools.partial(brute_force_hits, eps=cfg.mt_eps)
    if shadow_fn is None and cfg.light.enable_shadows:
        shadow_fn = brute_force_shadow(scene, eps=cfg.mt_eps,
                                       no_max_t=cfg.light.shadow_no_max_t)
    t, tri_idx = hit_fn(scene, origin, direction)
    radiance = integrator.shade(scene, cfg, origin, direction, t, tri_idx,
                                light_pos, shadow_fn)
    return radiance, torch.isfinite(t)


def _map_ray_chunks(body, o, d, chunk: int):
    """Run flat rays through ``body`` ``chunk`` rays at a time (a Python
    loop in place of JAX's lax.map), the last chunk padded with the last
    ray and the results cut back to R rays."""
    R = o.shape[0]
    if chunk <= 0 or R <= chunk:
        return body(o, d)
    o, d, _ = pad_rays(o, d, chunk)
    parts = [body(o[s:s + chunk], d[s:s + chunk])
             for s in range(0, o.shape[0], chunk)]
    rad = torch.cat([p[0] for p in parts])
    hit = torch.cat([p[1] for p in parts])
    return rad[:R], hit[:R]


def ensure_prepared(scene, cfg: RenderConfig, device="cuda"):
    """Host step.  Bruteforce takes a Scene as it is, moved to ``device``;
    the other modes prepare it onto ``device``.  Either raises without a
    CUDA device unless ``device`` is "cpu".  A PreparedScene stays as it
    is, on the device it is on."""
    if isinstance(scene, PreparedScene):
        return scene
    if cfg.mode == "bruteforce":
        return scene.to(target_device(device))
    return prepare(scene, cfg, device=device)


def render(scene, cfg: RenderConfig, light_pos, view_matrix=None,
           device="cuda") -> torch.Tensor:
    """Full-frame render -> [H, W, 3] uint8 (background-filled, quantized).
    Accepts a Scene (moved or prepared here onto ``device``: the card
    unless the caller asks for "cpu") or a PreparedScene (rendered on its
    device)."""
    operand = ensure_prepared(scene, cfg, device)
    with span(FRAME_SPAN):
        radiance, hit = render_radiance(operand, cfg, light_pos, view_matrix)
        return integrator.finalize_image(radiance, hit, cfg)


def render_radiance(scene, cfg: RenderConfig, light_pos, view_matrix=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float render -> (radiance [H, W, 3] in [0,1], hit [H, W]) on the
    device of ``scene``: a PreparedScene, or for bruteforce a Scene.

    With ``view_matrix`` (4x4, Transformation.cpp:84-90 convention) the
    camera moves in world space and the scene stays static: rays start at
    V[:3, 3] with directions V[:3, :3] @ (i, j, focal)."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown render mode: {cfg.mode}")
    if cfg.mode != "bruteforce" and not isinstance(scene, PreparedScene):
        raise TypeError(f"mode {cfg.mode!r} needs a PreparedScene; call "
                        "accel.prepared.prepare(scene, cfg) (or render()) "
                        "first")
    if cfg.mode == "tiled":
        return _render_tiled(scene, cfg, light_pos, view_matrix)
    cam = cfg.camera
    dev = scene.device
    if view_matrix is None:
        o, d = primary_rays(cam.width, cam.height, cam.focal,
                            cam.normalize_dirs, device=dev)
    else:
        o, d = primary_rays_world(cam.width, cam.height, view_matrix,
                                  cam.focal, cam.normalize_dirs, device=dev)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    light = torch.as_tensor(light_pos, dtype=d.dtype, device=dev)
    if cfg.mode == "bruteforce":
        flat = scene.scene if isinstance(scene, PreparedScene) else scene
        body = lambda oo, dd: render_flat(flat, cfg, oo, dd, light)
    else:
        from ..accel import traverse
        reset_counts("traverse.")
        body = lambda oo, dd: traverse.render_flat_bvh(scene, cfg, oo, dd,
                                                       light)
    radiance, hit = _map_ray_chunks(body, o, d, cfg.ray_chunk)
    return (radiance.reshape(cam.height, cam.width, 3),
            hit.reshape(cam.height, cam.width))


def _render_tiled(prep: PreparedScene, cfg: RenderConfig, light_pos,
                  view_matrix) -> Tuple[torch.Tensor, torch.Tensor]:
    cam = cfg.camera
    dev = prep.device
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    light = torch.as_tensor(light_pos, dtype=torch.float32, device=dev)
    vm = None if view_matrix is None else torch.as_tensor(
        view_matrix, dtype=torch.float32, device=dev)
    rays = None
    if wants_rays(prep, cfg, tpx * tpx):
        # every branch but the fused one starts from these rays, and so
        # does a range-only primary plan
        o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx,
                                        cam.focal, cam.normalize_dirs,
                                        view_matrix=vm, device=dev)
        rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    rad, hit = render_flat_tiled(prep, cfg, light,
                                 (vm, cam.focal, cam.width, cam.height, tpx),
                                 rays=rays)
    tx, ty = -(-cam.width // tpx), -(-cam.height // tpx)
    with span("srt.finish"):
        return (untile_image(rad, cam.width, cam.height, tpx, tx, ty),
                untile_image(hit, cam.width, cam.height, tpx, tx, ty))
