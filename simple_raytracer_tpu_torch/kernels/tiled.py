"""The tiled frame and its shadow front end.

Counterpart of the JAX package's ``kernels/tiled.py::render_flat_tiled``
(lines 1496-1666), in five branches.  K1 rebuilds the primary rays from
the pixels (the "iota") where the directions are not normalized, the
nearest pass walks the whole pixel tile (``hit_tile``) and the plan has
list capacity (``cull_maxv`` > 0); every other frame walks its explicit
primary rays.

* **fused** (flat, textured or smooth-normal, not both; one light sample,
  fused Phong, the iota; shadow tile = primary tile and at most 65,536
  any-hit windows): primary plan -> K1 with fused Phong and bounds rows
  (attribute mode 0 flat, 1 textured: the colour-free factors and texel
  coordinates, then the texel finish; 2 smooth normals) -> shadow plan
  from the bounds -> K2 rebuilds the shadow rays from t -> shadow dim ->
  tone map;
* **legacy** (as fused, with another shadow tile, e.g. the 256-ray tiles
  of scenes over 131,072 triangles, ``KernelConfig.fused_shadow`` off, or
  more than 65,536 any-hit windows): fused K1, then the hard shadow of
  explicit rays from the hit points, :func:`tiled_shadow_fn` -> K2′;
* **soft** (flat, untextured, list capacity; num_samples > 1,
  ``fused_phong`` off, or no iota: ``hit_tile`` sub-tiles, normalized
  directions): K1 in its fetch mode (over the explicit rays at the
  nearest-pass tile where there is no iota) -> records ->
  ``integrator.shade`` with the S-sample shadow (folded when S > 1; K2′);
* **gather** (``prepass``, ``groups`` > 1, ``attr_fetch`` off or
  ``cull_maxv`` <= 0; textured or smooth-normal frames that cannot fuse,
  and every frame of a scene both textured and smooth-normal): the nearest
  walk of kernels/nearest.py::hits at the nearest-pass tile (K1's fetch
  mode; K3 then K1 over the refined plan; K4; or K1 over the explicit
  rays, over range-only plans where ``cull_maxv`` <= 0) ->
  :func:`tiled_shadow_fn` (K2′, or K5 with ``groups_ah`` > 1) ->
  ``integrator.shade`` by winner id (JAX ``tiled.py:1654-1666``: the
  record gather; on the card csrc/shade.cu);
* **paged** (``RenderConfig.tiled_impl="paged"``; any scene kind, any S):
  the page plan of the primary rays at the nearest-pass tile (pure page
  ranges where ``cull_maxv`` <= 0) -> K6 -> :func:`tiled_shadow_fn` over
  page plans (K7) -> ``integrator.shade`` by winner id.

Plans over more than 65,536 windows (or pages) are range-only
(kernels/plan.py::range_only), built from the explicit rays.  The first
four branches are the JAX "sublane" layout (``kernels/tiled_t.py``).  JAX
gates its fetch and fused branches on TPU memory as well (``_resident``,
``_fetch_vmem_ok``); the port has no such gates.
"""

from __future__ import annotations

import types

import torch

from ..config import RenderConfig
from ..ops import shading as sh
from ..render import integrator
from ..utils.metrics import span
from . import paged
from . import plan as pl
from .anyhit import anyhit, anyhit_from_t
from .nearest import FLAT, TEXTURED, attr_mode, hits, hits_attrs, hits_shaded

IMPLS = (None, "sublane", "paged")


def _uses_iota(cfg: RenderConfig, tile: int, camera: bool = True) -> bool:
    """Whether K1 rebuilds the frame's primary rays from the pixels (JAX
    tiled_t._use_iota with the renderer's cam_spec): a camera to rebuild
    them from, directions not normalized (JAX drops cam_spec then), the
    nearest pass at the whole pixel tile, list capacity."""
    return (camera and not cfg.camera.normalize_dirs and cfg.cull_maxv > 0
            and _hit_tile(cfg, tile) == tile)


def _takes_gather(prep, cfg: RenderConfig, tile: int,
                  camera: bool = True) -> bool:
    """Whether a sublane frame takes the gather branch (JAX tiled.py:
    1538-1558, 1646-1657 without the TPU memory gates): no fetch without
    list capacity, and the fused modes other than flat have no fetch
    branch.  A scene both textured and smooth-normal has no fused mode
    (JAX's prepare gives it no attribute layout, accel/prepared.py:
    538-545), so it always gathers."""
    kc = cfg.kernel
    if (kc.prepass or kc.nearest_groups > 1 or not kc.attr_fetch
            or cfg.cull_maxv <= 0):
        return True
    mode = attr_mode(prep, cfg)
    return mode is None or (mode != FLAT and (
        cfg.light.num_samples > 1 or not kc.fused_phong
        or not _uses_iota(cfg, tile, camera)))


def check_supported(prep, cfg: RenderConfig, tile: int) -> None:
    """Raise ValueError for an unknown ``tiled_impl`` or a ``hit_tile``
    that is no sub-tile of ``tile``."""
    if cfg.tiled_impl not in IMPLS:
        raise ValueError(f"unknown tiled kernel impl {cfg.tiled_impl!r}")
    _hit_tile(cfg, tile)


def _hit_tile(cfg: RenderConfig, tile: int) -> int:
    """Nearest-pass ray-tile size (JAX kernels/tiled.py::_hit_tile):
    ``hit_tile`` 0, or any value of at least ``tile``, is the full tile; a
    sub-tile divides the tile and is a multiple of 128 rays.  Raises
    ValueError for any other value."""
    ht = cfg.hit_tile
    if not ht or ht >= tile:
        return tile
    if tile % ht or ht % 128:
        raise ValueError(f"hit_tile {ht} is no sub-tile of {tile}-ray tiles")
    return ht


def frame_branch(prep, cfg: RenderConfig, tile: int,
                 camera: bool = True) -> str:
    """"fused", "legacy", "soft", "gather" or "paged": the branch a frame
    of primary tiles of ``tile`` rays takes (see the module docstring);
    with ``camera`` False, that of primary rays given with no camera to
    rebuild them from (JAX's ``cam_spec=None``): never the fused or the
    legacy branch."""
    check_supported(prep, cfg, tile)
    if cfg.tiled_impl == "paged":
        return "paged"
    if _takes_gather(prep, cfg, tile, camera):
        return "gather"
    if (cfg.light.num_samples > 1 or not cfg.kernel.fused_phong
            or not _uses_iota(cfg, tile, camera)):
        return "soft"
    ntris = prep.num_blocks * prep.block_size
    if (cfg.light.enable_shadows and prep.scene.num_objects > 1
            and (pl.shadow_tile(cfg, tile, ntris) != tile
                 or not cfg.kernel.fused_shadow
                 or pl.range_only(cfg.cull_maxv, prep.num_blocks
                                  // cfg.kernel.window_blocks_ah))):
        return "legacy"
    return "fused"


def wants_rays(prep, cfg: RenderConfig, tile: int) -> bool:
    """Whether :func:`render_flat_tiled` needs the frame's primary rays:
    every branch but the fused one, and a fused frame whose primary plan
    is range-only (more than 65,536 windows), which is built from them."""
    return (frame_branch(prep, cfg, tile) != "fused"
            or pl.range_only(cfg.cull_maxv, prep.num_blocks
                             // cfg.kernel.window_blocks))


def _cull_occl_windows(prep, cfg, o, d, tile: int, maxv: int, excl=None,
                       apex_rev: bool = False):
    """The sublane occlusion plan: windows of window_blocks_ah blocks, with
    the sub-group mask words when ``groups_ah`` > 1."""
    return pl.cull_occl(prep, o, d, tile, maxv, cfg.kernel.window_blocks_ah,
                        excl, apex_rev=apex_rev,
                        groups=cfg.kernel.anyhit_groups)


def _anyhit_windows(prep, cfg, o, d, self_obj2d, plan, tile: int):
    """The sublane occlusion walk: K2′, or K5 when ``groups_ah`` > 1."""
    return anyhit(prep, cfg, o, d, self_obj2d, plan, tile,
                  groups=cfg.kernel.anyhit_groups)


def shadow_impl(name=None):
    """The occlusion backend :func:`tiled_shadow_fn` reaches through
    ``cull_occl(prep, cfg, o, d, tile, maxv, excl, apex_rev=)`` and
    ``anyhit(prep, cfg, o, d, self_obj2d, plan, tile)`` (JAX ``impl``):
    "paged" plans pages for K7, the sublane default plans windows for K2′
    (K5 with sub-groups)."""
    if name == "paged":
        return types.SimpleNamespace(cull_occl=paged.cull_occl,
                                     anyhit=paged.anyhit)
    return types.SimpleNamespace(cull_occl=_cull_occl_windows,
                                 anyhit=_anyhit_windows)


def _first_hit_repair(p3, h2, s2):
    """Per tile: a miss ray's origin and self id become those of the tile's
    first hit, so the cull bounds and the tile's purity see real hits only.
    p3 [nt, ts, 3], h2 and s2 [nt, ts] -> (p3, s2, any_hit [nt])."""
    first = h2.to(torch.uint8).argmax(dim=1)
    rows = torch.arange(h2.shape[0], device=h2.device)
    p3 = torch.where(h2[..., None], p3, p3[rows, first][:, None, :])
    s2 = torch.where(h2, s2, s2[rows, first][:, None])
    return p3, s2, h2.any(dim=1)


def _pure_excl(s2):
    """Each tile's own object where every ray leaves it, else -2."""
    pure = (s2 == s2[:, :1]).all(dim=1)
    return torch.where(pure, s2[:, 0], -2).to(torch.int32)


def _pad_rows(x, pad: int, fill=None):
    """x [R, ...] with ``pad`` rows appended: ``fill`` or the last row."""
    if not pad:
        return x
    tail = (x[-1:].expand(pad, *x.shape[1:]) if fill is None
            else torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                            device=x.device))
    return torch.cat([x, tail])


def tiled_shadow_fn(prep, cfg: RenderConfig, tile: int, maxv: int,
                    num_samples: int = 1, impl=None):
    """Occlusion backend of the integrator's shadow contract (JAX
    kernels/tiled.py::tiled_shadow_fn): ``shadow(point [R, 3], light
    [R, 3], self_obj [R], hit=None) -> found [R] bool``.

    One sample (S = 1): every light row is one shared light.  Miss origins
    and their self ids are repaired from the tile's first hit, a tile whose
    rays all leave one object drops that object's blocks, the plan adds the
    light-apex test, and hitless tiles walk nothing.  S > 1: rays arrive
    sample-major and go to :func:`_shadow_folded`.  ``impl``
    (:func:`shadow_impl`; None: the sublane one) plans and walks."""
    impl = impl or shadow_impl()

    def shadow(point, light, self_obj, hit=None):
        S = num_samples
        if S > 1 and point.shape[0] % S == 0:
            return _shadow_folded(prep, cfg, tile, maxv, S, point, light,
                                  self_obj, hit, impl)
        with span("srt.plan.shadow"):
            so = self_obj.to(torch.int32)
            if hit is not None:
                R0 = point.shape[0]
                padn = (-R0) % tile
                point = _pad_rows(point, padn, 0.0)
                hit = _pad_rows(hit, padn, False)
                so = _pad_rows(so, padn)
                nt = point.shape[0] // tile
                p3, s2, any_hit = _first_hit_repair(
                    point.reshape(nt, tile, 3), hit.reshape(nt, tile),
                    so.reshape(nt, tile))
                point, so = p3.reshape(-1, 3)[:R0], s2.reshape(-1)[:R0]
            d = light - point
            R = point.shape[0]
            n = -(-R // tile)
            s2 = _pad_rows(so, n * tile - R).reshape(n, tile)
            plan = impl.cull_occl(prep, cfg, point, d, tile, maxv,
                                  _pure_excl(s2), apex_rev=True)
            if hit is not None:
                plan = torch.where(any_hit[:, None], plan, 0)
        found = impl.anyhit(prep, cfg, point, d, s2, plan, tile)
        return found.reshape(-1)[:R]

    return shadow


def _shadow_folded(prep, cfg, tile, maxv, S, point, light, self_obj, hit,
                   impl):
    """S-sample occlusion sharing one plan per point tile (JAX
    kernels/tiled.py::_shadow_folded).  Rays arrive sample-major [S * R]
    with the points repeated per sample; a kernel tile is ts points x S
    samples, ts = max(8, min(tile, 1024 // S)), as M = S * ts rows ordered
    sample-major within the tile.  found comes back sample-major."""
    R = point.shape[0] // S
    ts = max(8, min(tile, 1024 // S))
    with span("srt.plan.shadow"):
        padn = (-R) % ts
        p0 = _pad_rows(point[:R], padn, 0.0)
        self0 = _pad_rows(self_obj[:R].to(torch.int32), padn)
        lights = light.reshape(S, R, 3)
        if padn:
            lights = torch.cat([lights, lights[:, -1:].expand(S, padn, 3)],
                               1)
        nt = p0.shape[0] // ts
        p3 = p0.reshape(nt, ts, 3)
        s2 = self0.reshape(nt, ts)
        any_hit = None
        if hit is not None:
            h2 = _pad_rows(hit[:R], padn, False).reshape(nt, ts)
            p3, s2, any_hit = _first_hit_repair(p3, h2, s2)
        o_g = p3[:, None].expand(nt, S, ts, 3)
        d_g = lights.reshape(S, nt, ts, 3).permute(1, 0, 2, 3) - o_g
        o_f, d_f = o_g.reshape(-1, 3), d_g.reshape(-1, 3)
        plan = impl.cull_occl(prep, cfg, o_f, d_f, S * ts, maxv,
                              _pure_excl(s2))
        if any_hit is not None:
            plan = torch.where(any_hit[:, None], plan, 0)
    self_g = s2[:, None, :].expand(nt, S, ts).reshape(nt, S * ts)
    found = impl.anyhit(prep, cfg, o_f, d_f, self_g, plan, S * ts)
    found = found.reshape(nt, S, ts).permute(1, 0, 2).reshape(S, -1)
    return found[:, :R].reshape(-1)


def texel_finish(scene, cfg: RenderConfig, obj, comp):
    """The textured fused frame's finish (JAX tiled.py:1605-1621): K1's
    attribute mode 1 rows comp [R, 6] = (dw, sw, texu, texv, obj, tex id)
    and obj [R] -> unshadowed pre-tonemap rgb [R, 3]: the texel at (texu,
    texv) where the tex id is >= 0, else the object's colour, times
    (1/pi) light * dw, plus light * specular * sw."""
    with span("srt.shade"):
        lc = torch.tensor(cfg.light.color, dtype=torch.float32,
                          device=comp.device)
        tex_id = torch.round(comp[:, 5]).to(torch.int32)
        ms = integrator.material_select(scene, obj.clamp_min(0))
        tex_rgb = sh.texture_fetch(scene.tex_data, scene.tex_offset,
                                   scene.tex_width, scene.tex_height, tex_id,
                                   comp[:, 2:4])
        color = torch.where((tex_id >= 0)[:, None], tex_rgb, ms["color"])
        return (sh.INV_PI * lc * color * comp[:, 0:1]
                + lc * ms["specular"][:, None] * comp[:, 1:2])


def render_flat_tiled(prep, cfg: RenderConfig, light_pos, cam_spec,
                      rays=None):
    """The frame's primary rays in tile-major order -> (radiance [R, 3]
    tone-mapped, hit [R] bool), R = n_tiles * tile_px**2.

    ``cam_spec`` = (view_matrix or None, focal, width, height, tile_px).
    ``rays`` = (o, d) [R, 3], the tile-major primary rays
    (ops/camera.py::primary_rays_tiled, normalized where
    ``cfg.camera.normalize_dirs`` says so); the frames of
    :func:`wants_rays` need them.  The kernels are kernels/table.py's
    (under ``table.using(table.plain())`` the frame runs no kernel of
    csrc/: ``chip_smoke.py``'s reference image on the card).

    With ``cam_spec`` None (JAX's ``cam_spec=None``, lines 1496-1507),
    ``rays`` are any R primary rays of one camera, in any order (the
    data-parallel slabs of dist/sharding.py are row-major): the tile is
    ``effective_tile_px`` of the triangle count, the plans keep the apex
    test, and the frame takes the branch of :func:`frame_branch` with no
    camera (K1's fetch mode over the rays, then K2′, on flat scenes)."""
    if cam_spec is None:
        tile = pl.effective_tile_px(cfg, prep.scene.num_triangles) ** 2
        branch = frame_branch(prep, cfg, tile, camera=False)
        if rays is None:
            raise ValueError("a frame with no camera needs its rays")
    else:
        tile = cam_spec[4] ** 2
        branch = frame_branch(prep, cfg, tile)
    if rays is None and wants_rays(prep, cfg, tile):
        raise ValueError(f"the {branch} frame needs the primary rays")
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    htile = _hit_tile(cfg, tile)
    stile = pl.shadow_tile(cfg, tile, prep.num_blocks * prep.block_size)
    # normalized rays are no affine function of the pixel: no rebuild
    cspec = None if cfg.camera.normalize_dirs else cam_spec
    if branch in ("paged", "gather"):
        o, d = rays
        if branch == "paged":
            t, idx = paged.hits(prep, cfg, o, d, htile, maxv, apex=True)
        else:
            t, idx = hits(prep, cfg, o, d, htile, maxv, apex=True,
                          cam_spec=cspec)
        shadow_fn = tiled_shadow_fn(
            prep, cfg, stile, maxv, cfg.light.num_samples,
            shadow_impl("paged" if branch == "paged" else None)) \
            if cfg.light.enable_shadows else None
        rad = integrator.shade(prep.scene, cfg, o, d, t, idx, light_pos,
                               shadow_fn)
        return rad, torch.isfinite(t)
    if branch == "soft":
        o, d = rays
        t, idx, attrs = hits_attrs(prep, cfg, cspec, maxv, rays=rays,
                                   tile=htile)
        record = integrator.records_from_attrs(prep.scene, attrs)
        shadow_fn = tiled_shadow_fn(
            prep, cfg, stile, maxv, cfg.light.num_samples) \
            if cfg.light.enable_shadows else None
        rad = integrator.shade(prep.scene, cfg, o, d, t, idx, light_pos,
                               shadow_fn, record=record)
        return rad, torch.isfinite(t)
    # the camera row with the shadow frame, read by K1 and the shadow plan
    cam = pl.camera(prep, cam_spec, light_pos)
    t, _idx, obj, rgb, bounds = hits_shaded(prep, cfg, light_pos, cam_spec,
                                            maxv, rays=rays, cam=cam)
    hit = torch.isfinite(t)
    if attr_mode(prep, cfg) == TEXTURED:
        rgb = texel_finish(prep.scene, cfg, obj, rgb)
    if cfg.light.enable_shadows and prep.scene.num_objects > 1:
        if branch == "fused":
            found = anyhit_from_t(prep, cfg, t, obj, bounds, cam, cam_spec,
                                  maxv)
        else:
            o, d = rays
            point = torch.where(hit[:, None],
                                o + torch.where(hit, t, 0.0)[:, None] * d,
                                0.0)
            shadow_fn = tiled_shadow_fn(prep, cfg, stile, maxv, 1)
            found = shadow_fn(point, light_pos.expand(point.shape), obj,
                              hit=hit)
        with span("srt.shade"):
            rgb = torch.where(found[:, None], rgb / cfg.light.shadow_dim,
                              rgb)
    if cfg.shading.tonemap_enabled:
        with span("srt.finish"):
            rgb = sh.tonemap(rgb, cfg.shading.reinhard_offset,
                             cfg.shading.gamma)
    return rgb, hit
