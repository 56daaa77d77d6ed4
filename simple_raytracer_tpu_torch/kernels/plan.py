"""Cull planners of the tiled path: plain PyTorch, and csrc/plan.cu.

For each ray tile a plan lists the aligned WINDOWS of cull blocks (a window
= ``wb`` consecutive 32-triangle blocks; the paged walks' windows are pages
of ``page_tris`` triangles) that any of the tile's rays can reach, ordered
front to back, each with a 16-bit bound.  The bound is a conservative lower
bound on the distance t of any hit in that window and in every later one,
so the nearest-hit walk may stop once every ray's best t is below the next
entry's bound.

Counterparts in the JAX package: ``kernels/tiled.py`` (cull_blocks_lists,
cull_blocks, _visibility, _visibility_hourglass, _px_frame, _px_block_corners,
_visibility_px, _visibility_px_rev, effective_tile_px, _shadow_tile,
effective_cull_maxv), ``utils/vma.py`` (pad_rays) and ``kernels/tiled_t.py``
(cull, cull_occl, _hourglass_for, make_cam, analytic_tile_bounds: here
:func:`tile_bounds_plain` of :func:`camera_plain`'s row, shadow_frame,
analytic_shadow_bounds_exact).  Tile bounds come in two
kinds, read by the same visibility tests: analytic O(tiles) bounds of the
fused frame's primary and shadow tiles (:func:`tile_bounds`,
:func:`shadow_bounds`, from the frame's camera row :func:`camera`), and
per-ray reductions (:func:`ray_tile_bounds`) of explicit rays: the shadow
rays of the legacy and soft-shadow paths, the primary rays of the paths
with no pixel rebuild, and the rays of every range-only plan.

Plan layout, one int32 row of ``plan_width`` per tile (the JAX layout):
columns 0-7 are (lo, range_cnt, list_cnt, use_list, px0, py0, 0, 0), then
the entries ``window_id | bound16 << 16`` in ascending order.  A tile whose
visible-window count exceeds ``maxv`` walks the covering contiguous range
``[lo, lo + range_cnt)`` instead, with no early break.  (px0, py0) is the
tile's first pixel relative to the image centre; the kernels rebuild their
rays from it.  A grouped plan (``groups`` > 1) carries, after its
entries, one mask word per 8 entries: 4 bits per entry, bit g set when
sub-group g of the tile's rays may reach the entry's window
(:func:`group_mask_words`); range-mode rows read all groups.

A range-only plan (:func:`cull_ranges`: ``maxv <= 0``, or more windows
than a 16-bit entry can name, :data:`MAX_LIST_WINDOWS`) holds every tile in
range mode: the covering range of the blocks the interval test of its rays
reaches, in aligned windows, with no projective test and no entries.

:func:`cull`, which every planner calls, runs the ``plan`` role of
kernels/table.py: on a CUDA device a list plan of the interval or the
hourglass test and its apex tests is built by the hand-written kernels of
csrc/plan.cu (:func:`cull_cuda`: at most two launches, no host read),
everything else (CPU tensors, range-only plans) by its plain version
:func:`cull_plain`, the same plan bit for bit.  The analytic bounds and
the camera row are the roles ``tile_bounds``, ``shadow_bounds`` and
``camera``: a launch each of csrc/plan.cu on a CUDA device, their plain
twins (the same numbers bit for bit, their sums written in the kernels'
order) on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops.intersect import cross
from ..utils.metrics import count, span
from . import build, table

PLAN_W = 256            # plan row width of scenes with <= 1500 windows
PLAN_W_BIG = 1024       # ... and of denser scenes
PLAN_AUX = 8
T_BUCKETS = 8
DENSE_TRIS = 131072     # the tile-size and shadow-tile density gate
BIG = 3.0e38
EPS = 1e-12
INF = float("inf")
# list entries name their window in 16 bits: scenes of more windows (or
# pages) take range-only plans
MAX_LIST_WINDOWS = 65536


def effective_tile_px(cfg, num_tris: int) -> int:
    """Pixel tile edge (config.tile_px; 0 = adaptive: 64 up to 131,072
    triangles, 32 above, as the JAX package chooses)."""
    if cfg.tile_px:
        return cfg.tile_px
    return 64 if num_tris <= DENSE_TRIS else 32


def shadow_tile(cfg, tile: int, num_tris: int) -> int:
    """Shadow-pass ray-tile size (config.shadow_tile; 0 = adaptive: the
    primary tile, or 256 rays for scenes over 131,072 triangles)."""
    if cfg.shadow_tile:
        return cfg.shadow_tile
    return 256 if num_tris > DENSE_TRIS and tile > 256 else tile


def hourglass_for(prep) -> bool:
    """Whether shadow plans use the hourglass test: scenes over 131,072
    triangles, whose shadow lists are long (JAX tiled_t._hourglass_for)."""
    return prep.num_blocks * prep.block_size > DENSE_TRIS


def plan_width(num_windows: int) -> int:
    return PLAN_W if num_windows <= 1500 else PLAN_W_BIG


def range_only(maxv: int, num_windows: int) -> bool:
    """Whether a plan over ``num_windows`` windows holds ranges only: no
    list capacity (``maxv <= 0``), or window ids past 16 bits."""
    return maxv <= 0 or num_windows > MAX_LIST_WINDOWS


def effective_cull_maxv(cfg, num_blocks: int, wb: int) -> int:
    """List-mode window cap: ``cfg.cull_maxv``, widened for dense scenes to
    ``cfg.kernel.maxv_big`` (at most the wide plan's capacity) so their
    through-geometry tiles keep a sorted list (and its early break) instead
    of falling back to range walks."""
    maxv = cfg.cull_maxv
    if maxv <= 0 or plan_width(num_blocks // wb) <= PLAN_W:
        return maxv
    return max(maxv, min(cfg.kernel.maxv_big, PLAN_W_BIG - PLAN_AUX))


def _vec(x):
    return (x[..., 0], x[..., 1], x[..., 2])


def _stack(c):
    return torch.stack(c, dim=-1)


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """x [N, 3] summed over its rows by halvings: each step adds the second
    half of the rows to the first, an odd last row carried on, until one
    row is left.  The order of csrc/plan.cu's tile bounds, where x.sum(0)
    would take PyTorch's."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = torch.cat([x[:h] + x[h:2 * h], x[2 * h:]])
    return x[0]


def frame_of(w: torch.Tensor):
    """Orthonormal (s, v, w) [3] each, with w along the direction w [3]
    ((0, 0, 1) where it is near 0); s is built against the coordinate axis
    least aligned with w.  Sums of three written out left to right, as in
    csrc/plan.cu::frame_of."""
    z = (torch.arange(3, device=w.device) == 2).to(w.dtype)
    nw = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    w = torch.where(nw > 1e-20, w / nw.clamp_min(1e-20), z)
    e = (torch.arange(3, device=w.device) == torch.argmin(w.abs())).to(w.dtype)
    s = _stack(cross(_vec(w), _vec(e)))
    s = s / torch.sqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2])
    v = _stack(cross(_vec(w), _vec(s)))
    return s, v, w


def px_frame(d: torch.Tensor):
    """The projective frame (s, v, w) of the directions d [N, 3]: w along
    their sum (:func:`frame_of`).  Any frame works for the projective tests
    (they compare projections of the same rays and blocks)."""
    return frame_of(d.sum(0))


def tile_origins(n: int, tiles_x: int, tile_px: int, width: int, height: int,
                 device=None):
    """(px0, py0) [n] i32: each tile's first pixel relative to the image
    centre, tiles in row-major order of the tile grid."""
    ti = torch.arange(n, dtype=torch.int32, device=device)
    px0 = (ti % tiles_x) * tile_px - (width // 2)
    py0 = (ti // tiles_x) * tile_px - (height // 2)
    return px0.to(torch.int32), py0.to(torch.int32)


def make_cam(view_matrix, focal: float, light_pos, frame=None, device=None):
    """Per-frame constants of the kernels, one f32 [24] tensor:
    0-2 A, 3-5 B, 6-8 C (d = fx*A + fy*B + C), 9-11 the origin, 12-14 the
    light, 15-23 the shared shadow frame (s, v, w) or zeros."""
    if view_matrix is None:
        A = torch.tensor([1.0, 0.0, 0.0], device=device)
        B = torch.tensor([0.0, 1.0, 0.0], device=device)
        C = torch.tensor([0.0, 0.0, float(focal)], device=device)
        o = torch.zeros(3, device=device)
    else:
        V = torch.as_tensor(view_matrix, dtype=torch.float32, device=device)
        A, B, C, o = V[:3, 0], V[:3, 1], V[:3, 2] * float(focal), V[:3, 3]
    L = torch.as_tensor(light_pos, dtype=torch.float32, device=device)
    fr = (torch.zeros(9, device=device) if frame is None
          else torch.cat([f.to(device) for f in frame]))
    return torch.cat([A, B, C, o, L.reshape(3), fr]).to(torch.float32)


def pad_rays(o: torch.Tensor, d: torch.Tensor, multiple: int):
    """Pad the flat ray axis to a multiple, repeating the last ray (harmless
    duplicate work).  Returns (o, d, original R)."""
    R = o.shape[0]
    pad = (-R) % multiple
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    return o, d, R


def ray_tile_bounds(o: torch.Tensor, d: torch.Tensor, tile: int,
                    hourglass: bool = False, apex: Optional[str] = None):
    """Per-tile bounds of explicit rays o, d [R, 3] (padded to whole tiles):
    the interval bounds omin/omax/dmin/dmax [n, 3] of :func:`visibility`;
    with ``hourglass`` the endpoint box qmin/qmax (q = o + d) of
    :func:`visibility_hourglass`.  ``apex`` adds the projective data of
    rays that share one point: ``"primary"`` for rays that all leave one
    origin (:func:`visibility_px`; JAX kernels/tiled.py::_visibility_px
    with no analytic bounds): frame ``px_frame(d)``, apex o[0], each tile's
    ru/rv rect, ``tile_bad`` where a ray has d.w <= eps (one-sided: such
    rays leave the cone) and ``dw_hi``; ``"light"`` for rays that all pass
    through one light (:func:`visibility_px_rev`): frame ``px_frame(-d)``,
    apex o[0] + d[0], and each tile's ru/rv rect, unbounded where a ray has
    |d.w| <= eps."""
    if apex not in (None, "primary", "light"):
        raise ValueError(f"apex {apex!r} is not None, 'primary' or 'light'")
    o, d, _ = pad_rays(o, d, tile)
    n = o.shape[0] // tile
    ot, dt = o.reshape(n, tile, 3), d.reshape(n, tile, 3)
    ab = {"omin": ot.amin(dim=1), "omax": ot.amax(dim=1),
          "dmin": dt.amin(dim=1), "dmax": dt.amax(dim=1)}
    if hourglass:
        qt = ot + dt
        ab.update(qmin=qt.amin(dim=1), qmax=qt.amax(dim=1))
    if apex == "primary":
        s, v, w = px_frame(d)
        dw = d @ w
        bad = dw <= EPS
        dws = dw.clamp_min(EPS)
        ab.update(apex=o[0])
    elif apex == "light":
        s, v, w = px_frame(-d)
        dw = d @ w
        bad = dw.abs() <= EPS
        dws = torch.where(bad, EPS, dw)
        ab.update(apex=o[0] + d[0])
    else:
        return ab
    ru = ((d @ s) / dws).reshape(n, tile)
    rv = ((d @ v) / dws).reshape(n, tile)
    bad = bad.reshape(n, tile)
    ab.update(s=s, v=v, w=w,
              ru_lo=torch.where(bad, -BIG, ru).amin(dim=1),
              ru_hi=torch.where(bad, BIG, ru).amax(dim=1),
              rv_lo=torch.where(bad, -BIG, rv).amin(dim=1),
              rv_hi=torch.where(bad, BIG, rv).amax(dim=1))
    if apex == "primary":
        ab.update(tile_bad=bad.any(dim=1),
                  dw_hi=torch.where(bad, 0.0, dw.reshape(n, tile))
                  .amax(dim=1))
    return ab


def camera(prep, cam_spec, light=None) -> torch.Tensor:
    """The frame's camera row: :func:`make_cam` of ``cam_spec``'s view and
    focal, with ``light`` and the shared shadow frame of
    :func:`shadow_frame` (zeros for both where ``light`` is None).  The
    ``camera`` role of kernels/table.py: csrc/plan.cu's
    ``camera_kernel`` on a CUDA device (:func:`camera_cuda`), equal to
    :func:`camera_plain`'s row bit for bit.  The frame's first work, so
    it is issued within the primary plan's span."""
    with span("srt.plan.primary"):
        return table.run("camera", prep, cam_spec, light)


def camera_plain(prep, cam_spec, light=None) -> torch.Tensor:
    """:func:`camera` in plain PyTorch."""
    vmx, focal = cam_spec[:2]
    if light is None:
        return make_cam(vmx, focal, (0.0, 0.0, 0.0), None, prep.device)
    frame = shadow_frame(prep.block_min, prep.block_max, light)
    return make_cam(vmx, focal, light, frame, prep.device)


def tile_bounds(cam: torch.Tensor, cam_spec, n: int) -> dict:
    """O(tiles) cull bounds of the frame's ``n`` primary-ray tiles, from
    the camera row ``cam`` (:func:`camera`) and the tile grid of
    ``cam_spec``.  d is affine in the pixel, so a tile's direction box and
    its projective (ru, rv) rect are exact at the 4 pixel-rect corners
    (valid while d.w > 0 over the rect, which the corners certify).
    Returns the interval bounds (omin/omax/dmin/dmax [n, 3]) and the
    projective data (s, v, w, apex, ru/rv bounds, tile_bad, dw_hi) read by
    :func:`visibility` and :func:`visibility_px`.  The ``tile_bounds``
    role of kernels/table.py: csrc/plan.cu's ``tile_bounds_kernel`` on a
    CUDA device (:func:`tile_bounds_cuda`), equal to
    :func:`tile_bounds_plain`'s bounds bit for bit."""
    return table.run("tile_bounds", cam, cam_spec, n)


def tile_bounds_plain(cam: torch.Tensor, cam_spec, n: int) -> dict:
    """:func:`tile_bounds` in plain PyTorch, in the kernel's order: the
    frame's w along the corner directions summed by :func:`sum_rows`, the
    projections written out (:func:`_dot`)."""
    _vmx, _focal, wd, hd, tpx = cam_spec
    px0, py0 = tile_origins(n, -(-wd // tpx), tpx, wd, hd, cam.device)
    px0, py0 = px0.to(torch.float32), py0.to(torch.float32)
    e = float(tpx - 1)
    fx = torch.stack([px0, px0 + e, px0, px0 + e], dim=1)          # [n, 4]
    fy = torch.stack([py0, py0, py0 + e, py0 + e], dim=1)
    dc = fx[..., None] * cam[0:3] + fy[..., None] * cam[3:6] + cam[6:9]
    o = cam[9:12]
    s, v, w = frame_of(sum_rows(dc.reshape(-1, 3)))
    dw = _dot(dc, w)                                                # [n, 4]
    bad = dw <= EPS
    dws = dw.clamp_min(EPS)
    ru = _dot(dc, s) / dws
    rv = _dot(dc, v) / dws
    ob = o.expand(n, 3)
    return {
        "omin": ob, "omax": ob, "dmin": dc.amin(dim=1), "dmax": dc.amax(dim=1),
        "s": s, "v": v, "w": w, "apex": o,
        "ru_lo": torch.where(bad, -BIG, ru).amin(dim=1),
        "ru_hi": torch.where(bad, BIG, ru).amax(dim=1),
        "rv_lo": torch.where(bad, -BIG, rv).amin(dim=1),
        "rv_hi": torch.where(bad, BIG, rv).amax(dim=1),
        "tile_bad": bad.any(dim=1),
        "dw_hi": torch.where(bad, 0.0, dw).amax(dim=1),
    }


def shadow_frame(block_min: torch.Tensor, block_max: torch.Tensor, light):
    """The shared projective frame of the shadow bounds, seeded with the
    light -> scene-centre direction so d.w is sign-definite for almost
    every tile.  Computed once per frame (:func:`camera`) and read both by
    the nearest kernel (its bounds row) and by :func:`shadow_bounds`."""
    ctr = 0.5 * (block_min.amin(dim=0) + block_max.amax(dim=0))
    L = torch.as_tensor(light, dtype=torch.float32, device=ctr.device)
    return frame_of(ctr - L.reshape(3))


def analytic_shadow_bounds_exact(bounds: torch.Tensor, light, frame):
    """O(tiles) shadow cull bounds from the nearest kernel's per-tile row
    (bounds [n, 15]: hit-point box 6, any-hit flag, obj lo/hi, ru lo/hi,
    rv lo/hi, dw lo/hi).  Tiles whose dw is not sign-definite (or that have
    no hit) get an unbounded projective rect.  Also ``live`` [n] bool, the
    tiles with a hit, and ``excl`` [n] i32, the object every hit of a pure
    tile left (-2 elsewhere: no block's)."""
    light = torch.as_tensor(light, dtype=torch.float32,
                            device=bounds.device).reshape(3)
    s, v, w = frame
    ah = bounds[:, 6] > 0.0
    ahc = ah[:, None]
    pmin = torch.where(ahc, bounds[:, 0:3], 0.0)
    pmax = torch.where(ahc, bounds[:, 3:6], 0.0)
    ok = ah & ((bounds[:, 13] > EPS) | (bounds[:, 14] < -EPS))
    pure = ah & (bounds[:, 7] == bounds[:, 8])
    return {
        "omin": pmin, "omax": pmax, "dmin": light - pmax, "dmax": light - pmin,
        "s": s, "v": v, "w": w, "apex": light,
        "ru_lo": torch.where(ok, bounds[:, 9], -BIG),
        "ru_hi": torch.where(ok, bounds[:, 10], BIG),
        "rv_lo": torch.where(ok, bounds[:, 11], -BIG),
        "rv_hi": torch.where(ok, bounds[:, 12], BIG),
        "live": ah,
        "excl": torch.where(pure, torch.round(bounds[:, 7]).to(torch.int32),
                            -2),
    }


def shadow_bounds(bounds: torch.Tensor, cam: torch.Tensor) -> dict:
    """The hard-shadow plan's O(tiles) bounds
    (:func:`analytic_shadow_bounds_exact`) from the nearest kernel's rows
    ``bounds`` [n, 15] and the camera row ``cam`` that kernel read (its
    light and shared shadow frame).  The ``shadow_bounds`` role of
    kernels/table.py: csrc/plan.cu's ``shadow_bounds_kernel`` on a CUDA
    device (:func:`shadow_bounds_cuda`), equal to
    :func:`shadow_bounds_plain`'s bit for bit."""
    return table.run("shadow_bounds", bounds, cam)


def shadow_bounds_plain(bounds: torch.Tensor, cam: torch.Tensor) -> dict:
    """:func:`shadow_bounds` in plain PyTorch."""
    return analytic_shadow_bounds_exact(
        bounds, cam[12:15], (cam[15:18], cam[18:21], cam[21:24]))


def _safe_div(a, b):
    """Interval endpoint division: a/0 -> sign(a)*inf, 0/0 -> 0."""
    zero = b == 0.0
    q = a / torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, torch.where(a == 0.0, 0.0, torch.sign(a) * INF), q)


def visibility(ab, block_min, block_max, block_obj=None, excl=None):
    """Interval slab test: can any ray with o in [omin, omax], d in
    [dmin, dmax] and t >= 0 touch the block AABB?  Returns (visible [n, NB],
    entry-t lower bound [n, NB]).  ``excl`` [n] (with ``block_obj`` [NB])
    drops the blocks of the object every ray of the tile leaves: the
    reference never lets an object shadow itself (simple_raytracer.cpp:331);
    -2 matches no block."""
    omin, omax, dmin, dmax = ab["omin"], ab["omax"], ab["dmin"], ab["dmax"]
    t_lo = t_hi = None
    for ax in range(3):
        lo_i = block_min[None, :, ax] - omax[:, None, ax]          # [n, NB]
        hi_i = block_max[None, :, ax] - omin[:, None, ax]
        dn = dmin[:, None, ax]
        dx = dmax[:, None, ax]
        c0, c1 = _safe_div(lo_i, dn), _safe_div(lo_i, dx)
        c2, c3 = _safe_div(hi_i, dn), _safe_div(hi_i, dx)
        tmin_ax = torch.minimum(torch.minimum(c0, c1), torch.minimum(c2, c3))
        tmax_ax = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
        spans = (((dn <= 0.0) & (dx >= 0.0))
                 | ((lo_i <= 0.0) & (hi_i >= 0.0)))
        tmin_ax = torch.where(spans, 0.0, tmin_ax.clamp_min(0.0))
        tmax_ax = torch.where(spans, INF, tmax_ax)
        t_lo = tmin_ax if t_lo is None else torch.maximum(t_lo, tmin_ax)
        t_hi = tmax_ax if t_hi is None else torch.minimum(t_hi, tmax_ax)
    # t_lo == +inf: unreachable (a direction interval {0} with a strictly
    # positive offset); inf >= inf must not count as visible
    visible = (t_hi >= t_lo) & (t_hi >= 0.0) & (t_lo < INF)
    if block_obj is not None and excl is not None:
        visible = visible & (block_obj[None, :] != excl[:, None])
    return visible, t_lo.clamp_min(0.0)


def visibility_hourglass(ab, block_min, block_max, block_obj=None,
                         excl=None):
    """Apex-aware interval test for shadow tiles, from the origin box
    [omin, omax] and the endpoint box [qmin, qmax] (q = o + d) of
    :func:`ray_tile_bounds`.  A ray's point o + t*d = (1-t) o + t q is
    bounded per axis by two lines between the boxes, one branch for t <= 1
    and one for t >= 1 (no max-t keeps rays alive past the light); each
    "range meets the block slab" condition is linear in t, so a branch's
    feasible t is one interval, widened by a 1e-5 relative margin against
    f32 rounding.  Returns (visible [n, NB], entry-t lower bound [n, NB]),
    as :func:`visibility`."""
    olo, ohi, qlo, qhi = ab["omin"], ab["omax"], ab["qmin"], ab["qmax"]
    n = olo.shape[0]
    eps = 1e-5

    def branch(lo0, lo1, hi0, hi1, tmin, tmax):
        ta = torch.full((n, 1), tmin, device=olo.device)
        tb = torch.full((n, 1), tmax, device=olo.device)
        feas = None
        for ax in range(3):
            for c0t, c1t, bnd, ge in (
                    (lo0[:, ax], lo1[:, ax], block_max[None, :, ax], False),
                    (hi0[:, ax], hi1[:, ax], block_min[None, :, ax], True)):
                sl = (c1t - c0t)[:, None]                 # [n, 1]
                r = bnd - c0t[:, None]                    # [n, NB]
                if ge:
                    sl, r = -sl, -r
                # sl * t <= r, thresholds widened against f32 rounding
                thr = r / torch.where(sl == 0.0, 1.0, sl)
                mgn = eps * (thr.abs() + 1.0)
                tb = torch.where(sl > 0.0, torch.minimum(tb, thr + mgn), tb)
                ta = torch.where(sl < 0.0, torch.maximum(ta, thr - mgn), ta)
                ok = ~((sl == 0.0) & (r < -eps * (bnd.abs() + 1.0)))
                feas = ok if feas is None else feas & ok
        return feas & (tb >= ta), ta

    vis_a, ta_a = branch(olo, qlo, ohi, qhi, 0.0, 1.0)
    vis_b, ta_b = branch(ohi, qlo, olo, qhi, 1.0, 3.4e38)
    visible = vis_a | vis_b
    t_lo = torch.minimum(torch.where(vis_a, ta_a, INF),
                         torch.where(vis_b, ta_b, INF))
    t_lo = torch.where(visible, t_lo.clamp_min(0.0), INF)
    t_lo = torch.where(torch.isfinite(t_lo), t_lo, 0.0)
    if block_obj is not None and excl is not None:
        visible = visible & (block_obj[None, :] != excl[:, None])
    return visible, t_lo


def _dot(c, u):
    """c [..., 3] . u [3], summed left to right: the order of csrc/plan.cu,
    where a matmul would take cuBLAS's."""
    return c[..., 0] * u[0] + c[..., 1] * u[1] + c[..., 2] * u[2]


def _block_corners(block_min, block_max, apex):
    """Block AABB corners relative to the apex [NB, 8, 3] + the empty mask
    (inverted boxes)."""
    k = torch.arange(8, device=block_min.device)
    bits = ((k[:, None] >> torch.arange(3, device=k.device)[None, :]) & 1) == 1
    corn = torch.where(bits[None], block_max[:, None], block_min[:, None])
    empty = (block_min > block_max).any(dim=-1)
    return corn - apex, empty


def _rect(p, ok):
    """Projected extent [NB] (lo, hi) of corner coordinates p [NB, 8],
    widened by 1e-4 * (1 + |x|) against f32 rounding; unbounded where not
    ``ok``."""
    lo, hi = p.amin(dim=1), p.amax(dim=1)
    return (torch.where(ok, lo - 1e-4 * (1.0 + lo.abs()), -BIG),
            torch.where(ok, hi + 1e-4 * (1.0 + hi.abs()), BIG))


def _overlap(bu, bv, pxb):
    return ((bu[0][None] <= pxb["ru_hi"][:, None])
            & (bu[1][None] >= pxb["ru_lo"][:, None])
            & (bv[0][None] <= pxb["rv_hi"][:, None])
            & (bv[1][None] >= pxb["rv_lo"][:, None]))


def visibility_px(pxb, block_min, block_max):
    """Projective test for tiles of rays that share one origin (primary
    rays): a ray o + t*dir meets x only if x - o is parallel to dir, so in
    a frame (s, v, w) with dir.w > 0 the ray's projective coordinates must
    fall inside the block's projected rect — the rasterizer's frustum cull.
    Blocks partly behind the apex plane get an unbounded rect; blocks fully
    behind it are invisible to tiles whose rays are all in the cone;
    empty blocks are invisible.  Returns visible [n, NB]."""
    c, empty = _block_corners(block_min, block_max, pxb["apex"])
    cw = _dot(c, pxb["w"])
    front = (cw > EPS).all(dim=1)
    behind = (cw <= EPS).all(dim=1)
    cws = cw.clamp_min(EPS)
    bu = _rect(_dot(c, pxb["s"]) / cws, front)
    bv = _rect(_dot(c, pxb["v"]) / cws, front)
    return (_overlap(bu, bv, pxb) & ~empty[None, :]
            & ~(behind[None, :] & ~pxb["tile_bad"][:, None]))


def visibility_px_rev(pxb, block_min, block_max):
    """Projective LINE test for hard-shadow tiles, whose rays all pass
    through one light L.  With no max-t (simple_raytracer.cpp:321-342) an
    occluder anywhere on the line through the point and L counts; sign-free
    projective coordinates about L cover both cones at once.  Blocks that
    straddle L's w-plane are conservatively visible; empty blocks are
    not.  Returns visible [n, NB]."""
    c, empty = _block_corners(block_min, block_max, pxb["apex"])
    cw = _dot(c, pxb["w"])
    ok = (cw > EPS).all(dim=1) | (cw < -EPS).all(dim=1)
    cws = torch.where(cw.abs() > EPS, cw, EPS)
    bu = _rect(_dot(c, pxb["s"]) / cws, ok)
    bv = _rect(_dot(c, pxb["v"]) / cws, ok)
    return _overlap(bu, bv, pxb) & ~empty[None, :]


def cull_lists(visible_b: torch.Tensor, tlo_b: torch.Tensor, wb: int,
               maxv: int, plan_w: int) -> torch.Tensor:
    """Block visibility [n, NB] and entry bounds -> the plan [n, plan_w].

    A window is visible if any of its blocks is, and its bound is the least
    entry bound of its visible blocks.  Entries are bucketed front to back
    (T_BUCKETS buckets over the tile's bound range); each entry's bound16 is
    the top 16 bits of its BUCKET FLOOR, which lower-bounds that entry and
    every later one (within a bucket entries follow window order).  For
    non-negative floats the bit pattern orders like the value and the
    truncation rounds down, so bound16 stays conservative, and
    ``bound16 << 16 | window`` is itself the sort key."""
    n, NB = visible_b.shape
    NP = NB // wb
    dev = visible_b.device
    visible = visible_b.reshape(n, NP, wb).any(dim=-1)
    tlo = torch.where(visible_b, tlo_b, INF).reshape(n, NP, wb).amin(dim=-1)
    idx = torch.arange(NP, dtype=torch.int32, device=dev)
    first = torch.where(visible, idx, NP).amin(dim=-1)
    last = torch.where(visible, idx, -1).amax(dim=-1)
    range_cnt = (last - first + 1).clamp_min(0).to(torch.int32)
    lo = torch.where(range_cnt > 0, first, 0).to(torch.int32)

    mv_cap = plan_w - PLAN_AUX
    page_cnt = visible.sum(dim=-1).to(torch.int32)
    maxv = min(maxv, mv_cap)
    use_list = (page_cnt <= maxv).to(torch.int32)

    tmin = torch.where(visible, tlo, INF).amin(dim=-1)
    tmax = torch.where(visible, tlo, -INF).amax(dim=-1)
    tmin = torch.where(torch.isfinite(tmin), tmin, 0.0)
    qscale = (tmax - tmin).clamp_min(1e-20) / T_BUCKETS
    rel = torch.where(visible, tlo, tmin[:, None]) - tmin[:, None]
    qb = (rel / qscale[:, None]).to(torch.int32).clamp(0, T_BUCKETS - 1)
    floor_t = (tmin[:, None] + qb.to(torch.float32) * qscale[:, None]
               ).clamp_min(0.0)
    bound16 = floor_t.contiguous().view(torch.int32) >> 16
    key = torch.where(visible, (bound16 << 16) | idx[None, :],
                      torch.iinfo(torch.int32).max)
    k = min(mv_cap, NP)
    entries = torch.sort(key, dim=1).values[:, :k]
    if k < mv_cap:
        entries = torch.cat(
            [entries, torch.zeros((n, mv_cap - k), dtype=torch.int32,
                                  device=dev)], dim=1)
    z = torch.zeros_like(lo)
    aux = torch.stack([lo, range_cnt, page_cnt.clamp_max(maxv), use_list,
                       z, z, z, z], dim=-1)
    return torch.cat([aux, entries], dim=-1).contiguous()


def group_mask_words(prep, plan: torch.Tensor, wb: int, o: torch.Tensor,
                     d: torch.Tensor, tile: int, groups: int,
                     hourglass: bool = False) -> torch.Tensor:
    """The sub-group mask words of a grouped plan (JAX
    kernels/tiled.py::cull_blocks_lists with ``groups`` > 1): the tile's
    rays o, d [R, 3] (padded to whole tiles first) split into ``groups``
    contiguous sub-groups of tile / groups rays; bit g of an entry's 4-bit
    mask says whether the base test (:func:`visibility`, or
    :func:`visibility_hourglass` with ``hourglass``) of sub-group g's own
    ray bounds reaches the entry's window AABB (the union of its blocks).
    A cleared bit is sound: each ray belongs to one sub-group and the test
    is conservative for its rays.  Returns [n, mv_cap / 8] i32, 8 entries x
    4 bits per word, entry e of a word in bits 4e..4e+3; entries past the
    tile's visible windows get 0."""
    if not 2 <= groups <= 4 or tile % groups:
        raise ValueError(f"{groups} sub-groups of a {tile}-ray tile")
    n = plan.shape[0]
    mv_cap = plan.shape[1] - PLAN_AUX
    if mv_cap % 8:
        raise ValueError(f"{mv_cap} plan entries are not whole mask words")
    nw = prep.num_blocks // wb
    wmin = prep.block_min.reshape(nw, wb, 3).amin(dim=1)
    wmax = prep.block_max.reshape(nw, wb, 3).amax(dim=1)
    op, dp, _ = pad_rays(o, d, tile)
    ab = ray_tile_bounds(op, dp, tile // groups, hourglass=hourglass)
    test = visibility_hourglass if hourglass else visibility
    vis = test(ab, wmin, wmax)[0].reshape(n, groups, nw)
    mask = torch.zeros((n, nw), dtype=torch.int32, device=plan.device)
    for g in range(groups):
        mask |= vis[:, g].to(torch.int32) << g
    ent = plan[:, PLAN_AUX:]
    pos = torch.arange(mv_cap, device=plan.device)
    valid = (ent != torch.iinfo(torch.int32).max) & (pos < nw)[None, :]
    win = torch.where(valid, ent & 0xFFFF, 0).long()
    maskk = torch.where(valid, torch.gather(mask, 1, win), 0)
    m8 = maskk.reshape(n, mv_cap // 8, 8)
    words = torch.zeros((n, mv_cap // 8), dtype=torch.int32,
                        device=plan.device)
    for e in range(8):
        words |= m8[:, :, e] << (4 * e)
    return words


def cull_blocks(prep, o, d, tile: int, excl=None, hourglass: bool = False):
    """Each tile's covering block range (JAX kernels/tiled.py::cull_blocks):
    the interval test (:func:`visibility`, or :func:`visibility_hourglass`)
    of the bounds of the rays o, d [R, 3] in tiles of ``tile``, with no
    projective test.  ``excl`` [n] drops each tile's own object.  Returns
    (lo [n] i32, cnt [n] i32): [lo, lo + cnt) covers every visible block,
    cnt 0 where none is."""
    ab = ray_tile_bounds(o, d, tile, hourglass=hourglass)
    bobj = prep.block_obj if excl is not None else None
    test = visibility_hourglass if hourglass else visibility
    visible = test(ab, prep.block_min, prep.block_max, bobj, excl)[0]
    NB = visible.shape[1]
    idx = torch.arange(NB, dtype=torch.int32, device=visible.device)
    first = torch.where(visible, idx, NB).amin(dim=-1)
    last = torch.where(visible, idx, -1).amax(dim=-1)
    cnt = (last - first + 1).clamp_min(0).to(torch.int32)
    return torch.where(cnt > 0, first, 0).to(torch.int32), cnt


def cull_ranges(prep, o, d, tile: int, wb: int, plan_w: int, excl=None,
                hourglass: bool = False, groups: int = 1) -> torch.Tensor:
    """The range-only plan [n, plan_w] of rays o, d [R, 3] in tiles of
    ``tile`` (JAX tiled_t.cull and kernels/tiled.py::_cull without list
    capacity): :func:`cull_blocks` converted to the covering range of
    aligned windows of ``wb`` blocks, columns (lo, cnt, 0, ...), no
    entries; a grouped plan (``groups`` > 1) keeps its width with zero mask
    words."""
    lo, cnt = cull_blocks(prep, o, d, tile, excl, hourglass)
    ulo = lo // wb
    ucnt = torch.where(cnt > 0, (lo + cnt + wb - 1) // wb - ulo, 0)
    tail = plan_w - PLAN_AUX
    if groups > 1:
        tail += tail // 8
    plan = torch.zeros((lo.shape[0], PLAN_AUX + tail), dtype=torch.int32,
                       device=lo.device)
    plan[:, 0], plan[:, 1] = ulo, ucnt.to(torch.int32)
    return plan


def cull_width(num_windows: int, maxv: int, widen: bool = True,
               groups: int = 1) -> int:
    """Row width of :func:`cull`'s plans over ``num_windows`` windows
    (mask words of a grouped plan not counted)."""
    pw = plan_width(num_windows)
    if widen and maxv > 0:
        need = PLAN_AUX + maxv + (maxv // 8 + 8 if groups > 1 else 0)
        pw = max(pw, -(-need // 128) * 128)
    return pw


def cull(prep, maxv: int, wb: int, ab, excl=None, apex: bool = False,
         apex_rev: bool = False, hourglass: bool = False,
         widen: bool = True, groups: int = 1, rays=None, live=None,
         origins=None) -> torch.Tensor:
    """Plan of a tile set described by bounds ``ab``: the interval test (or,
    with ``hourglass``, :func:`visibility_hourglass`), refined by the
    projective test of primary rays (``apex``) or of hard-shadow rays
    (``apex_rev``), over windows of ``wb`` blocks.  ``excl`` [n] drops each
    tile's own object (see :func:`visibility`).  The plan is
    ``plan_width(windows)`` wide; with ``widen`` (the sublane planner, JAX
    kernels/tiled_t.py) it is widened to hold ``maxv`` entries, without
    (the page planner, JAX kernels/tiled.py::_cull) ``maxv`` is clamped to
    the width instead.  ``groups`` > 1 (JAX tiled_t.cull with groups):
    the width also holds the mask words (``8 + maxv + maxv // 8 + 8``
    widened to a multiple of 128 entries before them) and
    :func:`group_mask_words` follow the entries.  ``rays`` = (o, d, tile),
    the tiles' rays: the mask words' sub-groups, and the whole plan where
    it is range-only (:func:`range_only`), which JAX builds from the rays
    alone (:func:`cull_ranges`, the apex tests dropped); ``ab`` is then not
    read.  ``live`` [n] bool: rows of tiles not live are all zeros (no
    walk).  ``origins`` = (tiles_x, tile_px, width, height): columns 4/5
    hold each tile's :func:`tile_origins`, zeros without.

    The plan is the ``plan`` role's of kernels/table.py: on a CUDA device
    csrc/plan.cu's (:func:`cull_cuda`, equal to :func:`cull_plain`'s bit
    for bit), for CPU tensors and range-only plans :func:`cull_plain`'s."""
    NB = prep.num_blocks
    if NB % wb:
        raise ValueError(f"{NB} blocks do not split into windows of {wb}")
    if apex and apex_rev:
        raise ValueError("a plan takes the primary-apex test or the "
                         "light-apex test, not both")
    return table.run("plan", prep, maxv, wb, ab, excl, apex, apex_rev,
                     hourglass, widen, groups, rays, live, origins)


def _with_mask_words(prep, plan, wb: int, groups: int, rays,
                     hourglass: bool) -> torch.Tensor:
    """The plan, followed by its mask words where ``groups`` > 1."""
    if groups <= 1:
        return plan
    o, d, tile = rays
    words = group_mask_words(prep, plan, wb, o, d, tile, groups, hourglass)
    return torch.cat([plan, words], dim=1).contiguous()


def _rows_of(plan, live, origins) -> torch.Tensor:
    """The plan with the rows of tiles not ``live`` zeroed and the tiles'
    origins in columns 4/5 (:func:`cull`)."""
    if live is not None:
        plan = torch.where(live[:, None], plan, 0)
    if origins is not None:
        plan[:, 4], plan[:, 5] = tile_origins(plan.shape[0], *origins,
                                              device=plan.device)
    return plan


def cull_plain(prep, maxv: int, wb: int, ab, excl=None, apex: bool = False,
               apex_rev: bool = False, hourglass: bool = False,
               widen: bool = True, groups: int = 1, rays=None, live=None,
               origins=None) -> torch.Tensor:
    """:func:`cull` in plain PyTorch, on any device and for every flag."""
    NB = prep.num_blocks
    pw = cull_width(NB // wb, maxv, widen, groups)
    if range_only(maxv, NB // wb):
        if rays is None:
            raise ValueError("a range-only plan is built from the rays")
        o, d, tile = rays
        return _rows_of(cull_ranges(prep, o, d, tile, wb, pw, excl,
                                    hourglass, groups), live, origins)
    bobj = prep.block_obj if excl is not None else None
    test = visibility_hourglass if hourglass else visibility
    visible, tlo = test(ab, prep.block_min, prep.block_max, bobj, excl)
    if apex:
        visible = visible & visibility_px(ab, prep.block_min, prep.block_max)
    if apex_rev:
        visible = visible & visibility_px_rev(ab, prep.block_min,
                                              prep.block_max)
    plan = _rows_of(cull_lists(visible, tlo, wb, maxv, pw), live, origins)
    return _with_mask_words(prep, plan, wb, groups, rays, hourglass)

# csrc/plan.cu's operands, in its enum Op order
CUDA_OPERANDS = ("omin", "omax", "dmin", "dmax", "ru_lo", "ru_hi", "rv_lo",
                 "rv_hi", "tile_bad", "excl", "s", "v", "w", "apex", "qmin",
                 "qmax", "live")
# window bounds a tile keeps in shared memory (plan.cu's kSmemWindows)
SMEM_WINDOWS = 10240
# corner rows of tile_bounds_kernel's sum held in shared memory (plan.cu's
# kSumRows); past them it sums in a scratch row
SUM_SMEM_ROWS = 2048


def _launch(fn: str, what: str, dev, *args) -> None:
    """Launch csrc/plan.cu's ``fn`` on ``dev``'s current stream (the last
    argument) and raise on its error code."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(build.library(), fn)(*args, stream)
    build.check(rc, what)


def cuda_operands(ab, n: int, dev, excl=None, apex: bool = False,
                  apex_rev: bool = False, hourglass: bool = False,
                  live=None) -> list:
    """csrc/plan.cu's operand words for the bounds ``ab`` of ``n`` tiles:
    (pointer, stride 0, stride 1) of each of :data:`CUDA_OPERANDS`, in
    elements, zeros where the plan does not read it: the origin box, then
    the direction box of the interval test or (``hourglass``) the endpoint
    box qmin/qmax of the hourglass test, the rects, frame and apex of an
    apex test, ``tile_bad`` of the primary apex, ``excl`` (int32) and
    ``live`` (bool).  The tensors are read in place, expanded or sliced;
    each must be on ``dev`` with its dtype and shape, and outlive the
    launch."""
    box = ("qmin", "qmax") if hourglass else ("dmin", "dmax")
    want = dict.fromkeys(("omin", "omax") + box, (n, 3))
    if apex or apex_rev:
        want.update(dict.fromkeys(("ru_lo", "ru_hi", "rv_lo", "rv_hi"), (n,)))
        want.update(dict.fromkeys(("s", "v", "w", "apex"), (3,)))
    if apex:
        want["tile_bad"] = (n,)
    ops = {k: ab[k] for k in want}
    for name, x in (("excl", excl), ("live", live)):
        if x is not None:
            want[name] = (n,)
            ops[name] = x
    words = []
    for name in CUDA_OPERANDS:
        x = ops.get(name)
        if x is None:
            words += [0, 0, 0]
            continue
        dtype = (torch.bool if name in ("tile_bad", "live") else torch.int32
                 if name == "excl" else torch.float32)
        if x.device != dev or x.dtype != dtype or x.shape != want[name]:
            raise ValueError(f"{name}: want {dtype} {want[name]} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        words += [x.data_ptr(), x.stride(0), x.stride(-1)]
    return words


def cull_cuda(prep, maxv: int, wb: int, ab, excl=None, apex: bool = False,
              apex_rev: bool = False, hourglass: bool = False,
              widen: bool = True, groups: int = 1, rays=None, live=None,
              origins=None) -> torch.Tensor:
    """:func:`cull`'s list plan on the card: :func:`cull_lists` over the
    interval test of the bounds ``ab`` (or, with ``hourglass``, the
    hourglass test: ``plan_hourglass_kernel``), refined by the primary-apex
    (``apex``) or light-apex (``apex_rev``) test, minus each tile's own
    object (``excl`` [n]), with the rows of tiles not ``live`` zeroed and
    the tile ``origins`` in columns 4/5, built by csrc/plan.cu in one
    launch, two with an apex test, then the mask words of a grouped plan:
    equal to
    :func:`cull_plain`'s plan bit for bit.  The operands
    (:func:`cuda_operands`) are read in place; the host reads nothing back.
    It counts its hourglass plans (``plan.cull_cuda.hourglass_plans``) and
    its launches (``plan.cull_cuda.launches``)."""
    dev = prep.block_min.device
    n = ab["omin"].shape[0]
    nw = prep.num_blocks // wb
    plan_w = cull_width(nw, maxv, widen, groups)
    kind = 1 if apex else 2 if apex_rev else 0
    excl = None if excl is None else excl.to(torch.int32)
    words = cuda_operands(ab, n, dev, excl, apex, apex_rev, hourglass, live)
    tiles_x, tpx, wd, hd = origins or (0, 0, 0, 0)
    i32 = torch.int32
    build.check_tensors(dev, block_min=(prep.block_min, torch.float32),
                        block_max=(prep.block_max, torch.float32),
                        block_obj=(prep.block_obj, i32))
    plan = torch.empty((n, plan_w), dtype=i32, device=dev)
    blocks = (torch.empty(prep.num_blocks * 5, dtype=i32, device=dev)
              if kind else None)
    scratch = (torch.empty(n * nw, dtype=torch.float32, device=dev)
               if nw > SMEM_WINDOWS else None)
    _launch("srt_plan", "plan_hourglass_kernel" if hourglass
            else "plan_tiles_kernel", dev,
            (ctypes.c_longlong * len(words))(*words),
            prep.block_min.data_ptr(), prep.block_max.data_ptr(),
            prep.block_obj.data_ptr(), prep.num_blocks, wb, kind,
            int(hourglass), maxv, plan_w, n, tiles_x, tpx, wd // 2, hd // 2,
            None if blocks is None else blocks.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            plan.data_ptr())
    count("plan.cull_cuda.hourglass_plans", int(hourglass))
    count("plan.cull_cuda.launches", (2 if kind else 1) if n else 0)
    return _with_mask_words(prep, plan, wb, groups, rays, hourglass)


def camera_cuda(prep, cam_spec, light=None) -> torch.Tensor:
    """:func:`camera` on the card: ``camera_kernel``, one launch, reading
    the view, the light and the block tables in place (no copy where they
    are on the card).  It counts its launches
    (``plan.camera_cuda.launches``)."""
    vmx, focal = cam_spec[:2]
    dev, f32 = prep.device, torch.float32
    V = None if vmx is None else torch.as_tensor(vmx, dtype=f32, device=dev)
    L = None if light is None else torch.as_tensor(
        light, dtype=f32, device=dev).reshape(3)
    if V is not None and (V.dim() != 2 or V.shape[0] < 3 or V.shape[1] < 4):
        raise ValueError(f"view {tuple(V.shape)}: want [3 or 4, 4]")
    build.check_tensors(dev, block_min=(prep.block_min, f32),
                        block_max=(prep.block_max, f32))
    cam = torch.empty(24, dtype=f32, device=dev)
    _launch("srt_camera", "camera_kernel", dev,
            None if V is None else V.data_ptr(),
            0 if V is None else V.stride(0), 0 if V is None else V.stride(1),
            float(focal), None if L is None else L.data_ptr(),
            0 if L is None else L.stride(0), prep.block_min.data_ptr(),
            prep.block_max.data_ptr(), prep.num_blocks, cam.data_ptr())
    count("plan.camera_cuda.launches")
    return cam


def _check_cam(cam: torch.Tensor, dev) -> None:
    build.check_tensors(dev, cam=(cam, torch.float32))
    if cam.shape != (24,):
        raise ValueError(f"cam {tuple(cam.shape)}: want [24]")


def tile_bounds_cuda(cam: torch.Tensor, cam_spec, n: int) -> dict:
    """:func:`tile_bounds` on the card: ``tile_bounds_kernel``, one launch
    of one CTA; the origin box and the apex are views of ``cam``.  It
    counts its launches (``plan.tile_bounds_cuda.launches``)."""
    _vmx, _focal, wd, hd, tpx = cam_spec
    dev, f32 = cam.device, torch.float32
    _check_cam(cam, dev)
    if n <= 0:
        raise ValueError(f"{n} tiles")
    out = torch.empty(9 + 11 * n, dtype=f32, device=dev)
    bad = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = (torch.empty(12 * n, dtype=f32, device=dev)
               if 4 * n > SUM_SMEM_ROWS else None)
    _launch("srt_tile_bounds", "tile_bounds_kernel", dev, cam.data_ptr(), wd,
            hd, tpx, n, out.data_ptr(), bad.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    count("plan.tile_bounds_cuda.launches")
    box = out[9:9 + 6 * n].view(2, n, 3)
    rect = out[9 + 6 * n:].view(5, n)
    o = cam[9:12]
    return {"omin": o.expand(n, 3), "omax": o.expand(n, 3),
            "dmin": box[0], "dmax": box[1], "s": out[0:3], "v": out[3:6],
            "w": out[6:9], "apex": o, "ru_lo": rect[0], "ru_hi": rect[1],
            "rv_lo": rect[2], "rv_hi": rect[3], "tile_bad": bad,
            "dw_hi": rect[4]}


def shadow_bounds_cuda(bounds: torch.Tensor, cam: torch.Tensor) -> dict:
    """:func:`shadow_bounds` on the card: ``shadow_bounds_kernel``, one
    launch, a thread a tile; the frame and the apex are views of ``cam``.
    It counts its launches (``plan.shadow_bounds_cuda.launches``)."""
    dev, f32 = bounds.device, torch.float32
    build.check_tensors(dev, bounds=(bounds, f32))
    _check_cam(cam, dev)
    if bounds.dim() != 2 or bounds.shape[1] != 15:
        raise ValueError(f"bounds {tuple(bounds.shape)}: want [n, 15]")
    n = bounds.shape[0]
    out = torch.empty(16 * n, dtype=f32, device=dev)
    excl = torch.empty(n, dtype=torch.int32, device=dev)
    live = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _launch("srt_shadow_bounds", "shadow_bounds_kernel", dev,
                bounds.data_ptr(), n, cam.data_ptr(), out.data_ptr(),
                excl.data_ptr(), live.data_ptr())
        count("plan.shadow_bounds_cuda.launches")
    box = out[:12 * n].view(4, n, 3)
    rect = out[12 * n:].view(4, n)
    return {"omin": box[0], "omax": box[1], "dmin": box[2], "dmax": box[3],
            "s": cam[15:18], "v": cam[18:21], "w": cam[21:24],
            "apex": cam[12:15], "ru_lo": rect[0], "ru_hi": rect[1],
            "rv_lo": rect[2], "rv_hi": rect[3], "live": live, "excl": excl}


def cull_rays(prep, o, d, tile: int, maxv: int, wb: int, groups: int = 1,
              apex: bool = True) -> torch.Tensor:
    """Nearest-walk plan of explicit rays o, d [R, 3] in tiles of ``tile``
    (JAX tiled_t.cull with no analytic bounds): the interval test from the
    rays' per-tile bounds, with ``apex`` (rays that share one origin) the
    projective test too, windows of ``wb`` blocks; ``groups`` > 1 appends
    the sub-group mask words."""
    ab = ray_tile_bounds(o, d, tile, apex="primary" if apex else None)
    return cull(prep, maxv, wb, ab, apex=apex, groups=groups,
                rays=(o, d, tile))


def cull_occl(prep, o, d, tile: int, maxv: int, wb: int, excl=None,
              apex_rev: bool = False, hourglass=None,
              widen: bool = True, groups: int = 1) -> torch.Tensor:
    """Occlusion plan of explicit shadow rays o, d [R, 3] in tiles of
    ``tile`` (JAX kernels/tiled_t.py::cull_occl, and with ``widen`` False
    over pages, kernels/tiled.py::cull_occl): windows of ``wb`` blocks;
    ``apex_rev`` when every ray ends at one shared light (hard shadows: the
    light-apex test); the hourglass test on dense scenes otherwise
    (``hourglass`` None: by :func:`hourglass_for`); ``groups`` > 1 appends
    the sub-group mask words (JAX ``groups_ah``)."""
    if hourglass is None:
        hourglass = hourglass_for(prep) and not apex_rev
    ab = ray_tile_bounds(o, d, tile, hourglass=hourglass,
                         apex="light" if apex_rev else None)
    return cull(prep, maxv, wb, ab, excl=excl, apex_rev=apex_rev,
                hourglass=hourglass, widen=widen, groups=groups,
                rays=(o, d, tile))
