"""Kernels 2, 2′, 5 and 7: the any-hit (occlusion) walk.

``tiled_anyhit_from_t`` (K2) and ``tiled_anyhit`` (K2′) wrap the one walk
of csrc/anyhit.cu over its two ray sources: two launches, a schedule and a
persistent walk over (tile, ray slice, window span) work items
(``anyhit_schedule_kernel``, ``anyhit_items_kernel``).  They replace the
JAX package's Pallas kernel ``kernels/tiled_t.py::_anyhit_kernel_t`` in
its two forms: shadow rays rebuilt from the nearest pass's t (reached
through ``tiled_anyhit_from_t``, the fused frame) and explicit rays
(reached through ``tiled_anyhit_t``, the legacy hard-shadow, soft-shadow
and gather paths).  ``tiled_anyhit_grouped`` wraps the walk over explicit
rays on a grouped plan and replaces ``tiled_t.py::_anyhit_kernel_g`` (K5,
``KernelConfig.groups_ah`` > 1).  ``tiled_anyhit_from_t_plain``,
``tiled_anyhit_plain`` and ``tiled_anyhit_grouped_plain`` are their plain
PyTorch versions: same arguments, same results.  Each wrapper takes CUDA
tensors, launches its kernel and counts the launch
(``anyhit.<wrapper>.launches``); kernels/table.py chooses between a
wrapper and its plain version and counts the calls.

``anyhit_from_t`` and ``anyhit`` are the counterparts of the JAX
``tiled_t.anyhit_from_t`` and ``tiled_t.anyhit``.  Kernel 7
(kernels/paged.py) is the walk over explicit rays on page windows: it
launches through :func:`launch_anyhit_rays` and walks plainly through
:func:`tiled_anyhit_plain`.

found is the OR of one predicate over the plan's windows, so the work
items give the whole walk's found in any order: the plain versions walk
each tile whole, and :func:`walk_plain` models the items (``slice_rays``,
``spans``) for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.camera import tile_ray_dirs
from ..ops.intersect import mt_numerators, mt_occludes, xyz
from ..utils.metrics import count, span
from . import build, plan as pl, table
from .nearest import (check_groups, group_walk_masks, rows_max, slice_lanes,
                      span_plan)

PLAIN_ELEMS = 1 << 24   # ray-triangle pairs per step of the plain walks
# the any-hit walk (both ray sources) in spans of RANGE_SPAN_TRIS /
# LIST_SPAN_TRIS triangles, in whole windows: it has no bound to break on,
# so short spans only spread the work (4 and 2 windows of 128 triangles,
# the fastest on every frame that chip_smoke.py sweeps)
RANGE_SPAN_TRIS = 512
LIST_SPAN_TRIS = 256


def tiled_anyhit_from_t(plan, tri, block_obj, t, obj, cam, tile_px: int,
                        window_tris: int, block_size: int, eps: float,
                        no_max_t: bool = True):
    """Hard-shadow query of every tile of ``plan``.

    plan [n, W] i32 (kernels/plan.py layout, windows of ``window_tris``
    triangles, pixel origins in columns 4/5); tri [Tp, 9] and block_obj
    [NB] i32 (accel/prepared.py); t [n, tile] f32 and obj [n, tile] i32
    from the nearest pass; cam [24] (plan.make_cam: the camera and the
    light).  Returns found [n, tile] bool: the ray from the hit point toward
    the light meets a triangle of another object, at any t >= 0 (no max-t
    unless ``no_max_t`` is False).  Miss lanes read True; callers mask."""
    launch, found, _ = anyhit_from_t_call(plan, tri, block_obj, t, obj, cam,
                                          tile_px, window_tris, block_size,
                                          eps, no_max_t)
    launch()
    count("anyhit.tiled_anyhit_from_t.launches")
    return found


def anyhit_from_t_call(plan, tri, block_obj, t, obj, cam, tile_px: int,
                       window_tris: int, block_size: int, eps: float,
                       no_max_t: bool = True, range_span: int = None,
                       list_span: int = None):
    """Check the operands of K2 (CUDA tensors; arguments as
    :func:`tiled_anyhit_from_t`), allocate its output and scratch, and
    return (launch, found [n, tile], sched): ``launch(stages=3)`` queues
    the schedule, which starts found at the miss lanes (1), and the walk
    over (tile, slice, span) items (2).  Spans default to
    :func:`rays_spans`."""
    f32 = torch.float32
    build.check_tensors(plan.device, plan=(plan, torch.int32),
                        tri=(tri, f32), block_obj=(block_obj, torch.int32),
                        t=(t, f32), obj=(obj, torch.int32), cam=(cam, f32))
    n, tile = plan.shape[0], tile_px * tile_px
    if tile_px <= 0 or t.shape != (n, tile) or obj.shape != (n, tile) \
            or cam.shape != (24,):
        raise ValueError(f"t {tuple(t.shape)} / obj {tuple(obj.shape)} / "
                         f"cam {tuple(cam.shape)} for {n} tiles of {tile}")
    n_windows, range_span, list_span, rmax, found, sched = _walk_operands(
        plan, tri, window_tris, block_size, tile, 1, range_span, list_span)

    def launch(stages: int = 3):
        with torch.cuda.device(plan.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = build.library().srt_anyhit_from_t(
                plan.data_ptr(), plan.shape[1], n, tri.data_ptr(),
                block_obj.data_ptr(), n_windows, t.data_ptr(),
                obj.data_ptr(), cam.data_ptr(), tile_px, window_tris,
                block_size, eps, int(no_max_t), found.data_ptr(),
                sched.data_ptr(), rmax, range_span, list_span, stages,
                stream)
        build.check(rc, "anyhit_items_kernel (from t)")
    return launch, found, sched


def _walk_operands(plan, tri, window_tris: int, block_size: int, m: int,
                   groups: int, range_span, list_span):
    """The checks and allocations of the any-hit walk over either ray
    source: the plan and triangle table, windows of whole blocks;
    returns (windows, range span, list span (:func:`rays_spans` by
    default), rows_max, found [n, m] bool, sched [2 + 2 rows_max] i32)."""
    if plan.dim() != 2 or plan.shape[1] <= pl.PLAN_AUX:
        raise ValueError(f"plan shape {tuple(plan.shape)}")
    if tri.dim() != 2 or tri.shape[1] != 9 or tri.data_ptr() % 16:
        raise ValueError(f"tri {tuple(tri.shape)}: want [T, 9], 16-byte "
                         f"aligned")
    if window_tris % block_size or window_tris % 4:
        raise ValueError(f"window of {window_tris} triangles is not whole "
                         f"blocks of {block_size}")
    rs, ls = rays_spans(window_tris)
    range_span, list_span = range_span or rs, list_span or ls
    n_windows = tri.shape[0] // window_tris
    rmax = rows_max(plan, n_windows, range_span, list_span, groups)
    dev = plan.device
    return (n_windows, range_span, list_span, rmax,
            torch.empty((plan.shape[0], m), dtype=torch.bool, device=dev),
            torch.empty(2 + 2 * rmax, dtype=torch.int32, device=dev))


def walk_plain(plan, tri, block_obj, p, s, self_obj, found,
               window_tris: int, block_size: int, eps: float,
               no_max_t: bool, walk_mask=None, slice_rays: int = 0,
               spans=None):
    """The any-hit walk of every plain version: rays (p, s) (3-tuples of
    [n, M]) and self_obj [n, M]; ``found`` [n, M] bool is updated in place
    and returned.  Walks every tile's plan in step, a few tiles at a time,
    until each tile's rays have all found an occluder.  ``walk_mask``
    [n, entries] bool: a list row tests its k-th window only where it is
    set (K5's sub-groups).  Records the work a walk needs on these rays:
    ``walk_plain.lane_pairs`` [n, M] i64, each ray's tests until it found
    an occluder, and ``walk_plain.staged`` [windows] bool, the windows the
    walk read.

    The kernel's work items: ``slice_rays`` > 0 walks each tile's rays as
    slices of that many consecutive lanes, each ending once its own rays
    are all found (a last slice cut short by M is padded with found
    lanes); ``spans`` = (range span, list span) walks the rows span by
    span (:func:`nearest.span_plan`), each span's rays starting from the
    found of the spans before.  The items' found and record are the whole
    walk's."""
    n, m = found.shape
    if 0 < slice_rays < m:
        ns, src = slice_lanes(m, slice_rays, plan.device)

        def cut(x):
            return x[:, src].reshape(n * ns, slice_rays)
        pad = torch.arange(ns * slice_rays, device=plan.device) >= m
        f = cut(found) | pad.repeat(n).reshape(n * ns, slice_rays)
        f = walk_plain(plan.repeat_interleave(ns, dim=0), tri, block_obj,
                       tuple(map(cut, p)), tuple(map(cut, s)), cut(self_obj),
                       f, window_tris, block_size, eps, no_max_t,
                       None if walk_mask is None
                       else walk_mask.repeat_interleave(ns, dim=0),
                       spans=spans)
        found[:] = f.reshape(n, -1)[:, :m]
        walk_plain.lane_pairs = walk_plain.lane_pairs.reshape(n, -1)[:, :m]
        return found
    if spans is not None:
        return _walk_spans(plan, tri, block_obj, p, s, self_obj, found,
                           window_tris, block_size, eps, no_max_t, walk_mask,
                           spans)
    dev = plan.device
    wt, wb = window_tris, window_tris // block_size
    chunk = max(1, PLAIN_ELEMS // max(1, m * wt))
    use_list = plan[:, 3] == 1
    cnt = torch.where(use_list, plan[:, 2], plan[:, 1])
    mv = plan.shape[1] - pl.PLAN_AUX
    jt = torch.arange(wt, dtype=torch.int32, device=dev)
    done = found.all(dim=1)
    lane_pairs = torch.zeros((n, m), dtype=torch.int64, device=dev)
    staged = torch.zeros(tri.shape[0] // wt, dtype=torch.bool, device=dev)
    for k in range(int(cnt.max()) if n else 0):
        live = torch.nonzero((k < cnt) & ~done).flatten()
        walk = live
        if walk_mask is not None:
            walk = live[walk_mask[live, min(k, mv - 1)] | ~use_list[live]]
        for ids in walk.split(chunk):
            e = plan[ids, pl.PLAN_AUX + min(k, mv - 1)]
            w = torch.where(use_list[ids], e & 0xFFFF, plan[ids, 0] + k)
            staged[w.long()] = True
            lane_pairs[ids] += ~found[ids] * wt
            g = tri[(w[:, None] * wt + jt[None, :]).long()]     # [c, wt, 9]
            gv = [g[:, None, :, i] for i in range(9)]           # [c, 1, wt]
            bo = block_obj[(w[:, None] * wb + jt[None, :] // block_size)
                           .long()]                             # [c, wt]
            num = mt_numerators(tuple(x[ids][..., None] for x in p),
                                tuple(x[ids][..., None] for x in s),
                                gv[0:3], gv[3:6], gv[6:9])
            occ = mt_occludes(*num, eps, no_max_t)              # [c, M, wt]
            occ = occ & (bo[:, None, :] != self_obj[ids][..., None])
            found[ids] = found[ids] | occ.any(dim=-1)
        done[live] = found[live].all(dim=1)
    walk_plain.lane_pairs, walk_plain.staged = lane_pairs, staged
    return found


def _walk_spans(plan, tri, block_obj, p, s, self_obj, found,
                window_tris: int, block_size: int, eps: float,
                no_max_t: bool, walk_mask, spans):
    """:func:`walk_plain` of every row's span 0, then span 1, ... of
    ``spans`` = (range span, list span); sets the record as its sum."""
    range_span, list_span = spans
    lst = plan[:, 3] == 1
    nw = tri.shape[0] // window_tris
    most = max(int((-(-plan[~lst, 1] // range_span)).max())
               if bool((~lst).any()) else 0,
               int((-(-plan[lst, 2] // list_span)).max())
               if bool(lst.any()) else 0)
    pairs = torch.zeros(found.shape, dtype=torch.int64, device=plan.device)
    staged = torch.zeros(nw, dtype=torch.bool, device=plan.device)
    for k in range(most):
        sub, mask = span_plan(plan, k, range_span, list_span, walk_mask)
        walk_plain(sub, tri, block_obj, p, s, self_obj, found, window_tris,
                   block_size, eps, no_max_t, mask)
        pairs += walk_plain.lane_pairs
        staged |= walk_plain.staged
    walk_plain.lane_pairs, walk_plain.staged = pairs, staged
    return found


def tiled_anyhit_from_t_plain(plan, tri, block_obj, t, obj, cam,
                              tile_px: int, window_tris: int,
                              block_size: int, eps: float,
                              no_max_t: bool = True, slice_rays: int = 0,
                              spans=None):
    """Plain PyTorch version of :func:`tiled_anyhit_from_t` (same arguments
    and results).  Walks each tile whole, or with
    ``slice_rays`` and ``spans`` the kernel's work items
    (:func:`walk_plain`): the same found either way."""
    dx, dy, dz = tile_ray_dirs(cam, plan[:, 4], plan[:, 5], tile_px)
    hit = torch.isfinite(t)
    ts = torch.where(hit, t, 0.0)
    p = (cam[9] + ts * dx, cam[10] + ts * dy, cam[11] + ts * dz)
    s = (cam[12] - p[0], cam[13] - p[1], cam[14] - p[2])
    return walk_plain(plan, tri, block_obj, p, s, obj, ~hit, window_tris,
                       block_size, eps, no_max_t, slice_rays=slice_rays,
                       spans=spans)


def anyhit_from_t(prep, cfg, t, obj, bounds, cam, cam_spec, maxv: int):
    """Hard-shadow query of the frame (JAX kernels/tiled_t.py::anyhit_from_t
    with sub=1): the shadow plan is built in O(tiles) from the nearest
    kernel's bounds rows (:func:`plan.shadow_bounds`) — interval test, plus
    the projective light-apex test, minus each pure tile's own object, no
    walk for hitless tiles — and K2 ("anyhit_from_t") rebuilds the shadow
    rays from t.  t [R], obj [R], bounds from
    :func:`kernels.nearest.hits_shaded`; ``cam``: the camera row it read
    (:func:`plan.camera` of the light); returns found [R] bool (miss lanes
    read True)."""
    _vmx, _focal, wd, hd, tpx = cam_spec
    n = bounds.shape[0]
    tile = tpx * tpx
    wb = cfg.kernel.window_blocks_ah
    with span("srt.plan.shadow"):
        ab = pl.shadow_bounds(bounds, cam)
        plan = pl.cull(prep, maxv, wb, ab, excl=ab["excl"], apex_rev=True,
                       live=ab["live"], origins=(-(-wd // tpx), tpx, wd, hd))
    with span("srt.anyhit"):
        found = table.run("anyhit_from_t", plan, prep.tri, prep.block_obj,
                          t.reshape(n, tile), obj.reshape(n, tile), cam, tpx,
                          wb * prep.block_size, prep.block_size, cfg.mt_eps,
                          cfg.light.shadow_no_max_t)
    return found.reshape(-1)


def anyhit_rays_call(plan, tri, block_obj, o, d, self_obj,
                     window_tris: int, block_size: int, eps: float,
                     no_max_t: bool, groups: int = 1, range_span: int = None,
                     list_span: int = None, what: str = "anyhit_rays"):
    """Check the operands of the walk over explicit rays (CUDA tensors;
    arguments as :func:`tiled_anyhit`, any M; with ``groups`` > 1 a grouped
    plan and M / groups a multiple of 32), allocate its output and
    scratch, and return (launch, found [n, M], sched):
    ``launch(stages=3)`` queues the schedule, which zeroes found (1), and
    the walk (2).  Spans default to :func:`rays_spans`.  The walk of K2′,
    K5 and K7 (kernels/paged.py)."""
    build.check_tensors(plan.device, plan=(plan, torch.int32),
                        tri=(tri, torch.float32),
                        block_obj=(block_obj, torch.int32),
                        o=(o, torch.float32), d=(d, torch.float32),
                        self_obj=(self_obj, torch.int32))
    n = plan.shape[0]
    if o.dim() != 3 or o.shape[0] != n or o.shape[2] != 3 \
            or d.shape != o.shape or self_obj.shape != o.shape[:2] \
            or o.shape[1] == 0:
        raise ValueError(f"o {tuple(o.shape)} / d {tuple(d.shape)} / "
                         f"self_obj {tuple(self_obj.shape)} for {n} tiles")
    m = o.shape[1]
    check_groups(m, groups)
    n_windows, range_span, list_span, rmax, found, sched = _walk_operands(
        plan, tri, window_tris, block_size, m, groups, range_span, list_span)

    def launch(stages: int = 3):
        with torch.cuda.device(plan.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = build.library().srt_anyhit_rays(
                plan.data_ptr(), plan.shape[1], n, groups, tri.data_ptr(),
                block_obj.data_ptr(), n_windows, o.data_ptr(), d.data_ptr(),
                self_obj.data_ptr(), m, window_tris, block_size, eps,
                int(no_max_t), found.data_ptr(), sched.data_ptr(), rmax,
                range_span, list_span, stages, stream)
        build.check(rc, what)
    return launch, found, sched


def rays_spans(window_tris: int) -> tuple:
    """(range span in windows, list span in entries) of the any-hit walk
    (K2 and the walk over explicit rays) at windows of ``window_tris``
    triangles."""
    return (max(1, RANGE_SPAN_TRIS // window_tris),
            max(1, LIST_SPAN_TRIS // window_tris))


def launch_anyhit_rays(plan, tri, block_obj, o, d, self_obj,
                       window_tris: int, block_size: int, eps: float,
                       no_max_t: bool, groups: int = 1,
                       what: str = "anyhit_rays") -> torch.Tensor:
    """:func:`anyhit_rays_call` launched once: returns found [n, M]."""
    launch, found, _ = anyhit_rays_call(plan, tri, block_obj, o, d,
                                        self_obj, window_tris, block_size,
                                        eps, no_max_t, groups, what=what)
    launch()
    return found


def rays_shape(window_tris: int, block_size: int, m: int,
               groups: int = 1, from_t: bool = False) -> dict:
    """The walk over explicit rays (or with ``from_t`` K2's walk, one
    group) on the current card for windows of ``window_tris`` triangles
    and tiles of ``m`` rays in ``groups`` sub-groups: CTAs per SM,
    registers per thread, SMs, rays per slice and threads per CTA."""
    out = (ctypes.c_int * 5)()
    lib, ptr = build.library(), ctypes.cast(out, ctypes.c_void_p)
    rc = (lib.srt_anyhit_from_t_shape(window_tris, block_size, m, ptr)
          if from_t else
          lib.srt_anyhit_rays_shape(window_tris, block_size, m, groups, ptr))
    build.check(rc, "srt_anyhit_rays_shape")
    return dict(zip(("ctas_per_sm", "registers", "sms", "slice_rays",
                     "threads"), out))


def tiled_anyhit(plan, tri, block_obj, o, d, self_obj, window_tris: int,
                 block_size: int, eps: float, no_max_t: bool = True):
    """Occlusion query over explicit rays, one plan row per tile.

    plan [n, W] i32 (kernels/plan.py layout, windows of ``window_tris``
    triangles, e.g. from plan.cull_occl); tri [Tp, 9] and block_obj [NB]
    i32 (accel/prepared.py); o, d [n, M, 3] f32 the rays o + t*d of each
    tile (any M); self_obj [n, M] i32 each ray's own object.  Returns
    found [n, M] bool: the ray meets a triangle of another object at t >= 0
    (and t <= 1 unless ``no_max_t``)."""
    found = launch_anyhit_rays(plan, tri, block_obj, o, d, self_obj,
                               window_tris, block_size, eps, no_max_t)
    count("anyhit.tiled_anyhit.launches")
    return found


def tiled_anyhit_plain(plan, tri, block_obj, o, d, self_obj,
                       window_tris: int, block_size: int, eps: float,
                       no_max_t: bool = True):
    """Plain PyTorch version of :func:`tiled_anyhit` (same arguments and
    results)."""
    p = (o[..., 0], o[..., 1], o[..., 2])
    s = (d[..., 0], d[..., 1], d[..., 2])
    found = torch.zeros(self_obj.shape, dtype=torch.bool, device=plan.device)
    return walk_plain(plan, tri, block_obj, p, s, self_obj, found,
                       window_tris, block_size, eps, no_max_t)


def tiled_anyhit_grouped(plan, tri, block_obj, o, d, self_obj,
                         window_tris: int, block_size: int, eps: float,
                         no_max_t: bool, groups: int):
    """K5: :func:`tiled_anyhit` over a grouped plan
    (plan.group_mask_words): the tile's M rays are ``groups`` sub-groups
    of M / groups consecutive lanes (a multiple of 32); a sub-group skips
    the entries whose mask bit it lacks.  Same results as the ungrouped
    walk of the plan's entries."""
    found = launch_anyhit_rays(plan, tri, block_obj, o, d, self_obj,
                               window_tris, block_size, eps, no_max_t,
                               groups, "anyhit_rays (sub-groups)")
    count("anyhit.tiled_anyhit_grouped.launches")
    return found


def tiled_anyhit_grouped_plain(plan, tri, block_obj, o, d, self_obj,
                               window_tris: int, block_size: int, eps: float,
                               no_max_t: bool, groups: int):
    """Plain PyTorch version of :func:`tiled_anyhit_grouped` (same
    arguments and results): :func:`walk_plain` over
    the n * groups sub-tiles, each with its mask."""
    n, m = self_obj.shape
    check_groups(m, groups)
    sub, mask = group_walk_masks(plan, groups)
    gr = m // groups
    o2, d2 = o.reshape(n * groups, gr, 3), d.reshape(n * groups, gr, 3)
    found = torch.zeros((n * groups, gr), dtype=torch.bool,
                        device=plan.device)
    found = walk_plain(sub, tri, block_obj, xyz(o2), xyz(d2),
                       self_obj.reshape(n * groups, gr), found, window_tris,
                       block_size, eps, no_max_t, walk_mask=mask)
    walk_plain.lane_pairs = walk_plain.lane_pairs.reshape(n, m)
    return found.reshape(n, m)


def anyhit(prep, cfg, o, d, self_obj2d, plan, tile: int,
           window_tris: int = None, groups: int = 1, role: str = "anyhit"):
    """Occlusion of explicit rays (JAX kernels/tiled_t.py::anyhit): o, d
    [R, 3] (padded here to whole tiles by repeating the last ray),
    self_obj2d [n, tile] i32, ``plan`` from plan.cull_occl with windows of
    ``window_tris`` triangles (None: cfg.kernel.window_blocks_ah blocks),
    walked by ``role`` of kernels/table.py (K2′; "anyhit_pages": K7).
    ``groups`` > 1: the plan is grouped and K5 ("anyhit_grouped") walks
    it.  Returns found [n, tile] bool."""
    with span("srt.anyhit"):
        o, d, _ = pl.pad_rays(o, d, tile)
        n = o.shape[0] // tile
        wt = window_tris or cfg.kernel.window_blocks_ah * prep.block_size
        args = (plan, prep.tri, prep.block_obj,
                o.reshape(n, tile, 3).contiguous(),
                d.reshape(n, tile, 3).contiguous(),
                self_obj2d.to(torch.int32).contiguous(), wt,
                prep.block_size, cfg.mt_eps, cfg.light.shadow_no_max_t)
        if groups > 1:
            return table.run("anyhit_grouped", *args, groups)
        return table.run(role, *args)
