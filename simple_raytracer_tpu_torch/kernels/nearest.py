"""Kernels 1 and 4: the nearest-hit walks of the sublane layout.

``tiled_nearest_shaded`` wraps K1 (csrc/nearest.cu: a schedule launch, a
persistent walk over (tile, ray slice, window span) work items, and an
epilogue launch) in its fused modes (JAX ``_fused_phong``'s attribute
modes: 0 flat, 1 textured, 2 smooth normals) and ``tiled_nearest_attrs``
in its fetch mode; ``tiled_nearest_rays`` wraps the walk over the explicit
rays of each tile (csrc/nearest.cu ``nearest_rays``: the same schedule, a
persistent walk over work items, and a key decode), and
``tiled_nearest_rays_attrs`` the same walk in the fetch mode over explicit
rays (the decode also fetches the winner's attribute row).  Together they
replace the JAX package's Pallas kernel
``kernels/tiled_t.py::_nearest_kernel_t`` (fused on the fused frame's path,
fetch on the soft-shadow and sublane gather paths, explicit rays on the
prepass walk's rerun and on range-only plans, fetch over explicit rays on
the flat frames of ``hit_tile`` sub-tiles and of normalized directions).
``tiled_nearest_grouped`` wraps the walk over explicit rays on a grouped
plan and replaces ``tiled_t.py::_nearest_kernel_g`` (K4,
``KernelConfig.groups`` > 1).  Each ``*_plain`` function is the plain
PyTorch version of its wrapper: same arguments, same results.  Each wrapper
takes CUDA tensors, launches its kernel (a call is three launches) and
counts the launch (``nearest.<wrapper>.launches``); kernels/table.py
chooses between a wrapper and its plain version and counts the calls.  :func:`work_rows`, :func:`hit_keys`,
:func:`merge_keys` and :func:`decode_keys` are the plain versions of the
walks' schedule and of their per-ray merge keys.

``hits_shaded``, ``hits_attrs`` and ``hits`` are the counterparts of the JAX
``tiled_t.hits_shaded``, ``tiled_t.hits_attrs`` and ``tiled_t.hits``: they
build the plan and the per-frame constants and run the kernels.
:func:`walk_plain`, the plain walk, also serves kernel 6
(kernels/paged.py), as the device walk over explicit rays does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops.camera import tile_ray_dirs
from ..ops.intersect import mt_distance, mt_numerators, xyz
from ..utils.metrics import count, span
from . import build, plan as pl, table
from .prepass import refine_plan

BOUNDS_W = 15
MAP_W = 12              # floats of a tri_tex_map / tri_nrm_map row
# K1's attribute modes (JAX tiled_t.py::_fused_phong attr_mode): flat
# normals and rgb, textured factors and texel coordinates, smooth normals
FLAT, TEXTURED, SMOOTH = 0, 1, 2
MODES = (FLAT, TEXTURED, SMOOTH)
INF = float("inf")
PLAIN_ELEMS = 1 << 24   # ray-triangle pairs per step of the plain walk
# K1's work items (csrc/nearest.cu): slices of K1_SLICE consecutive tile
# lanes (csrc/common.cuh kItemSlice, the most rays of any walk's item),
# range rows in spans of K1_RANGE_SPAN windows, list rows in spans of
# K1_LIST_SPAN entries; K1_STAGES selects all three launches; FETCH is the
# fetch mode's number
K1_SLICE = 512
K1_RANGE_SPAN = 16
K1_LIST_SPAN = 32
K1_STAGES = 7
# the walk over explicit rays: range spans of RANGE_SPAN_TRIS and list
# spans of LIST_SPAN_TRIS triangles, in whole windows (K1's 16 and 32
# windows of 64 triangles); RAYS_STAGES selects the schedule, the walk and
# the key decode
RANGE_SPAN_TRIS = 1024
LIST_SPAN_TRIS = 2048
RAYS_STAGES = 7
FETCH = -1
MISS_KEY = -1           # the all-ones key of a ray with no hit


def material_table(scene, light_color) -> torch.Tensor:
    """[O, 8] f32 per object: (1/pi) color * light (3), specular * light (3),
    ambient, shininess — the premultiplied Phong constants of the kernel."""
    lc = torch.as_tensor(light_color, dtype=torch.float32,
                         device=scene.obj_color.device)
    inv_pi = torch.tensor(1.0 / math.pi, dtype=torch.float32,
                          device=lc.device)
    return torch.cat([inv_pi * scene.obj_color * lc,
                      scene.obj_specular[:, None] * lc,
                      scene.obj_ambient[:, None],
                      scene.obj_shininess[:, None]], dim=1).contiguous()


def _check(plan, tri, tri_attr, cam, tile_px, window_tris, mat=None,
           attr_map=None):
    f32 = torch.float32
    ops = dict(plan=(plan, torch.int32), tri=(tri, f32),
               tri_attr=(tri_attr, f32), cam=(cam, f32))
    if mat is not None:
        ops["mat"] = (mat, f32)
    if attr_map is not None:
        ops["attr_map"] = (attr_map, f32)
    build.check_tensors(plan.device, **ops)
    tile = tile_px * tile_px
    if tile % 32 or (tile > K1_SLICE and tile % K1_SLICE):
        raise ValueError(f"a tile of {tile} rays is not whole warps in "
                         f"whole {K1_SLICE}-ray slices")
    if plan.dim() != 2 or plan.shape[1] <= pl.PLAN_AUX:
        raise ValueError(f"plan shape {tuple(plan.shape)}")
    if tri.dim() != 2 or tri.shape[1] != 9 \
            or tri_attr.shape != (tri.shape[0], 4) or window_tris % 4:
        raise ValueError(f"tri {tuple(tri.shape)} / tri_attr "
                         f"{tuple(tri_attr.shape)} in windows of "
                         f"{window_tris}")
    if attr_map is not None and attr_map.shape != (tri.shape[0], MAP_W):
        raise ValueError(f"attr_map {tuple(attr_map.shape)} for "
                         f"{tri.shape[0]} triangles")
    # the kernel stages tri in 16-byte copies and loads tri_attr rows as
    # float4, attr_map rows as 3 float4
    for name, x in (("tri", tri), ("tri_attr", tri_attr),
                    ("attr_map", attr_map)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if cam.shape != (24,) or (mat is not None
                              and (mat.dim() != 2 or mat.shape[1] != 8)):
        raise ValueError(f"cam {tuple(cam.shape)} / mat "
                         f"{None if mat is None else tuple(mat.shape)}")


def shade_width(mode: int) -> int:
    """Columns of K1's shading output in attribute ``mode``: rgb (3) in
    modes 0 and 2, the textured factors (6) in mode 1."""
    if mode not in MODES:
        raise ValueError(f"unknown attribute mode {mode}")
    return 6 if mode == TEXTURED else 3


def k1_slices(tile: int) -> int:
    """Work items of a K1 tile of ``tile`` rays for each of its spans: its
    slices of :data:`K1_SLICE` consecutive lanes (one for a smaller
    tile)."""
    return max(1, tile // K1_SLICE)


def k1_call(plan, tri, tri_attr, cam, tile_px: int, window_tris: int,
            eps: float, mode: int = FETCH, mat=None, attr_map=None,
            double_sided: bool = True, specular_nl: bool = True,
            range_span: int = K1_RANGE_SPAN,
            list_span: int = K1_LIST_SPAN):
    """Check K1's operands (CUDA tensors; arguments as
    :func:`tiled_nearest_shaded`, ``mode`` FETCH for the fetch mode),
    allocate its outputs and scratch, and return (launch, outs, sched).
    ``launch(stages=K1_STAGES)`` queues K1's launches of ``stages`` (1 the
    schedule and the key fill, 2 the walk, 4 the epilogue) on the current
    stream; the walk consumes the schedule's item counter, so it follows a
    schedule launch.  ``outs`` = (t, idx, obj, shade, bounds), or (t, idx,
    attrs) in the fetch mode; ``sched`` [2 + 2 * rows] i32 the schedule:
    the item counter, the row count, then (tile, span) per row, longest
    walk first.  ``range_span`` and ``list_span`` are the windows of a
    range row's spans and the entries of a list row's."""
    if (attr_map is None) != (mode in (FLAT, FETCH)):
        raise ValueError(f"mode {mode} with attr_map "
                         f"{'absent' if attr_map is None else 'given'}")
    width = 0 if mode == FETCH else shade_width(mode)
    _check(plan, tri, tri_attr, cam, tile_px, window_tris, mat, attr_map)
    n, tile = plan.shape[0], tile_px * tile_px
    n_windows = tri.shape[0] // window_tris
    rmax = rows_max(plan, n_windows, range_span, list_span)
    kw = dict(device=plan.device)
    t = torch.empty((n, tile), dtype=torch.float32, **kw)
    idx = torch.empty((n, tile), dtype=torch.int32, **kw)
    keys = torch.empty(n * tile, dtype=torch.int64, **kw)
    sched = torch.empty(2 + 2 * rmax, dtype=torch.int32, **kw)
    if mode == FETCH:
        outs = (t, idx, torch.empty((n * tile, 4), dtype=torch.float32,
                                    **kw))
        ptrs = (0, 0, 0, outs[2].data_ptr())
    else:
        outs = (t, idx, torch.empty((n, tile), dtype=torch.int32, **kw),
                torch.empty((n * tile, width), dtype=torch.float32, **kw),
                torch.empty((n, BOUNDS_W), dtype=torch.float32, **kw))
        ptrs = (outs[2].data_ptr(), outs[3].data_ptr(), outs[4].data_ptr(),
                0)
    what = "K1 (fetch mode)" if mode == FETCH else f"K1 (mode {mode})"

    def launch(stages: int = K1_STAGES):
        with torch.cuda.device(plan.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = build.library().srt_nearest_k1(
                plan.data_ptr(), plan.shape[1], n, tri.data_ptr(),
                tri_attr.data_ptr(), n_windows,
                0 if mat is None else mat.data_ptr(),
                0 if mat is None else mat.shape[0], cam.data_ptr(), tile_px,
                window_tris, eps, int(double_sided), int(specular_nl), mode,
                0 if attr_map is None else attr_map.data_ptr(),
                t.data_ptr(), idx.data_ptr(), *ptrs, keys.data_ptr(),
                sched.data_ptr(), rmax, range_span, list_span, stages,
                stream)
        build.check(rc, what)
    return launch, outs, sched


def k1_shape(window_tris: int) -> dict:
    """K1's walk on the current card for windows of ``window_tris``
    triangles: CTAs per SM (the occupancy its launch fills), registers per
    thread, SMs, rays per slice and threads per CTA."""
    out = (ctypes.c_int * 5)()
    build.check(build.library().srt_k1_shape(window_tris,
                                             ctypes.cast(out,
                                                         ctypes.c_void_p)),
                "srt_k1_shape")
    return dict(zip(("ctas_per_sm", "registers", "sms", "slice_rays",
                     "threads"), out))


def tiled_nearest_shaded(plan, tri, tri_attr, mat, cam, tile_px: int,
                         window_tris: int, eps: float,
                         double_sided: bool = True,
                         specular_nl: bool = True, mode: int = FLAT,
                         attr_map=None):
    """Nearest hit + Phong + bounds of every tile of ``plan``.

    plan [n, W] i32 (kernels/plan.py layout, pixel origins in columns 4/5);
    tri [Tp, 9] and tri_attr [Tp, 4] (accel/prepared.py); mat [O, 8]
    (:func:`material_table`); cam [24] (plan.make_cam, with the shadow
    frame); a window is ``window_tris`` consecutive triangles.  ``mode``
    (JAX ``_fused_phong`` attr_mode): FLAT shades with the flat normal;
    SMOOTH with normalize(An p + cn) from ``attr_map`` = tri_nrm_map;
    TEXTURED emits the colour-free Phong factors and the texel coordinates
    of ``attr_map`` = tri_tex_map at the hit point.  K1's blocks are the
    kernel's own (csrc/nearest.cu).
    Returns t [n, tile] f32 (inf on a miss), idx [n, tile] i32 (-1),
    obj [n, tile] i32 (-1), the shading rows [n * tile, 3 or 6] f32 (FLAT,
    SMOOTH: unshadowed pre-tonemap rgb, 0 on a miss; TEXTURED: dw = n.l
    term + ambient, sw = specular weight, texu, texv, obj, tex id;
    (0, 0, 0, 0, -1, -1) on a miss) and bounds [n, 15] f32 (see
    plan.analytic_shadow_bounds_exact)."""
    shade_width(mode)
    launch, outs, _ = k1_call(plan, tri, tri_attr, cam, tile_px,
                              window_tris, eps, mode, mat, attr_map,
                              double_sided, specular_nl)
    launch()
    count("nearest.tiled_nearest_shaded.launches")
    count(f"nearest.tiled_nearest_shaded.mode_launches.{mode}")
    return outs


def tiled_nearest_attrs(plan, tri, tri_attr, cam, tile_px: int,
                        window_tris: int, eps: float):
    """Nearest hit + the winner's attribute row over every tile of ``plan``
    (K1's fetch mode).  Arguments as :func:`tiled_nearest_shaded` (``cam``'s
    light and frame are not read).  Returns t [n, tile] f32 (inf on a
    miss), idx [n, tile] i32 (-1) and attrs [n * tile, 4] f32: the winner's
    ``tri_attr`` row (flat normal xyz, object id), (0, 0, 0, -1) on a
    miss."""
    launch, outs, _ = k1_call(plan, tri, tri_attr, cam, tile_px,
                              window_tris, eps)
    launch()
    count("nearest.tiled_nearest_attrs.launches")
    return outs


def work_rows(plan, n_windows: int, range_span: int = K1_RANGE_SPAN,
              list_span: int = K1_LIST_SPAN):
    """The plain version of the walks' schedule (srt::schedule_rows: K1,
    the walks over explicit rays of nearest.cu and anyhit.cu): its rows
    (tile, span) [N, 2] i32 and their walk lengths [N], longest first
    (equal lengths by tile, then span; the kernel places those in any
    order).  A list row walks its list in spans of ``list_span`` entries; a
    range row its covering range, clamped to the ``n_windows`` windows
    that exist, in spans of ``range_span`` windows.  A grouped plan's rows
    are its entries' rows.  Each row is one work item per slice of its
    tile (:func:`k1_slices`, :func:`rays_slices`).  The repeats' sizes are
    read on the host, so this is no part of a frame."""
    every = torch.arange(plan.shape[0], device=plan.device)
    whole = row_lengths(plan, torch.stack([every, 0 * every], dim=1),
                        n_windows, 1 << 30, 1 << 30)
    span = torch.where(plan[:, 3] == 1, list_span, range_span)
    spans = (whole + span - 1) // span
    tile = torch.repeat_interleave(every, spans)
    s = (torch.arange(tile.numel(), device=plan.device)
         - torch.repeat_interleave(torch.cumsum(spans, 0) - spans, spans))
    rows = torch.stack([tile, s], dim=1).to(torch.int32)
    length = row_lengths(plan, rows, n_windows, range_span, list_span)
    order = torch.argsort(-length, stable=True)
    return rows[order], length[order]


def row_lengths(plan, rows, n_windows: int, range_span: int = K1_RANGE_SPAN,
                list_span: int = K1_LIST_SPAN):
    """Walk lengths [N] of the schedule's rows (tile, span) [N, 2] on
    ``plan``: the span's entries of a list row, or its windows of a range
    row's covering range (clamped to the ``n_windows`` windows that
    exist)."""
    tile, s = rows[:, 0].long(), rows[:, 1].long()
    lst = plan[tile, 3] == 1
    cnt = torch.where(lst, plan[tile, 2], torch.minimum(
        plan[tile, 1], (n_windows - plan[tile, 0]).clamp_min(0)))
    span = torch.where(lst, list_span, range_span)
    return torch.minimum(cnt - s * span, span)


def rows_max(plan, n_windows: int, range_span: int, list_span: int,
             groups: int = 1) -> int:
    """Rows the schedule of ``plan`` can list at most (its scratch): each
    tile's range in spans, or its list of up to the plan's entries."""
    mv = plan.shape[1] - pl.PLAN_AUX
    if groups > 1:
        mv = mv * 8 // 9
    return plan.shape[0] * (1 + max(n_windows // range_span,
                                    mv // list_span))


def span_plan(plan, s: int, range_span: int, list_span: int,
              walk_mask=None):
    """The plan whose every row walks only its span ``s`` (the schedule's
    row (tile, s)): a range row the windows [lo + s * range_span, ...) of
    its range (``range_span`` 0: the whole range, in span 0), a list row
    its entries from s * list_span (their bounds with them), at most one
    span of each; rows with fewer spans walk nothing.  ``walk_mask`` [n,
    entries] shifts with the entries.  Returns (plan, walk_mask)."""
    aux, mv = pl.PLAN_AUX, plan.shape[1] - pl.PLAN_AUX
    lst = plan[:, 3] == 1
    sub = plan.clone()
    l0 = s * list_span
    if range_span:
        r0 = s * range_span
        sub[~lst, 0] = plan[~lst, 0] + r0
        sub[~lst, 1] = (plan[~lst, 1] - r0).clamp(0, range_span)
    elif s:
        sub[~lst, 1] = 0
    sub[lst, 2] = (plan[lst, 2] - l0).clamp(0, list_span)
    mask = walk_mask
    if l0:
        sub[lst, aux:aux + max(0, mv - l0)] = plan[lst, aux + l0:]
        if walk_mask is not None:
            mask = walk_mask.clone()
            mask[lst, :max(0, mv - l0)] = walk_mask[lst, l0:]
    return sub, mask


def slice_rays(m: int, groups: int = 1) -> int:
    """Rays of a work item of the walks over explicit rays, for tiles of
    ``m`` rays in ``groups`` sub-groups (srt::slice_rays): at most
    :data:`K1_SLICE`, inside one sub-group, in whole warps."""
    return min(K1_SLICE, -(-(m // groups) // 32) * 32)


def slice_lanes(m: int, slice_rays: int, device):
    """M lanes cut into slices of ``slice_rays``: (slices, the lane each
    slice position reads [slices * slice_rays]); the positions past M read
    their slice's first lane."""
    ns = -(-m // slice_rays)
    lane = torch.arange(ns * slice_rays, device=device)
    return ns, torch.where(lane < m, lane, lane // slice_rays * slice_rays)


def rays_slices(m: int, groups: int = 1) -> int:
    """Work items of a tile of ``m`` rays in ``groups`` sub-groups for each
    of its spans: the slices of each sub-group, the last one cut short
    where the group is not a whole number of slices."""
    return groups * -(-(m // groups) // slice_rays(m, groups))


def rays_spans(window_tris: int) -> tuple:
    """(range span in windows, list span in entries) of the walks over
    explicit rays at windows of ``window_tris`` triangles."""
    return (max(1, RANGE_SPAN_TRIS // window_tris),
            max(1, LIST_SPAN_TRIS // window_tris))


def hit_keys(t, idx):
    """The plain version of K1's merge keys (csrc/nearest.cu::hit_key) of
    hits t >= 0 with ids ``idx`` (any shape): the bits of t, -0.0 as +0.0,
    over the id as an int64; a miss (idx < 0) is MISS_KEY.  Hit keys lie
    below 2**63, so their int64 order is the kernel's unsigned order."""
    bits = torch.where(t == 0.0, torch.zeros_like(t), t).view(torch.int32)
    key = ((bits.to(torch.int64) & 0xFFFFFFFF) << 32) \
        | (idx.to(torch.int64) & 0xFFFFFFFF)
    return torch.where(idx >= 0, key, MISS_KEY)


def merge_keys(a, b):
    """The kernel's atomicMin of keys: the unsigned minimum, so MISS_KEY
    (all ones) loses to every hit."""
    flip = -(1 << 63)                    # unsigned order as signed order
    return torch.where((a ^ flip) < (b ^ flip), a, b)


def decode_keys(keys):
    """(t f32, idx i32) of keys, as K1's epilogue reads them: a key whose
    t is not finite (MISS_KEY's bits are a NaN) is a miss, t = inf, idx =
    -1."""
    t = (keys >> 32).to(torch.int32).view(torch.float32)
    hit = torch.isfinite(t)
    return (torch.where(hit, t, INF),
            torch.where(hit, (keys & 0xFFFFFFFF).to(torch.int32), -1))


def rays_call(plan, tri, o, d, window_tris: int, eps: float,
              groups: int = 1, range_span: int = None,
              list_span: int = None, what: str = "nearest_rays",
              tri_attr=None):
    """Check the operands of the walk over explicit rays (CUDA tensors:
    plan [n, W] i32, windows of ``window_tris`` triangles, with ``groups``
    > 1 a grouped plan; tri [Tp, 9]; o, d [n, M, 3] f32, any M, with
    groups M / groups a multiple of 32), allocate its outputs and scratch,
    and return (launch, (t [n, M], idx [n, M]), sched) as :func:`k1_call`
    does: ``launch(stages=RAYS_STAGES)`` queues the schedule and key fill
    (1), the walk (2) and the key decode (4).  With ``tri_attr`` [Tp, 4]
    (the fetch mode over explicit rays) the decode also writes the
    winner's row, and the outputs are (t, idx, attrs [n * M, 4]).  Spans
    default to :func:`rays_spans`.  The walk of K1's rays and fetch-over-
    rays modes, K4 and K6 (kernels/paged.py)."""
    ops = dict(plan=(plan, torch.int32), tri=(tri, torch.float32),
               o=(o, torch.float32), d=(d, torch.float32))
    if tri_attr is not None:
        ops["tri_attr"] = (tri_attr, torch.float32)
    build.check_tensors(plan.device, **ops)
    n = plan.shape[0]
    if plan.dim() != 2 or plan.shape[1] <= pl.PLAN_AUX:
        raise ValueError(f"plan shape {tuple(plan.shape)}")
    if tri.dim() != 2 or tri.shape[1] != 9 or tri.shape[0] % window_tris \
            or window_tris % 4:
        raise ValueError(f"tri shape {tuple(tri.shape)} for windows of "
                         f"{window_tris}")
    if tri.data_ptr() % 16:
        raise ValueError("tri is not 16-byte aligned")
    if tri_attr is not None and (tri_attr.shape != (tri.shape[0], 4)
                                 or tri_attr.data_ptr() % 16):
        raise ValueError(f"tri_attr {tuple(tri_attr.shape)} for "
                         f"{tri.shape[0]} triangles, 16-byte aligned")
    if o.dim() != 3 or o.shape[0] != n or o.shape[2] != 3 \
            or d.shape != o.shape or o.shape[1] == 0:
        raise ValueError(f"o {tuple(o.shape)} / d {tuple(d.shape)} for {n} "
                         f"tiles")
    m = o.shape[1]
    check_groups(m, groups)
    rs, ls = rays_spans(window_tris)
    range_span, list_span = range_span or rs, list_span or ls
    n_windows = tri.shape[0] // window_tris
    rmax = rows_max(plan, n_windows, range_span, list_span, groups)
    kw = dict(device=plan.device)
    t = torch.empty((n, m), dtype=torch.float32, **kw)
    idx = torch.empty((n, m), dtype=torch.int32, **kw)
    keys = torch.empty(n * m, dtype=torch.int64, **kw)
    sched = torch.empty(2 + 2 * rmax, dtype=torch.int32, **kw)
    outs = (t, idx)
    if tri_attr is not None:
        outs += (torch.empty((n * m, 4), dtype=torch.float32, **kw),)
    fetch = ((tri_attr.data_ptr(), outs[2].data_ptr())
             if tri_attr is not None else (0, 0))

    def launch(stages: int = RAYS_STAGES):
        with torch.cuda.device(plan.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = build.library().srt_nearest_rays(
                plan.data_ptr(), plan.shape[1], n, groups, tri.data_ptr(),
                n_windows, o.data_ptr(), d.data_ptr(), m, window_tris, eps,
                t.data_ptr(), idx.data_ptr(), *fetch, keys.data_ptr(),
                sched.data_ptr(), rmax, range_span, list_span, stages, stream)
        build.check(rc, what)
    return launch, outs, sched


def launch_nearest_rays(plan, tri, o, d, window_tris: int, eps: float,
                        groups: int = 1, what: str = "nearest_rays"):
    """:func:`rays_call` launched once: returns (t [n, M], idx [n, M])."""
    launch, outs, _ = rays_call(plan, tri, o, d, window_tris, eps, groups,
                                what=what)
    launch()
    return outs


def rays_shape(window_tris: int, m: int, groups: int = 1) -> dict:
    """The walk over explicit rays on the current card for windows of
    ``window_tris`` triangles and tiles of ``m`` rays in ``groups``
    sub-groups: as :func:`k1_shape`."""
    out = (ctypes.c_int * 5)()
    build.check(build.library().srt_nearest_rays_shape(
        window_tris, m, groups, ctypes.cast(out, ctypes.c_void_p)),
        "srt_nearest_rays_shape")
    return dict(zip(("ctas_per_sm", "registers", "sms", "slice_rays",
                     "threads"), out))


def check_groups(m: int, groups: int) -> None:
    """Raise ValueError unless ``groups`` (1..4) splits M rays into
    sub-groups of a multiple of 32 lanes: whole warps, so that a group's
    skips and breaks are warp-uniform."""
    if not 1 <= groups <= 4 or (groups > 1 and (m % groups
                                                or (m // groups) % 32)):
        raise ValueError(f"{groups} sub-groups of {m} rays are not whole "
                         f"warps")


def tiled_nearest_rays(plan, tri, o, d, window_tris: int, eps: float):
    """K1 over explicit rays: the nearest hit of rays o, d [n, M, 3] over
    every tile of ``plan`` (windows of ``window_tris`` triangles; the
    prepass walk's refined plan).  Returns t [n, M] f32 (inf on a miss) and
    idx [n, M] i32 (-1); equal t goes to the lowest triangle id."""
    outs = launch_nearest_rays(plan, tri, o, d, window_tris, eps)
    count("nearest.tiled_nearest_rays.launches")
    return outs


def tiled_nearest_rays_plain(plan, tri, o, d, window_tris: int, eps: float):
    """Plain PyTorch version of :func:`tiled_nearest_rays` (same arguments
    and results): :func:`walk_plain` in the
    kernel's slices and list spans."""
    return walk_plain(plan, tri, xyz(o), xyz(d), window_tris, eps,
                      slice_rays=slice_rays(o.shape[1]),
                      list_span=rays_spans(window_tris)[1])


def tiled_nearest_rays_attrs(plan, tri, tri_attr, o, d, window_tris: int,
                             eps: float):
    """K1's fetch mode over explicit rays: :func:`tiled_nearest_rays` and
    the winner's ``tri_attr`` [Tp, 4] row, fetched by the key decode.
    Returns t [n, M] f32 (inf on a miss), idx [n, M] i32 (-1) and attrs
    [n * M, 4] f32 (flat normal xyz, object id; (0, 0, 0, -1) on a miss),
    as :func:`tiled_nearest_attrs`."""
    launch, outs, _ = rays_call(plan, tri, o, d, window_tris, eps,
                                what="nearest_rays (fetch mode)",
                                tri_attr=tri_attr)
    launch()
    count("nearest.tiled_nearest_rays_attrs.launches")
    return outs


def tiled_nearest_rays_attrs_plain(plan, tri, tri_attr, o, d,
                                   window_tris: int, eps: float):
    """Plain PyTorch version of :func:`tiled_nearest_rays_attrs` (same
    arguments and results): :func:`tiled_nearest_rays_plain`, then the
    winners' rows."""
    t, idx = tiled_nearest_rays_plain(plan, tri, o, d, window_tris, eps)
    return t, idx, fetch_rows(tri_attr, idx)


def tiled_nearest_grouped(plan, tri, o, d, window_tris: int, eps: float,
                          groups: int):
    """K4: :func:`tiled_nearest_rays` over a grouped plan
    (plan.group_mask_words): the tile's M rays are ``groups`` sub-groups
    of M / groups consecutive lanes (a multiple of 32); a sub-group skips
    the entries whose mask bit it lacks and stops at its own bound test.
    Same results as the ungrouped walk of the plan's entries."""
    outs = launch_nearest_rays(plan, tri, o, d, window_tris, eps, groups,
                               "nearest_rays (sub-groups)")
    count("nearest.tiled_nearest_grouped.launches")
    return outs


def group_walk_masks(plan, groups: int):
    """A grouped plan [n, 8 + mv + mv / 8] -> (its plan without the mask
    words, repeated per sub-group [n * groups, 8 + mv], the walk mask
    [n * groups, mv] bool: sub-group g of tile t walks entry k where bit g
    of its mask is set)."""
    n, width = plan.shape
    mv = (width - pl.PLAN_AUX) * 8 // 9
    words = plan[:, pl.PLAN_AUX + mv:]
    pos = torch.arange(mv, device=plan.device)
    m4 = (words[:, pos // 8] >> (4 * (pos % 8))) & 0xF          # [n, mv]
    g = torch.arange(groups, device=plan.device)
    mask = ((m4[:, None, :] >> g[None, :, None]) & 1) == 1       # [n, G, mv]
    sub = plan[:, :pl.PLAN_AUX + mv].repeat_interleave(groups, dim=0)
    return sub.contiguous(), mask.reshape(n * groups, mv)


def tiled_nearest_grouped_plain(plan, tri, o, d, window_tris: int,
                                eps: float, groups: int):
    """Plain PyTorch version of :func:`tiled_nearest_grouped` (same
    arguments and results): :func:`walk_plain` over
    the n * groups sub-tiles, each with its mask, in the kernel's slices
    and list spans."""
    n, m = o.shape[:2]
    check_groups(m, groups)
    sub, mask = group_walk_masks(plan, groups)
    gr = m // groups
    t, idx = walk_plain(sub, tri, xyz(o.reshape(n * groups, gr, 3)),
                        xyz(d.reshape(n * groups, gr, 3)), window_tris, eps,
                        walk_mask=mask, slice_rays=slice_rays(m, groups),
                        list_span=rays_spans(window_tris)[1])
    walk_plain.lane_pairs = walk_plain.lane_pairs.reshape(n, m)
    return t.reshape(n, m), idx.reshape(n, m)


def material_rows(mat, obj):
    """Rows [..., 8] of ``mat`` for object ids ``obj`` [...]; ids outside
    the table read zeros (the kernel's rule, and JAX's unrolled select)."""
    ok = (obj >= 0) & (obj < mat.shape[0])
    return torch.where(ok[..., None], mat[obj.clamp(0, mat.shape[0] - 1)],
                       0.0)


def phong_factors(normal, point, d, light, amb, shin, double_sided: bool,
                  specular_nl: bool):
    """The colour-free factors of the kernel's Phong term (JAX
    kernels/tiled_t.py::_fused_phong) on 3-tuples of [...] tensors: normal,
    hit point, ray direction and light; ambient and shininess [...].
    Returns (dw = the n.l term + ambient, sw = the specular weight)."""
    nx, ny, nz = normal
    lx, ly, lz = (light[c] - point[c] for c in range(3))
    li = torch.rsqrt((lx * lx + ly * ly + lz * lz).clamp_min(1e-30))
    lx, ly, lz = lx * li, ly * li, lz * li
    nl = nx * lx + ny * ly + nz * lz
    nla = nl.abs() if double_sided else nl.clamp_min(0.0)
    dx, dy, dz = d
    di = torch.rsqrt((dx * dx + dy * dy + dz * dz).clamp_min(1e-30))
    vx, vy, vz = -dx * di, -dy * di, -dz * di
    rx = -lx + 2.0 * nl * nx
    ry = -ly + 2.0 * nl * ny
    rz = -lz + 2.0 * nl * nz
    rv = (rx * vx + ry * vy + rz * vz).clamp_min(0.0)
    pw = torch.where((rv > 0.0) | (shin == 0.0),
                     torch.exp(shin * torch.log(rv.clamp_min(1e-30))),
                     torch.zeros_like(rv))
    sw = (nla if specular_nl else 1.0) * pw
    return nla + amb, sw


def fused_phong(normal, obj, point, d, light, mat, double_sided: bool,
                specular_nl: bool):
    """The kernel's Phong rgb (attr modes 0 and 2): :func:`phong_factors`
    with the material of ``obj`` [...] i64 from ``mat``, then premultiplied
    colour * dw + specular * sw.  Returns (r, g, b)."""
    m = material_rows(mat, obj)                      # [..., 8]
    dw, sw = phong_factors(normal, point, d, light, m[..., 6], m[..., 7],
                           double_sided, specular_nl)
    return tuple(m[..., c] * dw + m[..., 3 + c] * sw for c in range(3))


def map_normal(nm, p):
    """Smooth normal of attr mode 2 from tri_nrm_map rows ``nm`` [..., 12]
    at hit points ``p`` (3-tuple): normalize(cn + An p), summed in the
    kernel's order."""
    px, py, pz = p
    n = [nm[..., c] + nm[..., 3 + 3 * c] * px + nm[..., 4 + 3 * c] * py
         + nm[..., 5 + 3 * c] * pz for c in range(3)]
    ni = torch.rsqrt((n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
                     .clamp_min(1e-30))
    return n[0] * ni, n[1] * ni, n[2] * ni


def map_texel(tm, p):
    """Texel coordinates of attr mode 1 from tri_tex_map rows ``tm``
    [..., 12] at hit points ``p``: (Au p + cu, Av p + cv)."""
    px, py, pz = p
    return tuple(tm[..., 4 * k] * px + tm[..., 4 * k + 1] * py
                 + tm[..., 4 * k + 2] * pz + tm[..., 4 * k + 3]
                 for k in range(2))


def _masked(x, m, fill, reduce):
    return reduce(torch.where(m, x, fill), dim=1)


def walk_plain(plan, tri, o, d, window_tris: int, eps: float,
               walk_mask=None, slices: int = 1, list_span: int = 0,
               seed=None, slice_rays: int = 0):
    """The nearest walk of every plain version (K1's modes and K4 here, K6
    in kernels/paged.py).  Rays: ``d`` a 3-tuple of [n, M] tensors, ``o`` a
    3-tuple of [n, M] tensors or of scalars (one origin for every ray).
    Walks every tile's plan in step: at step k each live tile tests the
    k-th window against all its rays (a few tiles at a time), keeps the
    least t with the lowest id on ties, and stops once every ray's best t
    is below the next entry's bound.  ``walk_mask`` [n, entries] bool: a
    list row tests its k-th window only where it is set (K4's sub-groups;
    the break is still tested).  Returns (t, idx), each [n, M]; misses
    t = inf, idx = -1.  Records the work a walk needs on these rays:
    ``walk_plain.lane_pairs`` [n, M] i64, each ray's tests of the windows
    whose entry bound its best t had not yet passed (all windows of a range
    row), and ``walk_plain.staged`` [windows] bool, the windows some ray
    needed.

    The kernels' work items: ``slice_rays`` > 0 walks each tile's rays as
    slices of that many consecutive lanes (``slices`` > 1: M / slices),
    each walking the tile's row and breaking on its own rays (the row
    repeated per slice); a last slice cut short by M walks with copies of
    its first ray, which the kernels' idle lanes walk and which hold back
    no break.  ``list_span`` > 0 walks each list of more entries as spans
    of ``list_span`` entries (:func:`span_plan`), each from its first entry
    with its own break, merged by the least (t, id) (:func:`merge_keys`).
    With sound entry bounds the result is the whole walk's.  The record
    stays the whole walk's needs: a window counts for a ray until its best
    t over all earlier entries (``seed`` [n, M], of the earlier spans)
    passes the entry's bound."""
    n, m = d[0].shape
    if slices > 1:
        slice_rays = m // slices
    if 0 < slice_rays < m:
        ns, src = slice_lanes(m, slice_rays, plan.device)

        def cut(x):
            return x if x.dim() == 0 else x[:, src].reshape(n * ns,
                                                            slice_rays)
        bt, idx = walk_plain(
            plan.repeat_interleave(ns, dim=0), tri, tuple(map(cut, o)),
            tuple(map(cut, d)), window_tris, eps,
            None if walk_mask is None
            else walk_mask.repeat_interleave(ns, dim=0),
            list_span=list_span)
        walk_plain.lane_pairs = walk_plain.lane_pairs.reshape(n, -1)[:, :m]
        return bt.reshape(n, -1)[:, :m], idx.reshape(n, -1)[:, :m]
    if list_span and bool(((plan[:, 3] == 1)
                           & (plan[:, 2] > list_span)).any()):
        return _walk_list_spans(plan, tri, o, d, window_tris, eps,
                                list_span, walk_mask)
    dev = plan.device
    wt = window_tris
    chunk = max(1, PLAIN_ELEMS // max(1, m * wt))
    bt = torch.full((n, m), INF, device=dev)
    bi = torch.full((n, m), -1, dtype=torch.int32, device=dev)
    use_list = plan[:, 3] == 1
    cnt = torch.where(use_list, plan[:, 2], plan[:, 1])
    mv = plan.shape[1] - pl.PLAN_AUX
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    jt = torch.arange(wt, dtype=torch.int32, device=dev)
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
            tid = w[:, None] * wt + jt[None, :]                 # [c, wt]
            g = tri[tid.long()]                                 # [c, wt, 9]
            gv = [g[:, None, :, i] for i in range(9)]           # [c, 1, wt]
            oc = tuple(x if x.dim() == 0 else x[ids][..., None] for x in o)
            num = mt_numerators(oc, tuple(x[ids][..., None] for x in d),
                                gv[0:3], gv[3:6], gv[6:9])
            t = mt_distance(*num, eps)                          # [c, M, wt]
            tk, arg = t.min(dim=-1)         # first (lowest-id) of equal t
            ik = torch.gather(tid[:, None, :].expand(-1, m, -1), 2,
                              arg[..., None])[..., 0]
            b_t, b_i = bt[ids], bi[ids]
            rec = b_t if seed is None else torch.minimum(b_t, seed[ids])
            need = ~use_list[ids, None] | (
                ((rec.view(torch.int32) >> 16) & 0xFFFF) >= (e >> 16)[:, None])
            lane_pairs[ids] += need * wt
            staged[w[need.any(dim=1)].long()] = True
            better = (tk < b_t) | ((tk == b_t) & (ik < b_i))
            bt[ids] = torch.where(better, tk, b_t)
            bi[ids] = torch.where(better, ik, b_i)
        # front-to-back break (logical shift: -0.0 must not pass as small)
        nb16 = plan[live, pl.PLAN_AUX + min(k + 1, mv - 1)] >> 16
        worst = ((bt[live].view(torch.int32) >> 16) & 0xFFFF).amax(dim=1)
        done[live] = use_list[live] & (k + 1 < cnt[live]) & (worst < nb16)
    walk_plain.lane_pairs, walk_plain.staged = lane_pairs, staged
    return bt, torch.where(torch.isfinite(bt), bi, -1)


def _walk_list_spans(plan, tri, o, d, window_tris: int, eps: float,
                     list_span: int, walk_mask=None):
    """:func:`walk_plain` with every list walked as spans of ``list_span``
    entries (:func:`span_plan`; range rows whole, in the first), span by
    span.  Sets the walk's record as :func:`walk_plain`."""
    keys = pairs = staged = best = None
    lists = plan[:, 3] == 1
    for s in range(-(-int(plan[lists, 2].max()) // list_span)):
        sub, mask = span_plan(plan, s, 0, list_span, walk_mask)
        key = hit_keys(*walk_plain(sub, tri, o, d, window_tris, eps,
                                   walk_mask=mask, seed=best))
        keys = key if keys is None else merge_keys(keys, key)
        best = decode_keys(keys)[0]
        rec = walk_plain.lane_pairs, walk_plain.staged
        pairs = rec[0] if pairs is None else pairs + rec[0]
        staged = rec[1] if staged is None else staged | rec[1]
    walk_plain.lane_pairs, walk_plain.staged = pairs, staged
    return decode_keys(keys)


def _walk_plain(plan, tri, cam, tile_px: int, window_tris: int, eps: float):
    """:func:`walk_plain` over the primary rays of K1's tiles, rebuilt from
    the plan's pixel origins and ``cam``, in K1's slices and list spans.
    Returns (t, idx, dx, dy, dz), each [n, tile]."""
    dx, dy, dz = tile_ray_dirs(cam, plan[:, 4], plan[:, 5], tile_px)
    bt, idx = walk_plain(plan, tri, (cam[9], cam[10], cam[11]),
                         (dx, dy, dz), window_tris, eps,
                         slices=k1_slices(tile_px * tile_px),
                         list_span=K1_LIST_SPAN)
    return bt, idx, dx, dy, dz


def fetch_rows(tri_attr, idx):
    """The fetch modes' rows: ``tri_attr`` [Tp, 4] at the winners ``idx``
    [n, M], (0, 0, 0, -1) on a miss, as [n * M, 4]."""
    miss = torch.tensor([0.0, 0.0, 0.0, -1.0], device=idx.device)
    attrs = torch.where((idx >= 0)[..., None],
                        tri_attr[idx.clamp_min(0).long()], miss)
    return attrs.reshape(-1, 4)


def tiled_nearest_attrs_plain(plan, tri, tri_attr, cam, tile_px: int,
                              window_tris: int, eps: float):
    """Plain PyTorch version of :func:`tiled_nearest_attrs` (same arguments
    and results)."""
    bt, idx, *_ = _walk_plain(plan, tri, cam, tile_px, window_tris, eps)
    return bt, idx, fetch_rows(tri_attr, idx)


def tiled_nearest_shaded_plain(plan, tri, tri_attr, mat, cam, tile_px: int,
                               window_tris: int, eps: float,
                               double_sided: bool = True,
                               specular_nl: bool = True, mode: int = FLAT,
                               attr_map=None):
    """Plain PyTorch version of :func:`tiled_nearest_shaded` (same
    arguments and results)."""
    n, tile = plan.shape[0], tile_px * tile_px
    width = shade_width(mode)
    bt, idx, dx, dy, dz = _walk_plain(plan, tri, cam, tile_px, window_tris,
                                      eps)
    o = (cam[9], cam[10], cam[11])
    hit = torch.isfinite(bt)
    win = idx.clamp_min(0).long()
    a = tri_attr[win]                                           # [n, tile, 4]
    obj = torch.where(hit, a[..., 3].to(torch.int32), -1)
    ts = torch.where(hit, bt, 0.0)
    p = (o[0] + ts * dx, o[1] + ts * dy, o[2] + ts * dz)
    L = (cam[12], cam[13], cam[14])
    normal = (a[..., 0], a[..., 1], a[..., 2])
    if mode == SMOOTH:
        normal = map_normal(attr_map[win], p)
    if mode == TEXTURED:
        tm = attr_map[win]
        m = material_rows(mat, obj.long())
        dw, sw = phong_factors(normal, p, (dx, dy, dz), L, m[..., 6],
                               m[..., 7], double_sided, specular_nl)
        texu, texv = map_texel(tm, p)
        cols = (dw, sw, texu, texv, obj.to(torch.float32), tm[..., 8])
        miss = torch.tensor([0.0, 0.0, 0.0, 0.0, -1.0, -1.0],
                            device=plan.device)
    else:
        cols = fused_phong(normal, obj.long(), p, (dx, dy, dz), L, mat,
                           double_sided, specular_nl)
        miss = torch.zeros(3, device=plan.device)
    rgb = torch.where(hit[..., None], torch.stack(cols, dim=-1), miss)

    # bounds row: hit-point box, any-hit, object range, and the shadow
    # direction light - p projected in the shared frame cam[15:24]
    u = tuple(L[c] - p[c] for c in range(3))
    fs, fv, fw = cam[15:18], cam[18:21], cam[21:24]

    def proj(f):
        return u[0] * f[0] + u[1] * f[1] + u[2] * f[2]
    dwl, dsl, dvl = proj(fw), proj(fs), proj(fv)
    dws = torch.where(dwl.abs() > 1e-12, dwl, 1e-12)
    ru, rv = dsl / dws, dvl / dws
    of = obj.to(torch.float32)
    mn = [_masked(x, hit, INF, torch.amin) for x in (*p, of, ru, rv, dwl)]
    mx = [_masked(x, hit, -INF, torch.amax) for x in (*p, of, ru, rv, dwl)]
    bounds = torch.stack(mn[:3] + mx[:3] + [hit.any(dim=1).to(torch.float32),
                                            mn[3], mx[3], mn[4], mx[4],
                                            mn[5], mx[5], mn[6], mx[6]],
                         dim=1)
    return bt, idx, obj, rgb.reshape(n * tile, width), bounds


def primary_plan(prep, cfg, cam_spec, maxv: int, rays=None, cam=None):
    """The primary plan of the frame (interval + projective tests from
    O(tiles) analytic bounds, :func:`plan.tile_bounds` of the camera row
    ``cam``, :func:`plan.camera`'s) with each tile's pixel origin in
    columns 4/5.  ``cam_spec`` = (view_matrix or None, focal, width,
    height, tile_px).  A range-only plan (:func:`plan.range_only`) is
    built from the frame's tile-major primary rays ``rays`` = (o, d)
    [R, 3] instead, as JAX builds it (tiled_t.cull drops the analytic
    bounds there), and reads no ``cam``."""
    _vmx, _focal, wd, hd, tpx = cam_spec
    tiles_x, tiles_y = -(-wd // tpx), -(-hd // tpx)
    wb = cfg.kernel.window_blocks
    with span("srt.plan.primary"):
        ab = None
        if not pl.range_only(maxv, prep.num_blocks // wb):
            if cam is None:
                raise ValueError("a list plan needs the camera row")
            ab = pl.tile_bounds(cam, cam_spec, tiles_x * tiles_y)
        return pl.cull(prep, maxv, wb, ab, apex=True,
                       rays=None if rays is None else (*rays, tpx * tpx),
                       origins=(tiles_x, tpx, wd, hd))


def attr_mode(prep, cfg):
    """K1's attribute mode for a fused frame: TEXTURED for a textured scene
    with flat normals, SMOOTH for an untextured scene with smooth normals,
    FLAT for neither, and None for both: no fused mode holds a texture and
    smooth normals, so such a frame gathers (JAX picks the same layout in
    prepare, accel/prepared.py:541-545)."""
    textured, smooth = prep.scene.has_textures, cfg.shading.smooth_normals
    if textured and smooth:
        return None
    return TEXTURED if textured else SMOOTH if smooth else FLAT


def hits_shaded(prep, cfg, light_pos, cam_spec, maxv: int, rays=None,
                cam=None):
    """Nearest hit + fused Phong over the frame's primary rays in tile-major
    order (JAX kernels/tiled_t.py::hits_shaded with want_bounds=1).

    Builds the primary plan (from ``rays``, the tile-major primary rays
    (o, d), where it is range-only) from the camera row with the shared
    shadow frame (``cam``, by default :func:`plan.camera`'s), and runs K1
    ("nearest_shaded") in the scene's :func:`attr_mode`.  Returns (t [R],
    idx [R], obj [R], rgb [R, 3] or, in the TEXTURED mode, comp [R, 6] =
    (dw, sw, texu, texv, obj, tex id), bounds [n, 15]), R = n *
    tile_px**2, misses t = inf."""
    args = shaded_args(prep, cfg, light_pos, cam_spec, maxv, rays, cam)
    with span("srt.k1"):
        t, idx, obj, rgb, bounds = table.run("nearest_shaded", *args)
    return t.reshape(-1), idx.reshape(-1), obj.reshape(-1), rgb, bounds


def shaded_args(prep, cfg, light_pos, cam_spec, maxv: int, rays=None,
                cam=None) -> tuple:
    """The arguments :func:`hits_shaded` gives K1
    (:func:`tiled_nearest_shaded`) on the frame: the primary plan, the
    scene's tables, the camera row with the shared shadow frame (``cam``,
    by default :func:`plan.camera` of ``light_pos``), and the scene's
    :func:`attr_mode`."""
    tpx = cam_spec[4]
    mode = attr_mode(prep, cfg)
    if mode is None:
        raise ValueError("no fused mode for a textured smooth-normal scene")
    amap = {FLAT: None, TEXTURED: prep.tri_tex_map,
            SMOOTH: prep.tri_nrm_map}[mode]
    if cam is None:
        cam = pl.camera(prep, cam_spec, light_pos)
    plan = primary_plan(prep, cfg, cam_spec, maxv, rays, cam)
    mat = material_table(prep.scene, cfg.light.color)
    return (plan, prep.tri, prep.tri_attr, mat, cam, tpx,
            cfg.kernel.window_blocks * prep.block_size, cfg.mt_eps,
            cfg.shading.double_sided_diffuse, cfg.shading.specular_nl_factor,
            mode, amap)


def _iota(cam_spec, apex: bool, maxv: int, tile: int) -> bool:
    """Whether the walk rebuilds its rays from the pixels (JAX
    tiled_t._use_iota): primary rays of ``cam_spec`` whose ray tiles are
    its pixel tiles, sharing one origin (``apex``), with list capacity."""
    return (cam_spec is not None and apex and maxv > 0
            and cam_spec[4] ** 2 == tile)


def _tiles_of(o, d, tile: int):
    """Rays o, d [R, 3] padded to whole tiles (the last ray repeated) as
    [n, tile, 3] each, and R."""
    op, dp, R = pl.pad_rays(o, d, tile)
    n = op.shape[0] // tile
    return (op.reshape(n, tile, 3).contiguous(),
            dp.reshape(n, tile, 3).contiguous(), R)


def hits_attrs(prep, cfg, cam_spec, maxv: int, rays=None, tile: int = 0):
    """Nearest hit + the winner's attribute row over the frame's primary
    rays (JAX kernels/tiled_t.py::hits_attrs with apex).  ``rays`` = (o, d)
    [R, 3] in tiles of ``tile`` (0: the pixel tile of ``cam_spec``).
    Where the walk can rebuild the rays of ``cam_spec`` from the pixels
    (ray tiles = pixel tiles, list capacity), K1's fetch mode walks the
    primary plan ("nearest_attrs"; ``rays`` only for a range-only plan);
    otherwise (sub-tiles, normalized directions: ``cam_spec`` None) its
    fetch mode over the explicit rays walks their plan
    ("nearest_rays_attrs").  Returns (t [R], idx [R], attrs [R, 4]) for
    :func:`render.integrator.records_from_attrs`; misses t = inf."""
    wt = cfg.kernel.window_blocks * prep.block_size
    tile = tile or cam_spec[4] ** 2
    if _iota(cam_spec, True, maxv, tile):
        cam = pl.camera(prep, cam_spec)
        plan = primary_plan(prep, cfg, cam_spec, maxv, rays, cam)
        with span("srt.k1"):
            t, idx, attrs = table.run("nearest_attrs", plan, prep.tri,
                                      prep.tri_attr, cam, cam_spec[4], wt,
                                      cfg.mt_eps)
        R = t.numel() if rays is None else rays[0].shape[0]
    else:
        o, d = rays
        with span("srt.plan.primary"):
            plan = pl.cull_rays(prep, o, d, tile, maxv,
                                cfg.kernel.window_blocks)
        with span("srt.k1"):
            o3, d3, R = _tiles_of(o, d, tile)
            t, idx, attrs = table.run("nearest_rays_attrs", plan, prep.tri,
                                      prep.tri_attr, o3, d3, wt, cfg.mt_eps)
    return t.reshape(-1)[:R], idx.reshape(-1)[:R], attrs[:R]


def hits(prep, cfg, o, d, tile: int, maxv: int, apex: bool = True,
         cam_spec=None):
    """Nearest hit of the frame's rays o, d [R, 3] in tiles of ``tile``
    (JAX kernels/tiled_t.py::hits), by the roles of kernels/table.py:

    * ``KernelConfig.prepass`` with list capacity (``maxv`` > 0), whatever
      ``groups`` says, as in JAX: the ungrouped plan of the explicit
      rays, then K3 flags the windows that may hold some ray's nearest
      hit, :func:`prepass.refine_plan` keeps only those, and K1 walks the
      refined plan over the rays ("prepass", then "nearest_rays"): the
      same (t, idx) as the walk of the whole plan;
    * otherwise, ``KernelConfig.groups`` > 1 with list capacity: the
      grouped plan of the explicit rays, then K4 ("nearest_grouped");
    * otherwise, for primary rays of a ``cam_spec`` whose tiles are the
      pixel tiles (``apex``, list capacity): the primary plan, then K1's
      fetch mode over rays rebuilt from the pixels ("nearest_attrs"),
      whose attribute rows are dropped; other rays (sub-tiles, normalized
      directions, ``maxv`` <= 0) take K1 over the explicit rays' plan
      ("nearest_rays"), range-only where ``maxv`` <= 0.

    Windows are ``window_blocks`` blocks.  Returns (t [R], idx [R]);
    misses t = inf, idx = -1."""
    kc = cfg.kernel
    wb = kc.window_blocks
    wt = wb * prep.block_size
    prepass = kc.prepass and maxv > 0
    groups = 1 if prepass or maxv <= 0 else kc.nearest_groups
    R = o.shape[0]
    if groups == 1 and not prepass and _iota(cam_spec, apex, maxv, tile):
        cam = pl.camera(prep, cam_spec)
        plan = primary_plan(prep, cfg, cam_spec, maxv, (o, d), cam)
        with span("srt.k1"):
            t, idx, _ = table.run("nearest_attrs", plan, prep.tri,
                                  prep.tri_attr, cam, cam_spec[4], wt,
                                  cfg.mt_eps)
        return t.reshape(-1)[:R], idx.reshape(-1)[:R]
    with span("srt.plan.primary"):
        plan = pl.cull_rays(prep, o, d, tile, maxv, wb, groups=groups,
                            apex=apex)
    with span("srt.k1"):
        o3, d3, _ = _tiles_of(o, d, tile)
        if groups > 1:
            t, idx = table.run("nearest_grouped", plan, prep.tri, o3, d3, wt,
                               cfg.mt_eps, groups)
        else:
            if prepass:
                flags = table.run("prepass", plan, prep.gram, o3, d3, wt,
                                  cfg.mt_eps)
                plan = refine_plan(plan, flags)
            t, idx = table.run("nearest_rays", plan, prep.tri, o3, d3, wt,
                               cfg.mt_eps)
    return t.reshape(-1)[:R], idx.reshape(-1)[:R]
