"""Kernels 6 and 7: the paged walks, and the steps of the paged frame.

``tiled_nearest`` wraps the walk over explicit rays of csrc/nearest.cu
(``nearest_rays``, the walk of K1's rays mode) and replaces the JAX
package's Pallas kernel ``kernels/tiled.py::_nearest_kernel`` (K6, reached
through ``tiled_nearest``): the nearest hit (t, id) of explicit rays over
a plan of pages of ``page_tris`` triangles.  ``tiled_anyhit`` launches
``anyhit_rays`` (csrc/anyhit.cu, the walk of K2′) at page windows
and replaces ``kernels/tiled.py::_anyhit_kernel`` (K7, reached through
``tiled_anyhit``): occlusion of explicit rays, skipping each ray's own
object.  The JAX kernels take their MT numerators from one Gram
contraction per page and the object ids from Gram row 10; these read the
plain ``tri`` table and ``block_obj`` (accel/prepared.py).
``tiled_nearest_plain`` and ``tiled_anyhit_plain`` are their plain PyTorch
versions: same arguments, same results, the kernels' expressions in the
same order.  Each wrapper takes CUDA tensors, launches its kernel and
counts the launch (``paged.<wrapper>.launches``); kernels/table.py chooses
between a wrapper and its plain version and counts the calls.

``hits``, ``cull``, ``cull_occl`` and ``anyhit`` are the counterparts of
the JAX ``kernels/tiled.py`` functions of the same names (lines
1216-1258); they take (prep, cfg, ...) like kernels/anyhit.py::anyhit.
Page plans are ``plan_width(num_pages)`` wide and are not widened to fit
``maxv`` (plan.cull with ``widen=False``); with ``maxv`` <= 0, or more than
65,536 pages, they are pure page ranges (JAX ``_cull``, lines 1194-1210).
"""

from __future__ import annotations

import torch

from ..utils.metrics import count, span
from . import anyhit as _anyhit
from . import nearest as _nearest, plan as pl, table


def page_blocks(prep) -> int:
    """Cull blocks per page: a page plan's window width in blocks."""
    return prep.page_tris // prep.block_size


def tiled_nearest(plan, tri, o, d, window_tris: int, eps: float):
    """Nearest hit of explicit rays over every tile of ``plan``.

    plan [n, W] i32 (kernels/plan.py layout, windows of ``window_tris``
    triangles: pages); tri [Tp, 9] (accel/prepared.py); o, d [n, M, 3] f32
    the rays of each tile (any M).  Returns t [n, M] f32 (inf on a miss)
    and idx [n, M] i32 (-1 on a miss); equal t goes to the lowest triangle
    id."""
    outs = _nearest.launch_nearest_rays(plan, tri, o, d, window_tris, eps,
                                        what="nearest_rays (pages)")
    count("paged.tiled_nearest.launches")
    return outs


def tiled_nearest_plain(plan, tri, o, d, window_tris: int, eps: float):
    """Plain PyTorch version of :func:`tiled_nearest` (same arguments and
    results): kernels/nearest.py::walk_plain in the
    kernel's slices and list spans."""
    return _nearest.tiled_nearest_rays_plain(plan, tri, o, d, window_tris,
                                             eps)


def tiled_anyhit(plan, tri, block_obj, o, d, self_obj, window_tris: int,
                 block_size: int, eps: float, no_max_t: bool = True):
    """Occlusion of explicit rays over every tile of a page plan (K7):
    arguments and result as kernels/anyhit.py::tiled_anyhit, with
    ``window_tris`` the page size.  Runs the same device walk as K2′,
    counted apart."""
    found = _anyhit.launch_anyhit_rays(
        plan, tri, block_obj, o, d, self_obj, window_tris, block_size, eps,
        no_max_t, what="anyhit_rays (page windows)")
    count("paged.tiled_anyhit.launches")
    return found

# K7's plain version is K2′'s: one walk over any window width
tiled_anyhit_plain = _anyhit.tiled_anyhit_plain


def cull(prep, cfg, o, d, tile: int, maxv: int, excl=None,
         apex: bool = False) -> torch.Tensor:
    """Page plan of rays o, d [R, 3] in tiles of ``tile`` (JAX
    kernels/tiled.py::cull → _cull): the interval test from the rays'
    per-tile bounds, refined by the projective test when every ray leaves
    one origin (``apex``: primary rays).  ``excl`` [n] drops each tile's
    own object.  ``maxv`` <= 0, or more than 65,536 pages: pure page
    ranges (plan.cull_ranges)."""
    ab = pl.ray_tile_bounds(o, d, tile, apex="primary" if apex else None)
    return pl.cull(prep, maxv, page_blocks(prep), ab, excl=excl, apex=apex,
                   widen=False, rays=(o, d, tile))


def cull_occl(prep, cfg, o, d, tile: int, maxv: int, excl=None,
              apex_rev: bool = False, hourglass=None) -> torch.Tensor:
    """Occlusion page plan (JAX kernels/tiled.py::cull_occl): the hourglass
    test on dense scenes unless ``apex_rev`` (``hourglass`` None: by
    plan.hourglass_for), and the light-apex test when every ray ends at one
    light (``apex_rev``, hard shadows); pure page ranges as :func:`cull`."""
    return pl.cull_occl(prep, o, d, tile, maxv, page_blocks(prep), excl,
                        apex_rev=apex_rev, hourglass=hourglass, widen=False)


def anyhit(prep, cfg, o, d, self_obj2d, plan, tile: int):
    """Occlusion of explicit rays o, d [R, 3] over a page plan (JAX
    kernels/tiled.py::anyhit): kernels/anyhit.py::anyhit with page
    windows (K7, "anyhit_pages").  Returns found [n, tile] bool."""
    return _anyhit.anyhit(prep, cfg, o, d, self_obj2d, plan, tile,
                          window_tris=prep.page_tris, role="anyhit_pages")


def hits(prep, cfg, o, d, tile: int, maxv: int, apex: bool = False):
    """Nearest hit of rays o, d [R, 3] in tiles of ``tile`` (JAX
    kernels/tiled.py::hits → tiled_hits): the page plan (``apex`` for rays
    that share one origin), then K6 ("nearest_pages") over the rays padded
    to whole tiles by repeating the last one.  Returns
    (t [R], idx [R]); misses t = inf, idx = -1."""
    with span("srt.plan.primary"):
        plan = cull(prep, cfg, o, d, tile, maxv, apex=apex)
    with span("srt.k1"):
        o, d, R = pl.pad_rays(o, d, tile)
        n = o.shape[0] // tile
        t, idx = table.run("nearest_pages", plan, prep.tri,
                           o.reshape(n, tile, 3).contiguous(),
                           d.reshape(n, tile, 3).contiguous(),
                           prep.page_tris, cfg.mt_eps)
    return t.reshape(-1)[:R], idx.reshape(-1)[:R]
