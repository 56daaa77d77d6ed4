"""The stackless flattened-BVH walk in plain PyTorch: the ``bvh`` mode.

Counterpart of the JAX package's ``accel/traverse.py``, which runs one
``lax.while_loop`` per ray under ``vmap``.  Here the same walk runs batched
over rays [r]: each ray carries its state (node i, best t, best index; or
node i, found), and each step of the loop advances every ray still walking
by one node.  A step tests the ray against node i's box (the slab test), and
where node i is a leaf it runs Möller–Trumbore over the leaf's window of
``max_leaf`` consecutive triangles (rows first .. first + max_leaf - 1, in
bounds by ``prepare``'s tail slack), masked to the leaf's count; then
next = (box hit and not a leaf) ? i + 1 : skip[i].  A ray that leaves the
node array (or, walking for a shadow, finds an occluder) stops and keeps its
state, as a finished lane of the JAX loop does; the rays still walking are
kept as an index list, so a step costs only what they need.  Each step
reads back whether any ray still walks (one host sync a step).
The counters ``traverse.nearest_hit.steps`` / ``traverse.any_hit_other.steps``
(utils/metrics.py) hold the most steps one call took since they were
reset; ``render_radiance`` resets them (``reset_counts("traverse.")``) at
the start of each BVH frame, so after it they are the frame's lockstep
steps over all of its ray chunks.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..ops import intersect as isect
from ..render import integrator
from ..utils.metrics import count
from .prepared import PreparedScene


def _step(prep: PreparedScene, vc, o, d, node, eps: float):
    """One node of the walk for rays (o, d) [n, 3] at ``node`` [n]: (box
    hit [n], leaf [n], the leaf window's first row [n], its lanes' t
    [n, max_leaf] with lanes past the leaf's count and rays not at a hit
    leaf at +inf, the window's rows [n, max_leaf])."""
    hit = isect.slab_test(o, d, prep.node_min[node], prep.node_max[node])
    count = prep.leaf_count[node]
    first = prep.leaf_first[node].clamp_min(0)
    is_leaf = count > 0
    lane = torch.arange(prep.max_leaf, device=o.device)
    rows = first.long()[:, None] + lane
    ts = isect.moller_trumbore(o[:, None, :], d[:, None, :], vc[rows], eps)
    keep = (lane < count[:, None]) & (hit & is_leaf)[:, None]
    ts = torch.where(keep, ts, torch.full_like(ts, float("inf")))
    return hit, is_leaf, first, ts, rows


def _next(prep: PreparedScene, node, hit, is_leaf):
    return torch.where(hit & ~is_leaf, node + 1, prep.skip[node])


def nearest_hit(prep: PreparedScene, o: torch.Tensor, d: torch.Tensor,
                eps: float = 1e-12):
    """Nearest hit of rays (o, d) [r, 3] by the walk -> (t [r], tri_idx [r]
    i32), +inf and -1 on a miss; the index is into ``prep.scene`` (BVH
    order).  Within a leaf ties go to the lowest lane; across leaves a hit
    replaces the best only when strictly nearer."""
    vc = prep.scene.verts_cart()
    r, dev = o.shape[0], o.device
    node = torch.zeros(r, dtype=torch.int32, device=dev)
    best_t = torch.full((r,), float("inf"), dtype=o.dtype, device=dev)
    best_idx = torch.full((r,), -1, dtype=torch.int32, device=dev)
    live = torch.arange(r if prep.num_nodes else 0, device=dev)
    steps = 0
    while live.numel():
        i = node[live]
        hit, is_leaf, first, ts, _ = _step(prep, vc, o[live], d[live], i, eps)
        k = torch.argmin(ts, dim=-1)
        t = ts.gather(1, k[:, None])[:, 0]
        bt, bi = best_t[live], best_idx[live]
        better = t < bt
        best_t[live] = torch.where(better, t, bt)
        best_idx[live] = torch.where(better, (first + k).to(torch.int32), bi)
        nxt = _next(prep, i, hit, is_leaf)
        node[live] = nxt
        live = live[nxt < prep.num_nodes]
        steps += 1
    count("traverse.nearest_hit.steps", steps, peak=True)
    return best_t, best_idx


def any_hit_other(prep: PreparedScene, o: torch.Tensor, d: torch.Tensor,
                  self_obj: torch.Tensor, eps: float = 1e-12,
                  no_max_t: bool = True) -> torch.Tensor:
    """Shadow predicate of rays (o, d) [r, 3] by the walk: any hit (t >= 0;
    no max-t, the reference's quirk, simple_raytracer.cpp:321-342) on a
    triangle of an object other than ``self_obj`` [r].  A ray stops once it
    finds one.  ``no_max_t=False`` ignores occluders beyond the light
    (t > 1 on the unnormalized segment).  Returns found [r] bool."""
    vc = prep.scene.verts_cart()
    tri_obj = prep.scene.tri_obj
    r, dev = o.shape[0], o.device
    node = torch.zeros(r, dtype=torch.int32, device=dev)
    found = torch.zeros(r, dtype=torch.bool, device=dev)
    live = torch.arange(r if prep.num_nodes else 0, device=dev)
    steps = 0
    while live.numel():
        i = node[live]
        hit, is_leaf, _, ts, rows = _step(prep, vc, o[live], d[live], i, eps)
        occ = torch.isfinite(ts) & (tri_obj[rows] != self_obj[live][:, None])
        if not no_max_t:
            occ = occ & (ts <= 1.0)
        f = occ.any(dim=-1)
        found[live] = f
        nxt = _next(prep, i, hit, is_leaf)
        node[live] = nxt
        live = live[(nxt < prep.num_nodes) & ~f]
        steps += 1
    count("traverse.any_hit_other.steps", steps, peak=True)
    return found


def bvh_hits(prep: PreparedScene, origin, direction, eps: float = 1e-12):
    """Nearest hits of flat rays [R, 3] -> (t [R], idx [R])."""
    return nearest_hit(prep, origin, direction, eps)


def bvh_shadow_fn(prep: PreparedScene, eps: float = 1e-12,
                  no_max_t: bool = True):
    """The integrator's shadow query (point, light, self_obj, hit) ->
    shadowed [R] by the any-hit walk toward the light."""
    def shadow(point, light, self_obj, hit=None):
        return any_hit_other(prep, point, light - point, self_obj, eps,
                             no_max_t)
    return shadow


def render_flat_bvh(prep: PreparedScene, cfg: RenderConfig, origin,
                    direction, light_pos):
    """BVH-mode renderer over flat rays -> (radiance [R, 3], hit [R])."""
    t, tri_idx = bvh_hits(prep, origin, direction, cfg.mt_eps)
    shadow_fn = (bvh_shadow_fn(prep, cfg.mt_eps, cfg.light.shadow_no_max_t)
                 if cfg.light.enable_shadows else None)
    radiance = integrator.shade(prep.scene, cfg, origin, direction, t,
                                tri_idx, light_pos, shadow_fn)
    return radiance, torch.isfinite(t)
