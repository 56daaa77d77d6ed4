"""Möller–Trumbore and the slab AABB tests in plain PyTorch: the arithmetic
the kernels' plain versions share (kernels/nearest.py, kernels/anyhit.py),
and the ops of the bruteforce and BVH modes (render/renderer.py,
accel/traverse.py).

Conventions (from the reference, simple_raytracer.cpp:42-75):

* a missed triangle gives ``+inf`` (min-reductions then pick the nearest hit);
* ``t == 0`` counts as a hit (the reference rejects only ``t < 0``, :73);
* determinant epsilon 1e-12 (:57);
* vertices are w-divided before the test (:45-47; done once at prepare time).

Cross and dot products are written out component by component, one
elementwise operation at a time and in a fixed order.  The CUDA kernels
evaluate the same expressions in the same order with floating-point
contraction off (``--fmad=false``, kernels/build.py), so on the card a kernel
and its plain version round alike.

The Gram form (:func:`pack_mt_gram`, :func:`ray_features`) computes the same
four scalars as one 10-term contraction per (ray, triangle); the bf16
classification walk K3 (kernels/prepass.py) bounds its rounding error.
"""

from __future__ import annotations

import torch

INF = float("inf")


def cross(a, b):
    """a x b for 3-tuples of broadcastable tensors."""
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def xyz(x: torch.Tensor):
    """[..., 3] -> (x[..., 0], x[..., 1], x[..., 2])."""
    return x[..., 0], x[..., 1], x[..., 2]


def mt_numerators(origin, direction, v0, e1, e2):
    """The four Möller–Trumbore scalars (det, u·det, v·det, t·det) for
    rays (origin, direction) and triangles (v0, e1 = v1 - v0, e2 = v2 - v0),
    each argument a 3-tuple of broadcastable tensors."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    tvec = (origin[0] - v0[0], origin[1] - v0[1], origin[2] - v0[2])
    u_num = dot(tvec, pvec)
    qvec = cross(tvec, e1)
    v_num = dot(direction, qvec)
    t_num = dot(e2, qvec)
    return det, u_num, v_num, t_num


def mt_distance(det, u_num, v_num, t_num, eps: float = 1e-12):
    """Hit distance t (``+inf`` on a miss) from the MT scalars."""
    inv = 1.0 / det
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    valid = ((det.abs() >= eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= 0.0))
    return torch.where(valid, t, torch.full_like(t, INF))


def mt_occludes(det, u_num, v_num, t_num, eps: float = 1e-12,
                no_max_t: bool = True):
    """Division-free hit predicate on the MT scalars (the any-hit walk needs
    no t value): u >= 0 <=> u_num*det >= 0, u <= 1 <=> |u_num| <= |det| given
    the sign test, and likewise for u + v and t.  ``no_max_t=False`` also
    requires t <= 1 (stop at the light)."""
    adet = det.abs()
    occ = ((adet >= eps) & (u_num * det >= 0.0) & (u_num.abs() <= adet)
           & (v_num * det >= 0.0) & ((u_num + v_num).abs() <= adet)
           & (t_num * det >= 0.0))
    if not no_max_t:
        occ = occ & (t_num.abs() <= adet)
    return occ


def pack_mt_gram(verts_cart: torch.Tensor) -> torch.Tensor:
    """Per-triangle Möller–Trumbore factors G [T, 10, 4] of the Gram form
    (JAX ops/intersect.py::pack_mt_gram): with ray features
    f = (d, o×d, o, 1) (:func:`ray_features`), the four MT scalars of a
    (ray, triangle) pair are one contraction,
    (det, u_num, v_num, t_num) = f @ G, where n = e2 × e1:

        det = d · n,  u_num = (o×d) · e2 − d · (e2 × p1),
        v_num = −(o×d) · e1 − d · (p1 × e1),  t_num = −o · n − e2 · (p1 × e1).

    Rows (d, o×d, o, 1); columns (det, u, v, t).  verts_cart [T, 3, 3]."""
    p1 = xyz(verts_cart[..., 0, :])
    e1 = tuple(v - p for v, p in zip(xyz(verts_cart[..., 1, :]), p1))
    e2 = tuple(v - p for v, p in zip(xyz(verts_cart[..., 2, :]), p1))
    n = cross(e2, e1)
    e2xp1 = cross(e2, p1)
    p1xe1 = cross(p1, e1)
    c_t = -dot(e2, p1xe1)
    T = verts_cart.shape[0]
    G = torch.zeros((T, 10, 4), dtype=verts_cart.dtype,
                    device=verts_cart.device)
    for k in range(3):
        G[:, k, 0] = n[k]
        G[:, k, 1] = -e2xp1[k]
        G[:, 3 + k, 1] = e2[k]
        G[:, k, 2] = -p1xe1[k]
        G[:, 3 + k, 2] = -e1[k]
        G[:, 6 + k, 3] = -n[k]
    G[:, 9, 3] = c_t
    return G


def ray_features(origin: torch.Tensor, direction: torch.Tensor):
    """Ray features [..., 10] = (d, o×d, o, 1) of the Gram form (JAX
    ops/intersect.py::ray_features)."""
    one = torch.ones(origin.shape[:-1] + (1,), dtype=direction.dtype,
                     device=direction.device)
    oxd = torch.stack(cross(xyz(origin), xyz(direction)), dim=-1)
    return torch.cat([direction, oxd, origin, one], dim=-1)


def moller_trumbore(origin: torch.Tensor, direction: torch.Tensor,
                    verts_cart: torch.Tensor, eps: float = 1e-12):
    """Ray/triangle distance (simple_raytracer.cpp:42-75) with misses at
    +inf; origin/direction [..., 3], verts_cart [..., 3, 3] (w-divided),
    broadcasting over leading dims."""
    p1 = verts_cart[..., 0, :]
    e1 = verts_cart[..., 1, :] - p1
    e2 = verts_cart[..., 2, :] - p1
    return mt_distance(*mt_numerators(xyz(origin), xyz(direction), xyz(p1),
                                      xyz(e1), xyz(e2)), eps)


def slab_test_origin(direction: torch.Tensor, box_min: torch.Tensor,
                     box_max: torch.Tensor) -> torch.Tensor:
    """Slab AABB test of rays from the view-space origin
    (simple_raytracer.cpp:204-248); bool, broadcasting over leading dims.
    A zero direction component divides to +-inf, and 0/0 (a box plane
    through the origin) to NaN; minimum, maximum, amax and amin carry the
    NaN through, as jnp's do, so such a test reads False."""
    t0 = box_min / direction
    t1 = box_max / direction
    lo = torch.minimum(t0, t1).amax(dim=-1)
    hi = torch.maximum(t0, t1).amin(dim=-1)
    return lo <= hi


def slab_test(origin: torch.Tensor, direction: torch.Tensor,
              box_min: torch.Tensor, box_max: torch.Tensor) -> torch.Tensor:
    """General-origin slab test (simple_raytracer.cpp:252-293), for shadow
    rays and the BVH walk.  Like the reference there is no t-range
    clipping: a box wholly behind the origin is a hit."""
    t0 = (box_min - origin) / direction
    t1 = (box_max - origin) / direction
    lo = torch.minimum(t0, t1).amax(dim=-1)
    hi = torch.maximum(t0, t1).amin(dim=-1)
    return lo <= hi


def nearest_hit(origin: torch.Tensor, direction: torch.Tensor,
                verts_cart: torch.Tensor, eps: float = 1e-12):
    """Brute-force nearest hit of one ray ([3] each) against every triangle
    of verts_cart [T, 3, 3] -> (t, tri_idx), +inf and -1 on a miss; ties
    go to the lowest triangle index."""
    ts = moller_trumbore(origin[None, :], direction[None, :], verts_cart, eps)
    idx = torch.argmin(ts)
    t = ts[idx]
    return t, torch.where(torch.isinf(t), -1, idx.to(torch.int32))
