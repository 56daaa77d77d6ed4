"""Kernel 1: the nearest-hit walk, with fused Phong and shadow bounds or
with the winner's attribute row.

``tiled_nearest_shaded`` wraps the CUDA kernel ``nearest_shaded_kernel``
(csrc/nearest.cu) in its fused mode, and ``tiled_nearest_attrs`` the same
kernel in its fetch mode; together they replace the JAX package's Pallas
kernel ``kernels/tiled_t.py::_nearest_kernel_t`` (fused on the fused
frame's path, fetch on the soft-shadow path).  ``tiled_nearest_shaded_plain``
and ``tiled_nearest_attrs_plain`` are their plain PyTorch versions: same
arguments, same results.  Each wrapper runs its plain version for tensors on
the CPU and the kernel for tensors on a CUDA device; it adds one to its own
``launches`` at each kernel launch.

``hits_shaded`` and ``hits_attrs`` are the counterparts of the JAX
``tiled_t.hits_shaded`` and ``tiled_t.hits_attrs``: they build the primary
plan and the per-frame constants and run the kernel.  :func:`walk_plain`,
the plain walk, also serves kernel 6 (kernels/paged.py), as the device walk
``nearest_walk`` does.
"""

from __future__ import annotations

import math

import torch

from ..ops.camera import tile_ray_dirs
from ..ops.intersect import mt_distance, mt_numerators
from . import build, plan as pl

BOUNDS_W = 15
INF = float("inf")
PLAIN_ELEMS = 1 << 24   # ray-triangle pairs per step of the plain walk


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


def _check(plan, tri, tri_attr, cam, tile_px, threads, mat=None):
    f32 = torch.float32
    ops = dict(plan=(plan, torch.int32), tri=(tri, f32),
               tri_attr=(tri_attr, f32), cam=(cam, f32))
    if mat is not None:
        ops["mat"] = (mat, f32)
    build.check_operands(plan.device, tile_px, threads, **ops)
    if plan.dim() != 2 or plan.shape[1] <= pl.PLAN_AUX:
        raise ValueError(f"plan shape {tuple(plan.shape)}")
    if tri.dim() != 2 or tri.shape[1] != 9 \
            or tri_attr.shape != (tri.shape[0], 4):
        raise ValueError(f"tri {tuple(tri.shape)} / tri_attr "
                         f"{tuple(tri_attr.shape)}")
    if tri_attr.data_ptr() % 16:         # the kernel loads rows as float4
        raise ValueError("tri_attr is not 16-byte aligned")
    if cam.shape != (24,) or (mat is not None
                              and (mat.dim() != 2 or mat.shape[1] != 8)):
        raise ValueError(f"cam {tuple(cam.shape)} / mat "
                         f"{None if mat is None else tuple(mat.shape)}")


def tiled_nearest_shaded(plan, tri, tri_attr, mat, cam, tile_px: int,
                         window_tris: int, eps: float,
                         double_sided: bool = True,
                         specular_nl: bool = True, threads: int = 512):
    """Nearest hit + Phong + bounds of every tile of ``plan``.

    plan [n, W] i32 (kernels/plan.py layout, pixel origins in columns 4/5);
    tri [Tp, 9] and tri_attr [Tp, 4] (accel/prepared.py); mat [O, 8]
    (:func:`material_table`); cam [24] (plan.make_cam, with the shadow
    frame); a window is ``window_tris`` consecutive triangles.
    Returns t [n, tile] f32 (inf on a miss), idx [n, tile] i32 (-1),
    obj [n, tile] i32 (-1), rgb [n * tile, 3] f32 unshadowed pre-tonemap
    radiance (0 on a miss) and bounds [n, 15] f32 (see
    plan.analytic_shadow_bounds_exact)."""
    if plan.device.type == "cpu":
        return tiled_nearest_shaded_plain(plan, tri, tri_attr, mat, cam,
                                          tile_px, window_tris, eps,
                                          double_sided, specular_nl, threads)
    if plan.device.type != "cuda":
        raise ValueError(f"no nearest kernel for device {plan.device}")
    threads = min(threads, tile_px * tile_px)
    _check(plan, tri, tri_attr, cam, tile_px, threads, mat)
    n, tile = plan.shape[0], tile_px * tile_px
    kw = dict(device=plan.device)
    t = torch.empty((n, tile), dtype=torch.float32, **kw)
    idx = torch.empty((n, tile), dtype=torch.int32, **kw)
    obj = torch.empty((n, tile), dtype=torch.int32, **kw)
    rgb = torch.empty((n * tile, 3), dtype=torch.float32, **kw)
    bounds = torch.empty((n, BOUNDS_W), dtype=torch.float32, **kw)
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.library().srt_nearest_shaded(
            plan.data_ptr(), plan.shape[1], n, tri.data_ptr(),
            tri_attr.data_ptr(), tri.shape[0] // window_tris, mat.data_ptr(),
            mat.shape[0], cam.data_ptr(), tile_px, window_tris, eps,
            int(double_sided), int(specular_nl), t.data_ptr(),
            idx.data_ptr(), obj.data_ptr(), rgb.data_ptr(),
            bounds.data_ptr(), threads, stream)
    build.check(rc, "nearest_shaded_kernel")
    tiled_nearest_shaded.launches += 1
    return t, idx, obj, rgb, bounds


tiled_nearest_shaded.launches = 0


def tiled_nearest_attrs(plan, tri, tri_attr, cam, tile_px: int,
                        window_tris: int, eps: float, threads: int = 512):
    """Nearest hit + the winner's attribute row over every tile of ``plan``
    (the fetch mode of ``nearest_shaded_kernel``).  Arguments as
    :func:`tiled_nearest_shaded` (``cam``'s light and frame are not read).
    Returns t [n, tile] f32 (inf on a miss), idx [n, tile] i32 (-1) and
    attrs [n * tile, 4] f32: the winner's ``tri_attr`` row (flat normal xyz,
    object id), (0, 0, 0, -1) on a miss."""
    if plan.device.type == "cpu":
        return tiled_nearest_attrs_plain(plan, tri, tri_attr, cam, tile_px,
                                         window_tris, eps, threads)
    if plan.device.type != "cuda":
        raise ValueError(f"no nearest kernel for device {plan.device}")
    threads = min(threads, tile_px * tile_px)
    _check(plan, tri, tri_attr, cam, tile_px, threads)
    n, tile = plan.shape[0], tile_px * tile_px
    kw = dict(device=plan.device)
    t = torch.empty((n, tile), dtype=torch.float32, **kw)
    idx = torch.empty((n, tile), dtype=torch.int32, **kw)
    attrs = torch.empty((n * tile, 4), dtype=torch.float32, **kw)
    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.library().srt_nearest_attrs(
            plan.data_ptr(), plan.shape[1], n, tri.data_ptr(),
            tri_attr.data_ptr(), tri.shape[0] // window_tris, cam.data_ptr(),
            tile_px, window_tris, eps, t.data_ptr(), idx.data_ptr(),
            attrs.data_ptr(), threads, stream)
    build.check(rc, "nearest_shaded_kernel (fetch mode)")
    tiled_nearest_attrs.launches += 1
    return t, idx, attrs


tiled_nearest_attrs.launches = 0


def fused_phong(normal, obj, point, d, light, mat, double_sided: bool,
                specular_nl: bool):
    """The kernel's Phong term (JAX kernels/tiled_t.py::_fused_phong, attr
    mode 0) on 3-tuples of [...] tensors: normal, hit point, ray direction
    and light; obj [...] i64 indexes ``mat``.  Returns (r, g, b)."""
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
    m = mat[obj]                                     # [..., 8]
    amb, shin = m[..., 6], m[..., 7]
    pw = torch.where((rv > 0.0) | (shin == 0.0),
                     torch.exp(shin * torch.log(rv.clamp_min(1e-30))),
                     torch.zeros_like(rv))
    sw = (nla if specular_nl else 1.0) * pw
    dw = nla + amb
    return tuple(m[..., c] * dw + m[..., 3 + c] * sw for c in range(3))


def _masked(x, m, fill, reduce):
    return reduce(torch.where(m, x, fill), dim=1)


def walk_plain(plan, tri, o, d, window_tris: int, eps: float):
    """The nearest walk of every plain version (K1's modes here, K6 in
    kernels/paged.py).  Rays: ``d`` a 3-tuple of [n, M] tensors, ``o`` a
    3-tuple of [n, M] tensors or of scalars (one origin for every ray).
    Walks every tile's plan in step: at step k each live tile tests the
    k-th window against all its rays (a few tiles at a time), keeps the
    least t with the lowest id on ties, and stops once every ray's best t
    is below the next entry's bound.  Returns (t, idx), each [n, M]; misses
    t = inf, idx = -1.  Records the work a walk needs on these rays:
    ``walk_plain.lane_pairs`` [n, M] i64, each ray's tests of the windows
    whose entry bound its best t had not yet passed (all windows of a range
    row), and ``walk_plain.staged`` [windows] bool, the windows the walk
    read."""
    n, m = d[0].shape
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
        for ids in live.split(chunk):
            e = plan[ids, pl.PLAN_AUX + min(k, mv - 1)]
            w = torch.where(use_list[ids], e & 0xFFFF, plan[ids, 0] + k)
            staged[w.long()] = True
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
            need = ~use_list[ids, None] | (
                ((b_t.view(torch.int32) >> 16) & 0xFFFF) >= (e >> 16)[:, None])
            lane_pairs[ids] += need * wt
            better = (tk < b_t) | ((tk == b_t) & (ik < b_i))
            bt[ids] = torch.where(better, tk, b_t)
            bi[ids] = torch.where(better, ik, b_i)
        # front-to-back break (logical shift: -0.0 must not pass as small)
        nb16 = plan[live, pl.PLAN_AUX + min(k + 1, mv - 1)] >> 16
        worst = ((bt[live].view(torch.int32) >> 16) & 0xFFFF).amax(dim=1)
        done[live] = use_list[live] & (k + 1 < cnt[live]) & (worst < nb16)
    walk_plain.lane_pairs, walk_plain.staged = lane_pairs, staged
    return bt, torch.where(torch.isfinite(bt), bi, -1)


def _walk_plain(plan, tri, cam, tile_px: int, window_tris: int, eps: float):
    """:func:`walk_plain` over the primary rays of K1's tiles, rebuilt from
    the plan's pixel origins and ``cam``.  Returns (t, idx, dx, dy, dz),
    each [n, tile]."""
    dx, dy, dz = tile_ray_dirs(cam, plan[:, 4], plan[:, 5], tile_px)
    bt, idx = walk_plain(plan, tri, (cam[9], cam[10], cam[11]),
                         (dx, dy, dz), window_tris, eps)
    return bt, idx, dx, dy, dz


def tiled_nearest_attrs_plain(plan, tri, tri_attr, cam, tile_px: int,
                              window_tris: int, eps: float,
                              threads: int = 512):
    """Plain PyTorch version of :func:`tiled_nearest_attrs` (same arguments
    and results; ``threads`` is ignored)."""
    bt, idx, *_ = _walk_plain(plan, tri, cam, tile_px, window_tris, eps)
    miss = torch.tensor([0.0, 0.0, 0.0, -1.0], device=plan.device)
    attrs = torch.where((idx >= 0)[..., None],
                        tri_attr[idx.clamp_min(0).long()], miss)
    return bt, idx, attrs.reshape(-1, 4)


def tiled_nearest_shaded_plain(plan, tri, tri_attr, mat, cam, tile_px: int,
                               window_tris: int, eps: float,
                               double_sided: bool = True,
                               specular_nl: bool = True, threads: int = 512):
    """Plain PyTorch version of :func:`tiled_nearest_shaded` (same
    arguments and results; ``threads`` is ignored)."""
    n, tile = plan.shape[0], tile_px * tile_px
    bt, idx, dx, dy, dz = _walk_plain(plan, tri, cam, tile_px, window_tris,
                                      eps)
    o = (cam[9], cam[10], cam[11])
    hit = torch.isfinite(bt)
    a = tri_attr[idx.clamp_min(0).long()]                       # [n, tile, 4]
    obj = torch.where(hit, a[..., 3].to(torch.int32), -1)
    ts = torch.where(hit, bt, 0.0)
    p = (o[0] + ts * dx, o[1] + ts * dy, o[2] + ts * dz)
    L = (cam[12], cam[13], cam[14])
    rgb = fused_phong((a[..., 0], a[..., 1], a[..., 2]),
                      obj.clamp_min(0).long(), p, (dx, dy, dz), L, mat,
                      double_sided, specular_nl)
    rgb = torch.where(hit[..., None], torch.stack(rgb, dim=-1), 0.0)

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
    return bt, idx, obj, rgb.reshape(n * tile, 3), bounds


def primary_plan(prep, cfg, cam_spec, maxv: int):
    """The primary plan of the frame (interval + projective tests from
    O(tiles) analytic bounds) with each tile's pixel origin in columns 4/5.
    ``cam_spec`` = (view_matrix or None, focal, width, height, tile_px)."""
    vmx, focal, wd, hd, tpx = cam_spec
    dev = prep.device
    tiles_x, tiles_y = -(-wd // tpx), -(-hd // tpx)
    n = tiles_x * tiles_y
    plan = pl.cull(prep, maxv, cfg.kernel.window_blocks,
                   pl.analytic_tile_bounds(cam_spec, n, dev), apex=True)
    plan[:, 4], plan[:, 5] = pl.tile_origins(n, tiles_x, tpx, wd, hd, dev)
    return plan


def hits_shaded(prep, cfg, light_pos, cam_spec, maxv: int,
                kernel=tiled_nearest_shaded):
    """Nearest hit + fused Phong over the frame's primary rays in tile-major
    order (JAX kernels/tiled_t.py::hits_shaded with want_bounds=1).

    Builds the primary plan, the camera constants with the shared shadow
    frame, and runs ``kernel`` (the CUDA wrapper by default).  Returns
    (t [R], idx [R], obj [R], rgb [R, 3], bounds [n, 15]),
    R = n * tile_px**2, misses t = inf."""
    vmx, focal, _wd, _hd, tpx = cam_spec
    dev = prep.device
    plan = primary_plan(prep, cfg, cam_spec, maxv)
    frame = pl.shadow_frame(prep.block_min, prep.block_max, light_pos)
    cam = pl.make_cam(vmx, focal, light_pos, frame, dev)
    mat = material_table(prep.scene, cfg.light.color)
    t, idx, obj, rgb, bounds = kernel(
        plan, prep.tri, prep.tri_attr, mat, cam, tpx,
        cfg.kernel.window_blocks * prep.block_size, cfg.mt_eps,
        cfg.shading.double_sided_diffuse, cfg.shading.specular_nl_factor,
        cfg.kernel.threads)
    return t.reshape(-1), idx.reshape(-1), obj.reshape(-1), rgb, bounds


def hits_attrs(prep, cfg, cam_spec, maxv: int, kernel=tiled_nearest_attrs):
    """Nearest hit + the winner's attribute row over the frame's primary
    rays in tile-major order (JAX kernels/tiled_t.py::hits_attrs with the
    iota rays of ``cam_spec``).  Returns (t [R], idx [R], attrs [R, 4]) for
    :func:`render.integrator.records_from_attrs`; misses t = inf."""
    vmx, focal, _wd, _hd, tpx = cam_spec
    plan = primary_plan(prep, cfg, cam_spec, maxv)
    cam = pl.make_cam(vmx, focal, (0.0, 0.0, 0.0), None, prep.device)
    t, idx, attrs = kernel(plan, prep.tri, prep.tri_attr, cam, tpx,
                           cfg.kernel.window_blocks * prep.block_size,
                           cfg.mt_eps, cfg.kernel.threads)
    return t.reshape(-1), idx.reshape(-1), attrs
