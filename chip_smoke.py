#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA raytracer on one NVIDIA GPU.

    python3 chip_smoke.py [--root ASSETS]

Drives the port's paths through ``render_radiance(mode="tiled")`` followed
by ``finalize_image``, on three frames:

* **bench**: a mesh of bunny scale on a ground slab at 1920x1080, one hard
  shadow, flat Phong, a SAH BVH (the fused branch: K1 with fused Phong, K2
  from t).  The mesh is a displaced icosphere of 81,920 triangles
  (scene/procedural.py); with ``--root`` naming the reference's asset
  directory (the JAX CLI's ``--root``) it is the Stanford bunny of
  ``bench.py`` instead, from ASSETS/obj/stanford-bunny.obj on
  ASSETS/cube.obj;
* **soft**: ``bench.py::run_soft_shadow``'s frame: the same mesh and light
  at 600x400, focal 400, 16 light samples (K1 in its fetch mode, then K2′
  over the folded shadow rays);
* **dense**: ``procedural.dense_on_ground`` (163,852 triangles) at 600x400,
  focal 400, one hard shadow (32-pixel tiles; K1 with fused Phong, then the
  legacy hard shadow through K2′ in 256-ray tiles).

Phases, each of which must pass:

1. device and toolchain: the card's name and power limit, torch, CUDA, nvcc;
2. build the kernels from simple_raytracer_tpu_torch/csrc/, one nvcc per
   source, all at once;
3. bench: hold K1 and K2 against their plain PyTorch versions on the
   arguments the frame gives them on the card, at the frame's shapes and on
   a small scene whose shadow falls in view;
4. bench: render through the public entry points, with the kernels' launch
   counters reset just before: coverage in (0.05, 0.99), both counters > 0,
   and the image within 1 of the plain versions' image on >= 99.9% of
   pixels;
5. bench: time 20 view-varied frames (as bench.py does), each kernel alone,
   and each stage of the frame alone;
6. soft and dense, each: the frame's K1 and K2′ against their plain
   versions on the frame's arguments (K2′ found equal on >= 99.99% of hit
   lanes, > 1,000 shadowed hit lanes); the frame through the public entry
   points with the counters reset just before (every kernel of its branch
   launched); the image within 1 of the plain versions' image on >= 99.9%
   of pixels; 32 view-varied frames timed (bench.py:174-183), each kernel
   and its plain version, and each stage.

Prints one JSON line per phase result, then the kernels line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result line, when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
FRAMES = 20
# the soft and dense frames (bench.py:138-189): 600x400, focal 400
OCC_WIDTH, OCC_HEIGHT, OCC_FOCAL = 600, 400, 400.0
OCC_FRAMES = 32
SOFT_SAMPLES = 16
SHADOWED_MIN = 1000
# kernel vs plain version on the card (ISSUE tolerances: equal expressions,
# contraction off, so only the transcendental functions round apart)
T_RTOL, T_ATOL = 1e-5, 1e-6
RGB_ATOL = 1e-4
IDX_MIN = 0.9999
FOUND_MIN = 0.9999
IMAGE_MIN = 0.999


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_scene(sr, root):
    """The bench's scene (bench.py:299-313) from the asset directory
    ``root``, or, without one, its procedural stand-in."""
    from simple_raytracer_tpu_torch.scene import procedural as P
    from simple_raytracer_tpu_torch.scene import transforms as T
    if root is None:
        return (P.sphere_on_ground(sr.SceneManager(), 6).build(),
                "procedural icosphere(6) + box ground")
    bunny = os.path.join(root, "obj", "stanford-bunny.obj")
    require(os.path.isfile(bunny), f"no {bunny}")
    sm = sr.SceneManager(root=root)
    sm.load_obj_file(bunny, key="bunny")
    sm.set_color("bunny", (0.8, 0.7, 0.6))
    sm.transform_triangles("bunny", T.translate((0.0, -5.5, 60.0))
                           @ T.rotate_y(3.14159265)
                           @ T.scale(50.0, 50.0, 50.0))
    sm.load_obj_file(os.path.join(root, "cube.obj"), key="ground")
    sm.set_color("ground", (0.0, 1.0, 0.0))
    sm.transform_triangles("ground", P.GROUND_POSE)
    return sm.build(), f"reference OBJ {bunny}"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def capture(fn, store: list):
    """``fn`` that also records the arguments of each call in ``store``."""
    def wrapped(*args):
        store.append(args)
        return fn(*args)
    return wrapped


def plan_stats(plan) -> dict:
    """Windows each tile walks at most (its list or its range)."""
    import torch
    cnt = torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1]).float()
    return {"windows_per_tile_mean": float(cnt.mean()),
            "windows_per_tile_max": int(cnt.max()),
            "list_mode_tiles": float((plan[:, 3] == 1).float().mean())}


def frame_args(prep, cfg, light, cam_spec, rays=None) -> dict:
    """The arguments the frame gives each kernel on its first call, by role
    (kernels/tiled.py::KERNELS)."""
    from simple_raytracer_tpu_torch.kernels.tiled import (KERNELS,
                                                          render_flat_tiled)
    stores = {role: [] for role in KERNELS}
    render_flat_tiled(prep, cfg, light, cam_spec, rays=rays,
                      kernels={role: capture(fn, stores[role])
                               for role, fn in KERNELS.items()})
    return {role: st[0] for role, st in stores.items() if st}


def check_k1_shaded(k1, label: str) -> dict:
    """K1 (fused mode) vs its plain version on the arguments ``k1``."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest
    kt, ki, ko, krgb, kb = nearest.tiled_nearest_shaded(*k1)
    pt, pi, po, prgb, pb = nearest.tiled_nearest_shaded_plain(*k1)
    torch.cuda.synchronize()
    hk, hp = torch.isfinite(kt), torch.isfinite(pt)
    both = hk & hp
    t_err = (kt[both] - pt[both]).abs()
    t_ok = bool((t_err <= T_ATOL + T_RTOL * pt[both].abs()).all())
    same = ki == pi
    idx_frac = float(same.float().mean())
    rgb_err = float((krgb[same.reshape(-1)] - prgb[same.reshape(-1)])
                    .abs().max()) if bool(same.any()) else 0.0
    obj_ok = bool((ko[same] == po[same]).all())
    fin = torch.isfinite(pb) & torch.isfinite(kb)
    b_ok = bool((torch.isfinite(pb) == torch.isfinite(kb)).all()
                and torch.allclose(kb[fin], pb[fin], rtol=1e-5, atol=1e-4))
    res = {"check": f"K1 vs plain ({label})", "tiles": int(kt.shape[0]),
           "hit_rays": int(hk.sum()),
           "hit_mask_equal": float((hk == hp).float().mean()),
           "t_max_abs_err": float(t_err.max()) if t_err.numel() else 0.0,
           "t_within_tol": t_ok, "idx_equal": idx_frac,
           "rgb_max_abs_err": rgb_err, "obj_equal": obj_ok,
           "bounds_allclose": b_ok, "plan": plan_stats(k1[0])}
    emit(**res)
    require(t_ok and bool((hk == hp).all()), f"K1 t differs ({label})")
    require(idx_frac >= IDX_MIN, f"K1 idx equal on {idx_frac} ({label})")
    require(rgb_err <= RGB_ATOL and obj_ok, f"K1 shading differs ({label})")
    require(b_ok, f"K1 bounds rows differ ({label})")
    return res


def compare_kernels(prep, cfg, light, cam_spec, label: str, time_it: bool):
    """K1 and K2 vs their plain versions on the card, on the arguments the
    fused frame gives them."""
    import torch
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    args = frame_args(prep, cfg, light, cam_spec)
    k1, k2 = args["nearest_shaded"], args["anyhit_from_t"]
    k1_res = check_k1_shaded(k1, label)

    kf = anyhit.tiled_anyhit_from_t(*k2)
    pf = anyhit.tiled_anyhit_from_t_plain(*k2)
    torch.cuda.synchronize()
    hit = torch.isfinite(k2[3])
    f_frac = float((kf[hit] == pf[hit]).float().mean()) if bool(hit.any()) \
        else 1.0
    k2_res = {"check": f"K2 vs plain ({label})", "hit_rays": int(hit.sum()),
              "shadowed_rays": int((kf & hit).sum()),
              "found_equal": f_frac, "plan": plan_stats(k2[0]),
              "found_max_abs_err": float((kf[hit].int() - pf[hit].int())
                                         .abs().max()) if bool(hit.any())
              else 0.0}
    emit(**k2_res)
    require(f_frac >= FOUND_MIN, f"K2 found equal on {f_frac} ({label})")
    times = {}
    if time_it:
        times = {"k1_ms": cuda_ms(lambda: nearest.tiled_nearest_shaded(*k1),
                                  20),
                 "k1_plain_ms": cuda_ms(
                     lambda: nearest.tiled_nearest_shaded_plain(*k1), 2),
                 "k2_ms": cuda_ms(lambda: anyhit.tiled_anyhit_from_t(*k2),
                                  20),
                 "k2_plain_ms": cuda_ms(
                     lambda: anyhit.tiled_anyhit_from_t_plain(*k2), 2)}
        emit(check=f"kernel times ({label})", **times)
    return k1_res, k2_res, times


def reset_launches() -> None:
    from simple_raytracer_tpu_torch.kernels.tiled import KERNELS
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    from simple_raytracer_tpu_torch.kernels.tiled import KERNELS
    return {role: fn.launches for role, fn in KERNELS.items()}


def image_vs_plain(sr, prep, cfg, light, img, label: str) -> dict:
    """The frame through the plain versions, on the card, against ``img``
    (within 1 on >= IMAGE_MIN of pixels)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels.tiled import (PLAIN,
                                                          frame_branch,
                                                          render_flat_tiled)
    from simple_raytracer_tpu_torch.ops.camera import (primary_rays_tiled,
                                                       untile_image)
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    cam = cfg.camera
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    rays = None
    if frame_branch(prep, cfg, tpx * tpx) != "fused":
        o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx,
                                        cam.focal, device=prep.device)
        rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    prad, phit = render_flat_tiled(
        prep, cfg, light, (None, cam.focal, cam.width, cam.height, tpx),
        rays=rays, kernels=PLAIN)
    tx, ty = -(-cam.width // tpx), -(-cam.height // tpx)
    pimg = finalize_image(
        untile_image(prad, cam.width, cam.height, tpx, tx, ty),
        untile_image(phit, cam.width, cam.height, tpx, tx, ty), cfg)
    diff = (img.int() - pimg.int()).abs().amax(dim=-1)
    within1 = float((diff <= 1).float().mean())
    require(within1 >= IMAGE_MIN, f"image vs plain ({label}): {within1} "
                                  f"within 1")
    return {"image_within_1_of_plain": within1,
            "image_equal_to_plain": float((diff == 0).float().mean())}


def occlusion_frame(sr, prep, cfg, light, label: str, gpu: str) -> dict:
    """The soft or dense frame: its K1 and K2′ against their plain versions,
    the frame through the public entry points with the counts read around
    it, the plain image, and the times.  Returns the kernels-line entries."""
    import torch
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels import tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    dev = prep.device
    cam = cfg.camera
    S = cfg.light.num_samples
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    tile = tpx * tpx
    branch = tiled.frame_branch(prep, cfg, tile)
    k1_role = "nearest_attrs" if branch == "soft" else "nearest_shaded"
    require(branch == ("soft" if S > 1 else "legacy"),
            f"{label} takes the {branch} branch")
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx, cam.focal,
                                    device=dev)
    rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    args = frame_args(prep, cfg, light, cam_spec, rays)
    k1, k2r = args[k1_role], args["anyhit"]

    # K1 vs plain
    if k1_role == "nearest_shaded":
        k1_res = check_k1_shaded(k1, label)
        kt = nearest.tiled_nearest_shaded(*k1)[0]
        k1_err = k1_res["t_max_abs_err"]
    else:
        kt, ki, ka = nearest.tiled_nearest_attrs(*k1)
        pt, pi, pa = nearest.tiled_nearest_attrs_plain(*k1)
        torch.cuda.synchronize()
        hk, hp = torch.isfinite(kt), torch.isfinite(pt)
        both = hk & hp
        t_err = (kt[both] - pt[both]).abs()
        t_ok = bool((t_err <= T_ATOL + T_RTOL * pt[both].abs()).all())
        same = (ki == pi).reshape(-1)
        idx_frac = float(same.float().mean())
        n_err = float((ka[same, :3] - pa[same, :3]).abs().max())
        obj_ok = bool((ka[same, 3] == pa[same, 3]).all())
        k1_err = float(t_err.max()) if t_err.numel() else 0.0
        emit(check=f"K1 fetch mode vs plain ({label})",
             tiles=int(kt.shape[0]), hit_rays=int(hk.sum()),
             hit_mask_equal=float((hk == hp).float().mean()),
             t_max_abs_err=k1_err, t_within_tol=t_ok, idx_equal=idx_frac,
             normal_max_abs_err=n_err, obj_equal=obj_ok,
             plan=plan_stats(k1[0]))
        require(t_ok and bool((hk == hp).all()), f"K1 t differs ({label})")
        require(idx_frac >= IDX_MIN, f"K1 idx equal on {idx_frac} ({label})")
        require(n_err <= 1e-6 and obj_ok, f"K1 attrs differ ({label})")

    # K2′ vs plain, on the lanes whose point is a hit
    kf = anyhit.tiled_anyhit(*k2r)
    pf = anyhit.tiled_anyhit_plain(*k2r)
    torch.cuda.synchronize()
    n2, m = kf.shape
    hit = torch.isfinite(kt).reshape(-1)
    ts = m // S
    hit = torch.cat([hit, hit.new_zeros(n2 * ts - hit.shape[0])])
    lanes = hit.reshape(n2, 1, ts).expand(n2, S, ts).reshape(n2, m)
    f_frac = float((kf[lanes] == pf[lanes]).float().mean())
    shadowed = int((kf & lanes).sum())
    k2_err = float((kf[lanes].int() - pf[lanes].int()).abs().max())
    emit(check=f"K2' vs plain ({label})", tiles=n2, rays_per_tile=m,
         hit_lanes=int(lanes.sum()), shadowed_hit_lanes=shadowed,
         found_equal=f_frac, found_max_abs_err=k2_err,
         plan=plan_stats(k2r[0]))
    require(f_frac >= FOUND_MIN, f"K2' found equal on {f_frac} ({label})")
    require(shadowed > SHADOWED_MIN, f"K2' shadowed {shadowed} ({label})")

    # the path through the public entry points, counts read around it
    reset_launches()
    rad, hitimg = sr.render_radiance(prep, cfg, light)
    img = finalize_image(rad, hitimg, cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    want = (k1_role, "anyhit")
    require(all(launches[r] > 0 for r in want),
            f"{label} skipped a kernel: {launches}")
    bg = (img == torch.tensor(cfg.background, dtype=torch.uint8,
                              device=dev)).all(dim=-1)
    coverage = float((~bg).float().mean())
    require(0.05 < coverage < 0.99, f"implausible coverage {coverage}")
    require(tuple(img.shape) == (cam.height, cam.width, 3)
            and bool(torch.isfinite(rad).all()), f"bad radiance ({label})")
    cmp = image_vs_plain(sr, prep, cfg, light, img, label)
    emit(phase=f"render ({label})", branch=branch, coverage=coverage,
         launches=launches, **cmp)

    # 32 view-varied frames (bench.py:174-183)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(OCC_FRAMES):
        V = eye.clone()
        V[0, 3] += i * 1e-5
        r, h = sr.render_radiance(prep, cfg, light + i * 1e-4, view_matrix=V)
        acc += finalize_image(r, h, cfg).to(torch.int64).sum()
    torch.cuda.synchronize()
    ms_frame = (time.time() - t0) * 1e3 / OCC_FRAMES
    require(int(acc) > 0, f"timed frames rendered nothing ({label})")

    # each kernel and its plain version, and each stage alone
    k1_fn = getattr(nearest, "tiled_" + k1_role)
    k1_plain = getattr(nearest, "tiled_" + k1_role + "_plain")
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    stage1 = (nearest.hits_attrs if branch == "soft" else
              lambda *a: nearest.hits_shaded(a[0], a[1], light, *a[2:]))
    o2, d2, self2 = k2r[3], k2r[4], k2r[5]
    excl = tiled._pure_excl(self2)
    times = {
        "k1_ms": cuda_ms(lambda: k1_fn(*k1), 20),
        "k1_plain_ms": cuda_ms(lambda: k1_plain(*k1), 2),
        "k2r_ms": cuda_ms(lambda: anyhit.tiled_anyhit(*k2r), 20),
        "k2r_plain_ms": cuda_ms(lambda: anyhit.tiled_anyhit_plain(*k2r), 2),
        "plan_and_k1_ms": cuda_ms(lambda: stage1(prep, cfg, cam_spec, maxv),
                                  10),
        "shadow_plan_ms": cuda_ms(lambda: pl.cull_occl(
            prep, o2.reshape(-1, 3), d2.reshape(-1, 3), m, maxv,
            cfg.kernel.window_blocks_ah, excl, apex_rev=S == 1), 10),
        "frame_ms": cuda_ms(lambda: finalize_image(
            *sr.render_radiance(prep, cfg, light), cfg), 10)}
    emit(phase=f"timing ({label})", width=cam.width, height=cam.height,
         samples=S, frames=OCC_FRAMES, ms_per_frame=ms_frame,
         rays_per_s=cam.width * cam.height * 1e3 / ms_frame, gpu=gpu,
         **times)
    src = "simple_raytracer_tpu_torch/csrc/"
    k1_entry = {
        "name": "nearest_shaded_kernel" + (" (fetch mode)"
                                           if branch == "soft" else ""),
        "route": "cuda", "source": src + "nearest.cu",
        "replaces": "simple_raytracer_tpu/kernels/tiled_t.py:855",
        "frame": label, "launches": launches[k1_role],
        "max_abs_err": k1_err, "ms": times["k1_ms"],
        "plain_ms": times["k1_plain_ms"]}
    k2_entry = {
        "name": "anyhit_rays_kernel", "route": "cuda",
        "source": src + "anyhit.cu",
        "replaces": "simple_raytracer_tpu/kernels/tiled_t.py:1374",
        "via": "tiled_anyhit_t (tiled_t.py:1815)",
        "frame": label, "launches": launches["anyhit"],
        "max_abs_err": k2_err, "ms": times["k2r_ms"],
        "plain_ms": times["k2r_plain_ms"]}
    return [k1_entry, k2_entry]


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="the reference's asset directory (renders the "
                         "Stanford bunny instead of the procedural mesh)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "simple_raytracer_tpu_torch")):
        print("chip_smoke: simple_raytracer_tpu_torch/ is not beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.kernels import anyhit, build, nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    from simple_raytracer_tpu_torch.scene import procedural as P
    require("jax" not in sys.modules, "the port imported jax")

    # 1. device and toolchain
    gpu = gpu_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit(phase="device", gpu=gpu, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         device=torch.cuda.get_device_name(0))
    dev = torch.device("cuda", 0)

    # 2. build
    b = build.build()
    ptxas = [ln.strip() for ln in b["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit(phase="build", seconds=round(b["seconds"], 3), cached=b["cached"],
         libraries=[os.path.relpath(p, HERE) for p in b["paths"]],
         ptxas=ptxas)
    build.library()

    # scene: the bench frame
    t0 = time.time()
    scene, source = bench_scene(sr, args.root)
    focal = P.bench_focal(HEIGHT)
    cfg = sr.default_config().replace(
        mode="tiled",
        camera=sr.CameraConfig(width=WIDTH, height=HEIGHT, focal=focal),
        light=sr.LightConfig(enable_shadows=True),
        bvh=sr.BVHConfig(split="sah"))
    prep = prepare(scene, cfg).to(dev)
    torch.cuda.synchronize()
    emit(phase="scene", source=source, triangles=prep.num_triangles,
         padded_triangles=prep.scene.num_triangles, blocks=prep.num_blocks,
         seconds=round(time.time() - t0, 3))
    light = torch.tensor(P.BENCH_LIGHT, dtype=torch.float32, device=dev)
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    cam_spec = (None, focal, WIDTH, HEIGHT, tpx)

    # 3. kernels vs plain versions
    k1_res, k2_res, times = compare_kernels(prep, cfg, light, cam_spec,
                                            f"{source}, {WIDTH}x{HEIGHT}",
                                            time_it=True)
    small = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=128, height=128,
                                             focal=400.0),
        bvh=sr.BVHConfig(split="sah"))
    small_prep = prepare(P.sphere_on_ground(sr.SceneManager(), 3).build(),
                         small).to(dev)
    _s1, s2, _ = compare_kernels(
        small_prep, small, light,
        (None, 400.0, 128, 128,
         pl.effective_tile_px(small, small_prep.scene.num_triangles)),
        "icosphere(3) + box ground, 128x128", time_it=False)
    require(s2["shadowed_rays"] > 50, "no shadow in the small scene")

    # 4. the main path through the public entry points
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    reset_launches()
    rad, hit = sr.render_radiance(prep, cfg, light)
    img = finalize_image(rad, hit, cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    require(launches["nearest_shaded"] > 0 and launches["anyhit_from_t"] > 0,
            f"main path skipped a kernel: {launches}")
    bg = (img == torch.tensor(cfg.background, dtype=torch.uint8,
                              device=dev)).all(dim=-1)
    coverage = float((~bg).float().mean())
    require(0.05 < coverage < 0.99, f"implausible coverage {coverage}")
    require(tuple(img.shape) == (HEIGHT, WIDTH, 3)
            and bool(torch.isfinite(rad).all()), "bad radiance")

    # 5. timed view-varied frames (bench.py:353-358)
    torch.cuda.synchronize()
    t0 = time.time()
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(FRAMES):
        lp = light + i * 1e-4
        V = eye.clone()
        V[0, 3] += i * 1e-5
        r, h = sr.render_radiance(prep, cfg, lp, view_matrix=V)
        acc += finalize_image(r, h, cfg).to(torch.int64).sum()
    torch.cuda.synchronize()
    ms_frame = (time.time() - t0) * 1e3 / FRAMES
    require(int(acc) > 0, "timed frames rendered nothing")

    # the same frame through the plain versions, on the card
    cmp = image_vs_plain(sr, prep, cfg, light, img, "bench")
    emit(phase="render", coverage=coverage, launches=launches, **cmp)

    # where a frame's time goes: each stage alone (device time, CUDA events)
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    t, _i, obj, _rgb, bounds = nearest.hits_shaded(prep, cfg, light,
                                                   cam_spec, maxv)
    stages = {
        "plan_and_k1_ms": cuda_ms(lambda: nearest.hits_shaded(
            prep, cfg, light, cam_spec, maxv), 10),
        "shadow_plan_and_k2_ms": cuda_ms(lambda: anyhit.anyhit_from_t(
            prep, cfg, t, obj, bounds, light, cam_spec, maxv), 10),
        "frame_ms": cuda_ms(lambda: finalize_image(
            *sr.render_radiance(prep, cfg, light), cfg), 10)}
    emit(phase="timing", scene=source, width=WIDTH, height=HEIGHT,
         frames=FRAMES, ms_per_frame=ms_frame,
         rays_per_s=WIDTH * HEIGHT * 1e3 / ms_frame, gpu=gpu, **times,
         **stages)

    # 6. the soft-shadow and the dense frames
    occ_cam = sr.CameraConfig(width=OCC_WIDTH, height=OCC_HEIGHT,
                              focal=OCC_FOCAL)
    soft = cfg.replace(camera=occ_cam,
                       light=sr.LightConfig(num_samples=SOFT_SAMPLES))
    entries = occlusion_frame(
        sr, prep, soft, light,
        f"soft: {source}, {OCC_WIDTH}x{OCC_HEIGHT}, S={SOFT_SAMPLES}", gpu)
    t0 = time.time()
    dense = cfg.replace(camera=occ_cam)
    dense_prep = prepare(P.dense_on_ground(sr.SceneManager()).build(),
                         dense).to(dev)
    torch.cuda.synchronize()
    emit(phase="scene (dense)", source="procedural dense_on_ground",
         triangles=dense_prep.num_triangles, blocks=dense_prep.num_blocks,
         seconds=round(time.time() - t0, 3))
    entries += occlusion_frame(
        sr, dense_prep, dense, light,
        f"dense: procedural, {dense_prep.num_triangles} triangles, "
        f"{OCC_WIDTH}x{OCC_HEIGHT}", gpu)

    src = "simple_raytracer_tpu_torch/csrc/"
    bench = f"bench: {source}, {WIDTH}x{HEIGHT}"
    print(json.dumps({"kernels": [
        {"name": "nearest_shaded_kernel", "route": "cuda",
         "source": src + "nearest.cu",
         "replaces": "simple_raytracer_tpu/kernels/tiled_t.py:855",
         "frame": bench, "launches": launches["nearest_shaded"],
         "max_abs_err": k1_res["t_max_abs_err"],
         "ms": times["k1_ms"], "plain_ms": times["k1_plain_ms"]},
        {"name": "anyhit_from_t_kernel", "route": "cuda",
         "source": src + "anyhit.cu",
         "replaces": "simple_raytracer_tpu/kernels/tiled_t.py:1374",
         "frame": bench, "launches": launches["anyhit_from_t"],
         "max_abs_err": k2_res["found_max_abs_err"],
         "ms": times["k2_ms"], "plain_ms": times["k2_plain_ms"]},
    ] + entries}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
