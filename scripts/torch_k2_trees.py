#!/usr/bin/env python3
"""K2, the fused frame's hard-shadow walk of the PyTorch/CUDA port, alone on
chip_smoke.py's four fused frames, for one checkout of the port.

    python3 scripts/torch_k2_trees.py [--tree CHECKOUT] [--root ASSETS]

Builds CHECKOUT's kernels (default: the checkout holding this script) and
prints one JSON line for each of the bench, textured bench, smooth bench
and shadow bench at 1920x1080: K2's found against its plain version (equal
on every lane), the shadowed rays, the plan, ``k2_ms`` (the wrapper's call
timed with CUDA events, as chip_smoke.py's kernels line times it), the
card's and the host's time of that call apart (``chip_smoke.queued_ms``),
and on the shadow bench the shadow stage (shadow plan + K2) and the ms per
view-varied frame.  Run it on two checkouts in one call, for instance a
parent commit unpacked with ``git archive`` beside this one, in the order
parent, change, change, parent, to time two versions of K2 on one card.

It takes chip_smoke.py's helpers from this checkout and reads CHECKOUT's
port only through ``tiled_anyhit_from_t``, its plain version, ``prepare``,
the planners and ``hits_shaded``, which every version of the port has.
Exits non-zero without a CUDA device.  Torch only: no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="the checkout whose simple_raytracer_tpu_torch/ "
                         "to time (default: this one)")
    ap.add_argument("--root", default=None,
                    help="the reference's asset directory (the Stanford "
                         "bunny instead of the procedural mesh)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_k2_trees: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    if not os.path.isdir(os.path.join(tree, "simple_raytracer_tpu_torch")):
        print(f"torch_k2_trees: no simple_raytracer_tpu_torch/ in {tree}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.kernels import anyhit, build, nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.scene import procedural as P
    cs.require(sr.__file__.startswith(tree), f"imported {sr.__file__}")
    gpu = cs.gpu_line()
    b = build.build()
    build.library()
    cs.emit(phase="build", tree=tree, seconds=round(b["seconds"], 3),
            gpu=gpu)
    dev = torch.device("cuda", 0)
    W, H = cs.WIDTH, cs.HEIGHT
    base = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(
            width=W, height=H, focal=P.bench_focal(H)),
        light=sr.LightConfig(enable_shadows=True),
        bvh=sr.BVHConfig(split="sah"))
    light = torch.tensor(P.BENCH_LIGHT, dtype=torch.float32, device=dev)
    scene, source = cs.bench_scene(sr, args.root)
    prep = prepare(scene, base, device=dev)
    shadow = base.replace(camera=sr.CameraConfig(width=W, height=H,
                                                 focal=cs.SHADOW_FOCAL))
    smooth = base.replace(shading=sr.ShadingConfig(smooth_normals=True))
    frames = [
        (f"bench: {source}", prep, base),
        ("textured bench", prepare(P.textured_on_ground(
            sr.SceneManager(), 6).build(), base, device=dev), base),
        ("smooth bench", prepare(P.smooth_on_ground(
            sr.SceneManager(), 6).build(), smooth, device=dev), smooth),
        (f"shadow bench: {source}, focal {cs.SHADOW_FOCAL:g}", prep,
         shadow)]
    for label, fprep, cfg in frames:
        tpx = pl.effective_tile_px(cfg, fprep.scene.num_triangles)
        cam_spec = (None, cfg.camera.focal, W, H, tpx)
        k2 = cs.frame_args(fprep, cfg, light, cam_spec)["anyhit_from_t"]
        kf = anyhit.tiled_anyhit_from_t(*k2)
        pf = anyhit.tiled_anyhit_from_t_plain(*k2)
        torch.cuda.synchronize()
        hit = torch.isfinite(k2[3])

        def call():
            return anyhit.tiled_anyhit_from_t(*k2)
        dev_ms, host_ms = cs.queued_ms(call, 20)
        res = {"check": f"K2 alone ({label})",
               "found_equal_every_lane": bool(torch.equal(kf, pf)),
               "shadowed_rays": int((kf & hit).sum()),
               "plan": cs.plan_stats(k2[0]),
               "k2_ms": cs.cuda_ms(call, 20),
               "call_device_ms": dev_ms, "call_host_ms": host_ms}
        if cfg is shadow:
            maxv = pl.effective_cull_maxv(cfg, fprep.num_blocks,
                                          cfg.kernel.window_blocks)
            fcam = pl.camera(fprep, cam_spec, light)
            t, _i, obj, _rgb, bounds = nearest.hits_shaded(
                fprep, cfg, light, cam_spec, maxv, cam=fcam)
            res["shadow_plan_and_k2_ms"] = cs.cuda_ms(
                lambda: anyhit.anyhit_from_t(fprep, cfg, t, obj, bounds,
                                             fcam, cam_spec, maxv), 10)
            res["ms_per_frame"] = cs.view_varied_ms(
                sr, fprep, cfg, light, cs.FRAMES, label)
        cs.emit(**res, gpu=gpu)
        cs.require(res["found_equal_every_lane"],
                   f"K2 found differs from the plain walk's ({label})")
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
