#!/usr/bin/env python3
"""The port's distribution layer across the cards of one host: one process
per card over NCCL (or, with ``--device cpu``, over gloo).

    torchrun --nproc-per-node 4 scripts/torch_dist_cards.py
    torchrun --nproc-per-node 4 scripts/torch_dist_cards.py --device cpu \\
        --width 96 --height 64 --subdivisions 3       # a rehearsal on CPUs

On the shadow bench (chip_smoke.py: a displaced icosphere on the box
ground, focal = height, light (500, -300, -200), tiled mode):

* **dp**: ``render_sharded`` over N processes, equal on every pixel to the
  explicit-ray render of the same rays on one process; ms/frame, beside
  one process's explicit-ray frame and the fused frame;
* **ring**: the triangles in N shards, one per process, the home slabs
  rotating around the ring (``ring_frame``): the image against the fused
  frame (within 1 on >= 99.9% of pixels, equal on >= 99.5%); the nearest
  walk and the shadow of the home slabs with the overlap schedule and the
  plain one, each bit for bit equal to the local schedule of the first
  process (every shard on its card); ms of each, and of the local
  schedule's frame on the first card alone;
* **composed** (N = 4): four ``make_train_step_composed`` steps on a 2 x 2
  mesh, falling losses, the first step's ms (it makes the groups' NCCL
  communicators) and the others' ms/step.

The first process prints one JSON line per part, the cards' names and
power limits, and exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

REPS = 5
IMAGE_MIN, RING_EQUAL_MIN = 0.999, 0.995
LR, COLOR, STEPS = 1e-3, 0.7, 3


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int = REPS) -> float:
    """Host ms per run over ``reps`` runs after a warm-up, every process
    in step (a barrier before the clock starts)."""
    fn()
    sync(dev)
    dist.barrier()
    t0 = time.time()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.time() - t0) * 1e3 / reps


def bars(img, ref) -> dict:
    diff = (img.int() - ref.int()).abs().amax(dim=-1)
    return {"within_1": float((diff <= 1).float().mean()),
            "equal": float((diff == 0).float().mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--subdivisions", type=int, default=6)
    args = ap.parse_args()

    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.dist import (make_mesh,
                                                 make_train_step_composed,
                                                 render_sharded, ring)
    from simple_raytracer_tpu_torch.dist.sharding import slab
    from simple_raytracer_tpu_torch.kernels import build
    from simple_raytracer_tpu_torch.kernels.tiled import render_flat_tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    from simple_raytracer_tpu_torch.scene import procedural as P

    mesh = make_mesh(None, ("dp",), device=args.device)
    dev, n, lead = mesh.device, mesh.size, mesh.index == 0
    failures = []

    def report(**kw):
        if lead:
            print(json.dumps(kw), flush=True)

    def check(ok: bool, what: str):
        if not ok:
            failures.append(what)
            report(failed=what)

    if dev.type == "cuda":
        if lead:                      # one nvcc per source, once
            build.build()
        dist.barrier()
        build.library()
    scene = P.sphere_on_ground(sr.SceneManager(), args.subdivisions).build()
    W, H = args.width, args.height
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=W, height=H,
                                             focal=float(H)),
        bvh=sr.BVHConfig(split="sah"))
    prep = prepare(scene, cfg, device=dev)
    light = torch.tensor(P.BENCH_LIGHT, dtype=torch.float32, device=dev)
    o, d = primary_rays(W, H, float(H), device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    fused = sr.render(prep, cfg, light)

    # dp: row-major slabs over the processes
    img = render_sharded(prep, cfg, light, mesh)

    def explicit():
        rad, hit = render_flat_tiled(prep, cfg, light, None, rays=(o, d))
        return finalize_image(rad.reshape(H, W, 3), hit.reshape(H, W), cfg)
    same = bool(torch.equal(img, explicit()))
    check(same, "dp frame != the explicit-ray render of the same rays")
    report(part="dp", processes=n, backend=dist.get_backend(),
           equal_explicit_every_pixel=same, vs_fused=bars(img, fused),
           ms_per_frame=host_ms(lambda: render_sharded(prep, cfg, light,
                                                       mesh), dev),
           one_process_explicit_ms=host_ms(explicit, dev),
           one_process_fused_ms=host_ms(lambda: sr.render(prep, cfg, light),
                                        dev))

    # ring: one shard a process; the first process also holds every shard
    gp_mesh = make_mesh(None, ("gp",), device=args.device)
    gp = gp_mesh.axis("gp")
    shards = ring.shard_geometry(scene, n, cfg, device="cpu")
    mine = shards[gp.index].to(dev)
    tables = ring.strip_scene_tables(scene).to(dev)
    rimg = ring.ring_frame(tables, mine, cfg, light, gp_mesh, ("gp",), "gp")
    rb = bars(rimg, fused)
    check(rb["within_1"] >= IMAGE_MIN and rb["equal"] >= RING_EQUAL_MIN,
          f"ring frame vs fused {rb}")
    so, sd = slab(o, gp.index, n), slab(d, gp.index, n)

    def queries(overlap):
        t, rec = ring.ring_nearest_hit(mine, so, sd, gp, apex=True,
                                       overlap=overlap)
        hit = torch.isfinite(t)
        p = torch.where(hit[:, None], so + torch.where(hit, t, 0.0)[:, None]
                        * sd, 0.0)
        occ = ring.ring_any_hit_other(mine, p, light - p,
                                      rec["obj"].clamp_min(0), gp, hit=hit,
                                      overlap=overlap)
        return t, rec["obj"], occ, p, hit
    got = {ov: [gp.all_gather(x.to(torch.float32)) for x in queries(ov)[:3]]
           for ov in (True, False)}
    if lead:
        local = [s.to(dev) for s in shards]
        t, rec = ring.ring_nearest_hit_local(local, o, d, apex=True)
        hit = torch.isfinite(t)
        p = torch.where(hit[:, None], o + torch.where(hit, t, 0.0)[:, None]
                        * d, 0.0)
        occ = ring.ring_any_hit_other_local(local, p, light - p,
                                            rec["obj"].clamp_min(0),
                                            hit=hit)
        want = [x.to(torch.float32) for x in (t, rec["obj"], occ)]
        for ov in (True, False):
            check(all(torch.equal(a, b) for a, b in zip(got[ov], want)),
                  f"ring (overlap={ov}) != the local schedule")

        def local_frame():
            ring.render_flat_ring_local(tables, local, cfg, o, d, light,
                                        apex=True)
        local_frame()
        sync(dev)
        t0 = time.time()
        for _ in range(REPS):
            local_frame()
        sync(dev)
        local_ms = (time.time() - t0) * 1e3 / REPS
    dist.barrier()
    _, obj, _, p, hit = queries(True)
    times = {}
    for ov in (True, False):
        key = "overlap" if ov else "plain"
        times[f"nearest_{key}_ms"] = host_ms(
            lambda ov=ov: ring.ring_nearest_hit(mine, so, sd, gp, apex=True,
                                                overlap=ov), dev)
        times[f"shadow_{key}_ms"] = host_ms(
            lambda ov=ov: ring.ring_any_hit_other(
                mine, p, light - p, obj.clamp_min(0), gp, hit=hit,
                overlap=ov), dev)
    report(part="ring", shards=n, home_rays=int(so.shape[0]),
           shard_triangles=[s.prep.num_triangles for s in shards],
           vs_fused=rb, schedules_equal_local=not any(
               "local schedule" in f for f in failures),
           one_card_local_schedule_ms=local_ms if lead else None,
           ms_per_frame=host_ms(lambda: ring.ring_frame(
               tables, mine, cfg, light, gp_mesh, ("gp",), "gp"), dev),
           **times)

    # composed: dp x gp = 2 x 2, three steps
    if n == 4:
        mesh2 = make_mesh(4, ("dp", "gp"), (2, 2), device=args.device)
        with torch.no_grad():
            rad, hit = sr.render_radiance(prep, cfg, light)
            target = torch.where(hit[..., None], rad, 0.0)
        step, params, _ = make_train_step_composed(scene, cfg, mesh2, lr=LR)
        params.light_pos = light.clone()
        params.obj_color = params.obj_color * COLOR
        sync(dev)
        t0 = time.time()
        losses = []
        for _ in range(STEPS + 1):
            params, loss = step(params, target)
            losses.append(float(loss))
            if len(losses) == 1:       # the first step makes the groups'
                sync(dev)              # NCCL communicators: timed apart
                t1 = time.time()
        ms = (time.time() - t1) * 1e3 / STEPS
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"composed losses {losses} do not fall")
        report(part="composed", mesh={"dp": 2, "gp": 2}, losses=losses,
               first_step_ms=(t1 - t0) * 1e3, ms_per_step=ms)

    if lead and dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
