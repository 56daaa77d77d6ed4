"""Command-line interface (the JAX package's ``cli.py``, its flags, names
and defaults, plus ``--device``).

The reference has no CLI: scene choice = commenting blocks of main() in or
out, every knob a recompiled constant (SURVEY.md §5 lists them all).  This
CLI exposes each of those constants as a flag over the scene catalog.  It
renders on the card unless ``--device cpu`` asks for the plain PyTorch
versions; without a CUDA device it raises.

  python -m simple_raytracer_tpu_torch render  --scene complex --out f.png
  python -m simple_raytracer_tpu_torch animate --scene complex --out-dir gen/
  python -m simple_raytracer_tpu_torch render  --device cpu --mode bvh ...
  python -m simple_raytracer_tpu_torch train   --scene six_spheres --steps 50

``animate --frame-parallel`` and ``train --data-parallel`` run on a mesh
over every process of the group: ``torchrun --nproc-per-node N -m
simple_raytracer_tpu_torch ...`` starts one process per card (or, with
``--device cpu``, N CPU processes over gloo); started plainly, the command
is a world of one process.  The first process of the mesh writes the
files and the metrics.
"""

from __future__ import annotations

import argparse
import sys
import time

def _add_render_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--root", default="reference",
                   help="asset root (reference repo layout)")
    p.add_argument("--scene", default="complex",
                   choices=["complex", "six_spheres", "big_cat", "one_cube",
                            "four_cubes"])
    p.add_argument("--width", type=int, default=600)       # :773
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--focal", type=float, default=400.0)   # :506
    # default = the path of the hand-written kernels; bvh is the plain
    # PyTorch walk, bruteforce the oracle
    p.add_argument("--mode", default="tiled",
                   choices=["bruteforce", "bvh", "tiled"])
    p.add_argument("--light-samples", type=int, default=1)  # :445
    p.add_argument("--no-shadows", action="store_true")     # :385-386
    p.add_argument("--smooth-normals", action="store_true")  # :162-164
    p.add_argument("--reinhard", type=float, default=0.5)   # :391
    p.add_argument("--gamma", type=float, default=1.1)      # :396
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--leaf-size", type=int, default=8)      # Object.cpp:261
    p.add_argument("--bvh-split", default="median",
                   choices=["median", "sah"],
                   help="median = reference topology; sah = surface area")
    p.add_argument("--tile-px", type=int, default=0,
                   help="tiled-mode pixel tile edge (0 = adaptive)")
    p.add_argument("--shadow-tile", type=int, default=0,
                   help="tiled-mode shadow ray-tile size (0 = adaptive)")
    p.add_argument("--hit-tile", type=int, default=0,
                   help="tiled-mode nearest-pass ray-tile (0 = full tile)")
    p.add_argument("--jitter-step", type=float, default=3.0)  # :372-382
    p.add_argument("--shadow-dim", type=float, default=5.0)   # :369
    p.add_argument("--bake-view", action="store_true",
                   help="reference mode: bake inverse(view) into geometry")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--profile", default=None,
                   help="torch.profiler trace dir")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the plain PyTorch versions)")


def _config_from(args):
    from .config import (RenderConfig, CameraConfig, LightConfig,
                         ShadingConfig, BVHConfig)
    return RenderConfig(
        camera=CameraConfig(width=args.width, height=args.height,
                            focal=args.focal),
        light=LightConfig(num_samples=args.light_samples,
                          jitter_step=args.jitter_step,
                          shadow_dim=args.shadow_dim,
                          enable_shadows=not args.no_shadows),
        shading=ShadingConfig(smooth_normals=args.smooth_normals,
                              reinhard_offset=args.reinhard,
                              gamma=args.gamma,
                              tonemap_enabled=not args.no_tonemap),
        bvh=BVHConfig(leaf_size=args.leaf_size, split=args.bvh_split),
        mode=args.mode,
        tile_px=args.tile_px,
        shadow_tile=args.shadow_tile,
        hit_tile=args.hit_tile)


def cmd_render(args) -> int:
    from .accel.prepared import target_device
    from .io.image import save_image
    from .render.renderer import render
    from .scene import catalog
    from .utils.metrics import Metrics, profile_trace

    target_device(args.device)
    if args.show:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError("--show opens PIL's viewer, and PIL is not "
                               "installed") from None
    cfg = _config_from(args)
    m = Metrics(args.metrics)
    builder = catalog.CATALOG[args.scene]
    t0 = time.time()
    sm, view, light = builder(args.root, args.angle, bake_view=args.bake_view)
    scene = sm.build()
    m.emit(event="scene", triangles=scene.num_triangles,
           seconds=round(time.time() - t0, 3))
    with profile_trace(args.profile):
        t0 = time.time()
        img = render(scene, cfg, light, view_matrix=view,
                     device=args.device).cpu().numpy()
        dt = time.time() - t0
    m.emit(event="render", ms=round(dt * 1e3, 2),
           rays_per_s=round(args.width * args.height / dt, 1))
    save_image(args.out, img)
    m.emit(event="saved", path=args.out)
    if args.show:
        # the reference pops a blocking CImg window per frame
        # (simple_raytracer.cpp:495-497); PIL's viewer is the analog
        Image.fromarray(img).show(title=f"{args.scene} @ {args.angle}")
    m.close()
    return 0


def cmd_animate(args) -> int:
    from .accel.prepared import target_device
    from .config import AnimationConfig
    from .driver.animation import render_turntable
    from .utils.metrics import profile_trace

    target_device(args.device)
    mesh = None
    if args.frame_parallel:
        from .dist.sharding import make_mesh
        mesh = make_mesh(None, ("pp",), device=args.device)
    cfg = _config_from(args)
    anim = AnimationConfig(step_deg=args.step_deg,
                           orbit_radius=args.orbit_radius,
                           camera_y=args.camera_y,
                           pitch_deg=args.pitch_deg)
    with profile_trace(args.profile):
        render_turntable(args.scene, args.root, cfg, anim,
                         out_dir=args.out_dir, fmt=args.fmt,
                         world_space=not args.bake_view,
                         resume=not args.no_resume,
                         metrics_path=args.metrics, mesh=mesh,
                         device=args.device)
    return 0


def cmd_train(args) -> int:
    """Fit the scene's params, from a perturbed start (the light moved by
    ``--perturb``, the colours halved), to its own rendered image, in
    bruteforce mode, as JAX's ``train``; ``--checkpoint`` saves every
    ``--ckpt-every`` steps and at the end, and a rerun resumes from it.
    ``--data-parallel`` splits each step's rays over the processes."""
    import torch
    from .accel.prepared import target_device
    from .dist import extract_params, make_mesh, make_train_step
    from .render.renderer import render_radiance
    from .scene import catalog
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import Metrics

    dev = target_device(args.device)
    mesh = None
    if args.data_parallel:
        mesh = make_mesh(None, ("dp",), device=args.device)
        dev = mesh.device
    lead = mesh is None or mesh.index == 0
    cfg = _config_from(args).replace(mode="bruteforce")
    m = Metrics(args.metrics if lead else None, echo=lead)
    sm, _view, light = catalog.CATALOG[args.scene](args.root, args.angle,
                                                   bake_view=True)
    scene = sm.build().to(dev)
    with torch.no_grad():
        target, hit = render_radiance(scene, cfg, light)
        target = torch.where(hit[..., None], target, 0.0)

    params = extract_params(scene, light)
    params.light_pos = params.light_pos + args.perturb
    params.obj_color = params.obj_color * 0.5
    start = 0
    if args.checkpoint:
        restored = load_checkpoint(args.checkpoint, params)
        if restored:
            params, start = restored
            m.emit(event="resumed", step=start)
    step = make_train_step(scene, cfg, mesh=mesh, lr=args.lr)
    for i in range(start, args.steps):
        params, loss = step(params, target)
        if i % args.log_every == 0 or i == args.steps - 1:
            m.emit(event="train", step=i, loss=float(loss))
        if lead and args.checkpoint and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.checkpoint, params, i + 1)
    if lead and args.checkpoint:
        save_checkpoint(args.checkpoint, params, args.steps)
    m.close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="simple_raytracer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame of a catalog scene")
    _add_render_flags(pr)
    pr.add_argument("--angle", type=float, default=0.0)
    pr.add_argument("--out", default="output.png")
    pr.add_argument("--show", action="store_true",
                    help="open a viewer window (reference :495-497)")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="turntable sweep (reference main())")
    _add_render_flags(pa)
    pa.add_argument("--out-dir", default="images/generation")
    pa.add_argument("--fmt", default="bmp", choices=["bmp", "png"])
    pa.add_argument("--step-deg", type=float, default=10.0)   # :534
    pa.add_argument("--orbit-radius", type=float, default=50.0)
    pa.add_argument("--camera-y", type=float, default=-50.0)
    pa.add_argument("--pitch-deg", type=float, default=30.0)
    pa.add_argument("--frame-parallel", action="store_true")
    pa.add_argument("--no-resume", action="store_true")
    pa.set_defaults(fn=cmd_animate)

    pt = sub.add_parser("train", help="fit scene params to a rendered target")
    _add_render_flags(pt)
    pt.add_argument("--angle", type=float, default=0.0)
    pt.add_argument("--steps", type=int, default=50)
    pt.add_argument("--lr", type=float, default=1e-5)
    pt.add_argument("--perturb", type=float, default=20.0)
    pt.add_argument("--data-parallel", action="store_true")
    pt.add_argument("--checkpoint", default=None)
    pt.add_argument("--ckpt-every", type=int, default=20)
    pt.add_argument("--log-every", type=int, default=10)
    pt.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
