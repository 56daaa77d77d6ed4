"""One process of the worlds of tests/test_torch_dist.py: the port's
distribution layer on gloo CPU processes, at the test's small shapes.

    python tests/_torch_dist_worker.py WORLD INPUTS OUT_DIR [HOST:PORT N RANK]

WORLD is "dp" (2 processes), "gp" (4) or "composed" (4, a 2 x 2 mesh).
INPUTS is the test's .npz: the scene's arrays (``scene_*``) and the training
target (``target``).  Without the last three arguments the process joins
the group from torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK); with them, from those explicit arguments.  Each process
writes OUT_DIR/WORLD_RANK.npz.  It imports no JAX: the test holds what it
writes against the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import simple_raytracer_tpu_torch as sr  # noqa: E402
from simple_raytracer_tpu_torch.scene.scene import (Scene,  # noqa: E402
                                                    scene_from_numpy)

# the frames: renders at 64x32, the ring's rays and the training steps at
# 32x16, focal 64 (the icosphere(2) parity scene on its tilted ground, the
# sphere's shadow in view)
WIDTH, HEIGHT, FOCAL = 64, 32, 64.0
SMALL_W, SMALL_H = 32, 16
LIGHT = (500.0, -300.0, -200.0)
LR, STEPS = 1e-3, 5
ROWS = 33                     # host_local_rows' image height
MODES = ("bruteforce", "bvh", "tiled")


def frame_cfg(mode: str = "bruteforce"):
    return sr.default_config().replace(
        mode=mode, camera=sr.CameraConfig(width=WIDTH, height=HEIGHT,
                                          focal=FOCAL))


def train_cfg(mode: str = "bruteforce", shadows: bool = False):
    return frame_cfg(mode).replace(
        camera=sr.CameraConfig(width=SMALL_W, height=SMALL_H, focal=FOCAL),
        light=sr.LightConfig(enable_shadows=shadows))


def ring_rays():
    """The ring's home rays: the 32x16 primary rays, flat."""
    from simple_raytracer_tpu_torch.ops.camera import primary_rays
    o, d = primary_rays(SMALL_W, SMALL_H, FOCAL)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def start_params(scene, light):
    """The DP step's start: the light moved by 25, the colours halved (as
    JAX's tests/test_dist.py)."""
    p = sr.extract_params(scene, light)
    p.light_pos = p.light_pos + 25.0
    p.obj_color = p.obj_color * 0.5
    return p


def ring_queries(shard_or_shards, o, d, light, group=None, overlap=True):
    """(t, object, occlusion) of the rays o, d through the ring (``group``)
    or its local schedule (``group`` None, every shard given): the nearest
    walk with the 26-wide records, then the shadow rays from the hit
    points to the light."""
    from simple_raytracer_tpu_torch.dist import ring
    if group is None:
        t, rec = ring.ring_nearest_hit_local(shard_or_shards, o, d,
                                             apex=True)
    else:
        t, rec = ring.ring_nearest_hit(shard_or_shards, o, d, group,
                                       apex=True, overlap=overlap)
    hit = torch.isfinite(t)
    p = torch.where(hit[:, None], o + torch.where(hit, t, 0.0)[:, None] * d,
                    0.0)
    obj = rec["obj"].clamp_min(0)
    if group is None:
        occ = ring.ring_any_hit_other_local(shard_or_shards, p, light - p,
                                            obj, hit=hit)
    else:
        occ = ring.ring_any_hit_other(shard_or_shards, p, light - p, obj,
                                      group, hit=hit, overlap=overlap)
    return t, rec["obj"], occ


def _dp(scene, target, out):
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.dist import make_mesh, render_sharded
    from simple_raytracer_tpu_torch.dist.multihost import host_local_rows
    from simple_raytracer_tpu_torch.driver.animation import frames_parallel
    from simple_raytracer_tpu_torch.scene.catalog import orbit_view
    light = torch.tensor(LIGHT)
    mesh = make_mesh(2, ("dp",), device="cpu")
    try:
        make_mesh(3, ("dp",), device="cpu")
        out["make_mesh_3_raised"] = False
    except ValueError:
        out["make_mesh_3_raised"] = True
    out["rows"] = np.array(host_local_rows(ROWS))
    for mode in MODES:
        cfg = frame_cfg(mode)
        op = scene if mode == "bruteforce" else prepare(scene, cfg, "cpu")
        out[f"img_{mode}"] = render_sharded(op, cfg, light, mesh).numpy()
    for mode in ("bruteforce", "tiled"):
        cfg = train_cfg(mode)
        op = scene if mode == "bruteforce" else prepare(scene, cfg, "cpu")
        base = op if mode == "bruteforce" else op.scene
        step = sr.make_train_step(op, cfg, mesh=mesh, lr=LR)
        p, loss = step(start_params(base, light), target)
        out[f"train_{mode}_loss"] = float(loss)
        out[f"train_{mode}_obj_color"] = p.obj_color.numpy()
        losses = [float(loss)]
        for _ in range(STEPS):
            p, loss = step(p, target)
            losses.append(float(loss))
        out[f"train_{mode}_losses"] = np.array(losses)
    views = np.stack([orbit_view(a, 100.0, 0.0, 0.0) for a in (0.0, 60.0)])
    out["frames"] = frames_parallel(scene, frame_cfg(), views, light, mesh,
                                    axis="dp").numpy()
    _turntable(mesh, out)


def _turntable(mesh, out):
    """The one-cube turntable over the two processes, both writing to one
    metrics file; after a barrier each reads that file's events back."""
    import json
    from simple_raytracer_tpu_torch.driver.animation import render_turntable
    from simple_raytracer_tpu_torch.scene import procedural as P
    root = os.path.join(OUT_DIR, f"assets_{dist.get_rank()}")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "cube.obj"), "w") as f:
        f.write(P.obj_text(P.box()))
    metrics = os.path.join(OUT_DIR, "turntable.jsonl")
    files = render_turntable(
        "one_cube", root, frame_cfg(), sr.AnimationConfig(step_deg=180.0),
        out_dir=os.path.join(OUT_DIR, "turntable"), metrics_path=metrics,
        mesh=mesh, frame_axis="dp", device="cpu")
    dist.barrier()
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    out["turntable_events"] = np.array([e["event"] for e in events])
    out["turntable_devices"] = np.array([e.get("devices", 0)
                                         for e in events])
    out["turntable_saved"] = np.array([os.path.exists(p) for p in files])


def _gp(scene, target, out):
    from simple_raytracer_tpu_torch.dist import make_mesh, ring
    from simple_raytracer_tpu_torch.dist.sharding import slab
    light = torch.tensor(LIGHT)
    mesh = make_mesh(4, ("gp",), device="cpu")
    ax = mesh.axis("gp")
    shards = ring.shard_geometry(scene, 4, frame_cfg(), device="cpu")
    o, d = ring_rays()
    mine = (slab(o, ax.index, 4), slab(d, ax.index, 4))
    for overlap in (True, False):
        got = ring_queries(shards[ax.index], *mine, light, ax, overlap)
        for name, x in zip(("t", "obj", "occ"), got):
            out[f"ring_{name}_{'overlap' if overlap else 'plain'}"] = \
                ax.all_gather(x.to(torch.float32)).numpy()
    if ax.index == 0:
        for name, x in zip(("t", "obj", "occ"),
                           ring_queries(shards, o, d, light)):
            out[f"ring_{name}_local"] = x.to(torch.float32).numpy()
    out["img_geometry"] = ring.render_geometry_sharded(
        scene, frame_cfg(), light, mesh).numpy()


def _composed(scene, target, out):
    from simple_raytracer_tpu_torch.dist import (make_mesh,
                                                 make_train_step_composed)
    from simple_raytracer_tpu_torch.dist.ring import render_composed
    light = torch.tensor(LIGHT)
    mesh = make_mesh(4, ("dp", "gp"), (2, 2), device="cpu")
    out["img_composed"] = render_composed(scene, frame_cfg(), light,
                                          mesh).numpy()
    for shadows in (False, True):
        step, p0, _ = make_train_step_composed(
            scene, train_cfg(shadows=shadows), mesh, lr=LR)
        p0.light_pos = light + 10.0
        p0.obj_color = p0.obj_color * 0.5
        p1, loss = step(p0, target)
        key = "composed_shadows" if shadows else "composed"
        out[f"{key}_loss"] = float(loss)
        for i, leaf in enumerate(p1.leaves()):
            out[f"{key}_leaf_{i}"] = leaf.numpy()


WORLDS = {"dp": _dp, "gp": _gp, "composed": _composed}
OUT_DIR = ""                  # the directory the outputs go to


def main(argv) -> int:
    from simple_raytracer_tpu_torch.dist.multihost import init_distributed
    torch.set_num_threads(1)
    global OUT_DIR
    world, inputs, out_dir = argv[:3]
    OUT_DIR = out_dir
    with np.load(inputs) as z:
        scene = scene_from_numpy({k: z["scene_" + k]
                                  for k in Scene.ARRAY_FIELDS},
                                 bool(z["has_textures"]))
        target = torch.from_numpy(z["target"])
    out = {}
    if len(argv) > 3:
        coordinator, n, rank = argv[3], int(argv[4]), int(argv[5])
        joined = init_distributed(coordinator, n, rank, device="cpu")
    else:
        # no cluster named: no group; then torchrun's environment
        saved = os.environ.pop("MASTER_ADDR")
        out["nothing_named"] = init_distributed(device="cpu")
        out["nothing_initialised"] = not dist.is_initialized()
        os.environ["MASTER_ADDR"] = saved
        joined = init_distributed(device="cpu")
    out["joined"] = joined
    out["repeat"] = init_distributed(device="cpu")
    out["world_size"] = dist.get_world_size()
    rank = dist.get_rank()
    try:
        WORLDS[world](scene, target, out)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{world}_{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
