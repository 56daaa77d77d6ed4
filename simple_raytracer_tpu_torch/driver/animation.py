"""Animation sweep driver: the reference's 36-frame turntable.

Reference behavior (simple_raytracer.cpp:530-796): for each angle in
0..350 step 10, rebuild the WHOLE scene from disk (OBJ parse included), bake
inverse(view) into geometry + light, rebuild every BVH, render, save
``output{angle}.bmp`` eagerly (a crash keeps the finished frames).

Counterpart of the JAX package's ``driver/animation.py``:
  * world mode (default): scene and BVH built ONCE on the device; the
    camera's rays are the only per-frame change; each frame is saved as
    soon as it is rendered, as in the reference;
  * bake mode: the reference's per-frame rebuild (for parity);
  * resume=True: frames whose output file exists are skipped;
  * frame-parallel: whole frames sharded over the processes of a mesh
    axis (dist/sharding.py), gathered onto every process;
  * per-frame metrics (ms, rays/s) to stdout and an optional JSONL file.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import AnimationConfig, RenderConfig
from ..io.image import save_image
from ..render import integrator
from ..render.renderer import ensure_prepared, render, render_radiance
from ..scene import catalog
from ..utils.metrics import FRAME_SPAN, Metrics, span

def sweep_angles(anim: AnimationConfig) -> np.ndarray:
    return np.arange(anim.start_deg, anim.stop_deg, anim.step_deg,
                     dtype=np.float32)


def frame_filename(angle: float, fmt: str) -> str:
    """``output{angle}.{fmt}``: integer angles match the reference's names
    (``output0.bmp`` ...); fractional angles (step_deg < 1) keep their
    fraction instead of colliding on int(angle)."""
    a = float(angle)
    label = str(int(a)) if a == int(a) else f"{a:g}"
    return f"output{label}.{fmt}"


def render_turntable(scene_name: str, root: str, cfg: RenderConfig,
                     anim: AnimationConfig = AnimationConfig(),
                     out_dir: str = "images/generation",
                     fmt: str = "bmp",
                     world_space: bool = True,
                     resume: bool = True,
                     metrics_path: Optional[str] = None,
                     mesh=None,
                     frame_axis: str = "pp",
                     device="cuda") -> list:
    """Render the turntable sweep of a catalog scene on ``device`` (the
    card unless the caller asks for "cpu"), saving each frame as soon as
    it is rendered.  With ``mesh`` (world mode; the mesh's device), the
    frames are sharded over its ``frame_axis`` (:func:`frames_parallel`),
    every frame of the sweep is rendered, resume or not, as JAX's, and the
    first process of the axis saves them and writes the metrics.  Returns
    the list of the sweep's file paths."""
    builder = catalog.CATALOG[scene_name]
    angles = sweep_angles(anim)
    lead = mesh is None or mesh.axis(frame_axis).index == 0
    metrics = Metrics(metrics_path if lead else None, echo=lead)

    if world_space:
        sm, _, light = builder(root, 0.0, bake_view=False)
        scene = sm.build()
        t0 = time.time()
        world = ensure_prepared(scene, cfg,
                                device if mesh is None else mesh.device)
        metrics.emit(event="prepare", seconds=round(time.time() - t0, 3),
                     triangles=scene.num_triangles)
        if mesh is not None:
            views = np.stack([catalog.orbit_view(
                a, anim.orbit_radius, anim.camera_y, anim.pitch_deg,
                anim.yaw_offset_deg) for a in angles])
            written = _sweep_frame_parallel(world, cfg, views, light, angles,
                                            out_dir, fmt, mesh, frame_axis,
                                            metrics)
            metrics.close()
            return written
    todo = [a for a in angles
            if not (resume and os.path.exists(
                os.path.join(out_dir, frame_filename(a, fmt))))]
    render_s = 0.0
    for a in todo:
        path = os.path.join(out_dir, frame_filename(a, fmt))
        if world_space:
            operand, view = world, catalog.orbit_view(
                a, anim.orbit_radius, anim.camera_y, anim.pitch_deg,
                anim.yaw_offset_deg)
        else:
            # reference-parity mode: rebuild + rebake + re-BVH per frame
            sm, _, light = builder(root, float(a), bake_view=True)
            operand, view = ensure_prepared(sm.build(), cfg, device), None
        t0 = time.time()
        img = render(operand, cfg, light, view_matrix=view,
                     device=device).cpu().numpy()
        dt = time.time() - t0
        render_s += dt
        save_image(path, img)
        if not world_space:
            metrics.emit(event="frame", angle=float(a),
                         ms=round(dt * 1e3, 2), path=path)
    if world_space and todo:
        rays = cfg.camera.width * cfg.camera.height
        metrics.emit(event="sweep", frames=len(todo),
                     ms_per_frame=round(render_s * 1e3 / len(todo), 2),
                     rays_per_s=round(rays * len(todo) / render_s, 1))
    metrics.close()
    return [os.path.join(out_dir, frame_filename(a, fmt)) for a in angles]


def frames_batched(prep_or_scene, cfg: RenderConfig, views, light,
                   device="cuda") -> torch.Tensor:
    """Render a batch of frames, one per view [F, 4, 4], on the device of
    the prepared scene (a Scene is prepared, or for bruteforce moved, onto
    ``device`` first) -> [F, H, W, 3] uint8 on that device.  One device
    holds every frame, so the frames run one after another (JAX chunks
    them only to bound a lax.map)."""
    operand = ensure_prepared(prep_or_scene, cfg, device)
    dev = operand.device
    light = torch.as_tensor(light, dtype=torch.float32, device=dev)
    views = torch.as_tensor(views, dtype=torch.float32, device=dev)
    out = []
    for V in views:
        with span(FRAME_SPAN):
            radiance, hit = render_radiance(operand, cfg, light,
                                            view_matrix=V)
            out.append(integrator.finalize_image(radiance, hit, cfg))
    return torch.stack(out)


def frames_parallel(prep_or_scene, cfg: RenderConfig, views, light, mesh,
                    axis: str = "pp") -> torch.Tensor:
    """Whole frames sharded over ``mesh`` ``axis`` (JAX
    ``frames_parallel``): views [F, 4, 4] with F a multiple of the axis
    size; each process renders its contiguous F / n frames on the mesh's
    device (:func:`frames_batched`) and the frames are gathered.  Returns
    [F, H, W, 3] uint8 on every process of the axis."""
    from ..dist.sharding import on_mesh_device, slab
    ax = mesh.axis(axis)
    views = torch.as_tensor(views, dtype=torch.float32)
    if views.shape[0] % ax.size:
        raise ValueError(f"{views.shape[0]} frames over {ax.size} processes")
    operand = on_mesh_device(prep_or_scene, cfg, mesh)
    mine = frames_batched(operand, cfg, slab(views, ax.index, ax.size),
                          light, device=mesh.device)
    return ax.all_gather(mine)


def _sweep_frame_parallel(prep, cfg, views, light, angles, out_dir, fmt,
                          mesh, axis, metrics) -> list:
    """The sweep's frames over ``mesh`` ``axis`` (padded to a multiple of
    its size with the last view), saved by the axis's first process, with
    a ``sweep`` event that names the processes (``devices``)."""
    ax = mesh.axis(axis)
    F = len(angles)
    Fpad = -(-F // ax.size) * ax.size
    vpad = np.concatenate([views, np.repeat(views[-1:], Fpad - F, axis=0)])
    t0 = time.time()
    imgs = frames_parallel(prep, cfg, vpad, light, mesh, axis).cpu().numpy()
    dt = time.time() - t0
    written = [os.path.join(out_dir, frame_filename(a, fmt)) for a in angles]
    metrics.emit(event="sweep", frames=F, devices=ax.size,
                 ms_total=round(dt * 1e3, 2),
                 ms_per_frame=round(dt * 1e3 / F, 2))
    if ax.index == 0:
        for path, img in zip(written, imgs):
            save_image(path, img)
    return written
