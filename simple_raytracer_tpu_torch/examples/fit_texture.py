"""Inverse rendering: recover a texture atlas from a rendered image (the JAX
package's ``examples/fit_texture.py``).

Renders a target image of a textured scene, resets the atlas to grey, and
fits the atlas pixels by Adam (lr 5e-2, pixels clipped to [0, 1]) until the
renders match: the texel gather's backward, a scatter-add onto the atlas,
does the work.  The render is ``render_radiance`` in bruteforce mode, whose
gradients reach ``tex_data``.  The scene is the JAX example's textured tree
from the asset directory ``--root``, or without one the procedural checker
ground (``scene/procedural.py::textured_on_ground``).

    python -m simple_raytracer_tpu_torch.examples.fit_texture \\
        [--root ASSETS] [--device cpu] [--out DIR]

``--out`` writes target.png, before.png and after.png there.  Exits non-zero
unless the image error falls below 5% of its start.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

LIGHT = (500.0, -300.0, -200.0)
WIDTH, HEIGHT = 96, 72
STEPS = 80
# the procedural scene's focal per image row: the sphere and the checker
# ground both in view
FOCAL_PER_ROW = 200.0 / 72.0


def scene_and_config(root, width: int = WIDTH, height: int = HEIGHT,
                     device="cuda"):
    """(scene on ``device``, RenderConfig): the JAX example's tree from
    ``root`` at the default focal, or without ``root`` the procedural
    textured scene of subdivision 3; bruteforce mode, no shadows."""
    from ..accel.prepared import target_device
    from ..config import CameraConfig, LightConfig, default_config
    from ..scene import procedural as P
    from ..scene import transforms as T
    from ..scene.scene import SceneManager
    dev = target_device(device)
    camera = CameraConfig(width=width, height=height)
    if root is None:
        sm = P.textured_on_ground(SceneManager(), 3)
        camera = CameraConfig(width=width, height=height,
                              focal=FOCAL_PER_ROW * height)
    else:
        sm = SceneManager(root=root)
        sm.load_obj_file(os.path.join(root, "obj", "tree", "tree.obj"),
                         key="tree")
        sm.transform_triangles("tree", T.scale(0.035, 0.035, 0.035))
        sm.transform_triangles("tree", T.rotate_x(float(np.radians(-90.0))))
        sm.transform_triangles("tree", T.translate((0.0, 12.0, 40.0)))
    scene = sm.build().to(dev)
    if not scene.has_textures:
        raise ValueError("the scene has no texture to fit")
    cfg = default_config().replace(camera=camera,
                                   light=LightConfig(enable_shadows=False))
    return scene, cfg


def masked_render(scene, cfg, light, tex):
    """(radiance [H, W, 3] with misses at 0, hit [H, W]) of ``scene``
    with the atlas ``tex``."""
    from ..render.renderer import render_radiance
    rad, hit = render_radiance(dataclasses.replace(scene, tex_data=tex), cfg,
                               light)
    return torch.where(hit[..., None], rad, 0.0), hit


def fit(scene, cfg, light, steps: int, lr: float = 5e-2, log=None):
    """Fit a grey atlas to ``scene``'s own image by Adam.  Returns (the
    fitted atlas, the loss of each step, the target image, its hit mask)."""
    with torch.no_grad():
        target, hit = masked_render(scene, cfg, light, scene.tex_data)
    tex = torch.full_like(scene.tex_data, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=lr)
    losses = []
    for i in range(steps):
        pred, _ = masked_render(scene, cfg, light, tex)
        loss = ((pred - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        with torch.no_grad():
            tex.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
        if log is not None:
            log(i, losses[-1])
    return tex.detach(), losses, target, hit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="asset directory holding obj/tree/tree.obj "
                         "(default: the procedural textured scene)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain PyTorch versions)")
    ap.add_argument("--out", default=None,
                    help="directory for target.png, before.png, after.png")
    args = ap.parse_args(argv)
    from ..io.image import save_image
    from ..render.integrator import finalize_image
    scene, cfg = scene_and_config(args.root, device=args.device)
    light = torch.tensor(LIGHT, dtype=torch.float32, device=scene.device)

    def log(i, loss):
        if i % 20 == 0 or i == STEPS - 1:
            print(f"step {i:3d}  loss {loss:.6f}", flush=True)

    grey = torch.full_like(scene.tex_data, 0.5)
    with torch.no_grad():
        before, _ = masked_render(scene, cfg, light, grey)
    tex, _losses, target, hit = fit(scene, cfg, light, STEPS, log=log)
    with torch.no_grad():
        after, _ = masked_render(scene, cfg, light, tex)
    err0 = float(((before - target) ** 2).mean())
    err1 = float(((after - target) ** 2).mean())
    print(f"image MSE: before {err0:.6f} -> after {err1:.6f} "
          f"({err0 / max(err1, 1e-12):.0f}x lower)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name, rad in (("target", target), ("before", before),
                          ("after", after)):
            save_image(os.path.join(args.out, name + ".png"),
                       finalize_image(rad, hit, cfg).cpu().numpy())
    return 0 if err1 < err0 * 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
