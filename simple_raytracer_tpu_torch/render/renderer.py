"""Renderer front end.

Counterpart of the JAX package's ``render/renderer.py``.  Only
``mode="tiled"`` is ported: per-tile cull plans and the hand-written CUDA
kernels (kernels/tiled.py).  The JAX package's 'bruteforce' and 'bvh'
modes raise NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..accel.prepared import PreparedScene, prepare
from ..config import RenderConfig
from ..ops.camera import primary_rays_tiled, untile_image
from ..kernels import plan as pl
from ..kernels.tiled import frame_branch, render_flat_tiled
from . import integrator

_MODE_ITEMS = {"bruteforce": "bruteforce mode", "bvh": "BVH mode"}


def ensure_prepared(scene, cfg: RenderConfig, device="cuda") -> PreparedScene:
    """Host step: prepare a Scene onto ``device`` (raises without a CUDA
    device unless ``device`` is "cpu"); a PreparedScene stays as it is, on
    the device it is on."""
    if isinstance(scene, PreparedScene):
        return scene
    return prepare(scene, cfg, device=device)


def render(scene, cfg: RenderConfig, light_pos, view_matrix=None,
           device="cuda") -> torch.Tensor:
    """Full-frame render -> [H, W, 3] uint8 (background-filled, quantized).
    Accepts a Scene (prepared here onto ``device``: the card unless the
    caller asks for "cpu") or a PreparedScene (rendered on its device)."""
    prep = ensure_prepared(scene, cfg, device)
    radiance, hit = render_radiance(prep, cfg, light_pos, view_matrix)
    return integrator.finalize_image(radiance, hit, cfg)


def render_radiance(prep: PreparedScene, cfg: RenderConfig, light_pos,
                    view_matrix=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float render -> (radiance [H, W, 3] in [0,1], hit [H, W]) on the
    device of ``prep``.

    With ``view_matrix`` (4x4, Transformation.cpp:84-90 convention) the
    camera moves in world space and the scene stays static: rays start at
    V[:3, 3] with directions V[:3, :3] @ (i, j, focal)."""
    if cfg.mode != "tiled":
        if cfg.mode in _MODE_ITEMS:
            raise NotImplementedError(
                f"mode {cfg.mode!r} is not ported yet (ROADMAP.md, Open "
                f"items §1: {_MODE_ITEMS[cfg.mode]})")
        raise ValueError(f"unknown render mode: {cfg.mode}")
    if not isinstance(prep, PreparedScene):
        raise TypeError("mode 'tiled' needs a PreparedScene; call "
                        "accel.prepared.prepare(scene, cfg) (or render()) "
                        "first")
    cam = cfg.camera
    dev = prep.device
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    light = torch.as_tensor(light_pos, dtype=torch.float32, device=dev)
    vm = None if view_matrix is None else torch.as_tensor(
        view_matrix, dtype=torch.float32, device=dev)
    rays = None
    if frame_branch(prep, cfg, tpx * tpx) != "fused":
        # every branch but the fused one starts from these rays
        o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx,
                                        cam.focal, view_matrix=vm,
                                        device=dev)
        rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    rad, hit = render_flat_tiled(prep, cfg, light,
                                 (vm, cam.focal, cam.width, cam.height, tpx),
                                 rays=rays)
    tx, ty = -(-cam.width // tpx), -(-cam.height // tpx)
    return (untile_image(rad, cam.width, cam.height, tpx, tx, ty),
            untile_image(hit, cam.width, cam.height, tpx, tx, ty))
