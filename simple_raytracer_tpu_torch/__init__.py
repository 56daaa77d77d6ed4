"""simple_raytracer_tpu_torch — the raytracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``simple_raytracer_tpu`` (the reference it is held
against; it imports no JAX).  It renders every ``RenderConfig.mode``:
``"tiled"`` (flat, textured and smooth-normal frames with hard or soft
shadows, through the nearest-hit, any-hit and classification kernels in
``csrc/``, whose plain PyTorch versions serve CPU tensors), and
``"bruteforce"`` and ``"bvh"`` in plain PyTorch, as the JAX package runs
them in jnp.  Every mode is differentiable (``render_radiance_diff``: the
intersector's winners under ``no_grad``, autograd through Möller–Trumbore at
them), and ``make_train_step`` fits scene parameters to a target image.
``dist/`` shards rays, frames and triangles over processes, one per card
(``torch.distributed``).
``python -m simple_raytracer_tpu_torch render|animate|train`` is its command
line (cli.py); every entry point runs on the card unless the caller asks for
the CPU.
"""

from .config import (AnimationConfig, BVHConfig, CameraConfig, KernelConfig,
                     LightConfig, RenderConfig, ShadingConfig, default_config)
from .scene.scene import Scene, SceneManager
from .render.renderer import render, render_radiance
from .diff.render import render_radiance_diff
from .dist.train import (DiffParams, apply_params, extract_params,
                         make_train_step)

__all__ = [
    "AnimationConfig", "BVHConfig", "CameraConfig", "KernelConfig",
    "LightConfig", "RenderConfig", "ShadingConfig", "default_config",
    "Scene", "SceneManager", "render", "render_radiance",
    "render_radiance_diff", "DiffParams", "make_train_step",
    "extract_params", "apply_params",
]
