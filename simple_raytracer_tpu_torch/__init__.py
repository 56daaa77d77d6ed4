"""simple_raytracer_tpu_torch — the raytracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``simple_raytracer_tpu`` (the reference it is held
against; it imports no JAX).  So far it renders ``mode="tiled"``: flat,
textured and smooth-normal frames with hard or soft shadows, through the
nearest-hit, any-hit and classification kernels in ``csrc/``.  Their plain
PyTorch versions serve CPU tensors.
"""

from .config import (AnimationConfig, BVHConfig, CameraConfig, KernelConfig,
                     LightConfig, RenderConfig, ShadingConfig, default_config)
from .scene.scene import Scene, SceneManager
from .render.renderer import render, render_radiance

__all__ = [
    "AnimationConfig", "BVHConfig", "CameraConfig", "KernelConfig",
    "LightConfig", "RenderConfig", "ShadingConfig", "default_config",
    "Scene", "SceneManager", "render", "render_radiance",
]
