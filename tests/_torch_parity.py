"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same triangles: the port's procedural meshes
(simple_raytracer_tpu_torch/scene/procedural.py) are installed in a JAX
SceneManager as well.  The parity scene is a displaced icosphere of
subdivision 3 (1,280 triangles) on the 12-triangle box ground, posed off the
camera axes, at 128x128 with focal 400: the sphere's shadow falls in view.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.scene import transforms as T

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.kernels import tiled as jtiled
from simple_raytracer_tpu.kernels import tiled_t
from simple_raytracer_tpu.ops.camera import primary_rays_tiled, untile_image
from simple_raytracer_tpu.render import integrator as jint
from simple_raytracer_tpu.scene import scene as jscene

WIDTH = HEIGHT = 128
FOCAL = 400.0
TILE_PX = 64
LIGHT = P.BENCH_LIGHT
# a camera off the scene's axes that sees the sphere and its shadow
VIEW = T.view_matrix((-8.0, -6.0, 15.0),
                     (math.radians(12.0), math.radians(-6.0), 0.0))


def managers(subdivisions: int = 3, textured: bool = False, build=None):
    """(port SceneManager, JAX SceneManager) holding the same objects: the
    parity scene, or with ``textured`` its textured, smooth-normal variant
    (procedural.textured_on_ground) with the same texture atlas, or the
    scene of ``build(manager, subdivisions)`` (a procedural scene
    function)."""
    if build is None:
        build = P.textured_on_ground if textured else P.sphere_on_ground
    sm = build(sr.SceneManager(), subdivisions)
    jsm = jscene.SceneManager()
    for key in sm._order:
        e = sm.objects[key]
        jsm.objects[key] = jscene._ObjectEntry(e.mesh.copy(), e.color,
                                               e.ambient, e.specular,
                                               e.shininess)
        jsm._order.append(key)
    jsm.textures.data.update(sm.textures.data)
    return sm, jsm


def configs(split: str = "sah", **light):
    """(port RenderConfig, JAX RenderConfig) of the parity frame."""
    cam = dict(width=WIDTH, height=HEIGHT, focal=FOCAL)
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(**cam),
        light=sr.LightConfig(**light), bvh=sr.BVHConfig(split=split))
    jcfg = jconfig.default_config().replace(
        mode="tiled", camera=jconfig.CameraConfig(**cam),
        light=jconfig.LightConfig(**light), bvh=jconfig.BVHConfig(split=split))
    return cfg, jcfg


def jax_frame(jprep, jcfg, view, monkeypatch,
              spied=("hits_shaded", "anyhit_from_t"), expect=None,
              tile_px: int = TILE_PX):
    """The JAX tiled frame of the parity camera (its image, uint8), asserting
    that of the ``spied`` steps of ``tiled_t`` exactly ``expect`` ran, in
    order (default: all of them, once each; the fused kernels by
    default).  ``tile_px`` is the tile of ``jcfg`` (``jcfg.tile_px``)."""
    called = []
    for name in spied:
        orig = getattr(tiled_t, name)
        monkeypatch.setattr(
            tiled_t, name,
            lambda *a, _o=orig, _n=name, **k: (called.append(_n),
                                               _o(*a, **k))[1])
    V = None if view is None else jnp.asarray(view, jnp.float32)
    o, d, tx, ty = primary_rays_tiled(WIDTH, HEIGHT, tile_px, FOCAL, False,
                                      view_matrix=V)
    rad, hit = jtiled.render_flat_tiled(
        jprep, jcfg, o.reshape(-1, 3), d.reshape(-1, 3), jnp.asarray(LIGHT),
        cam_spec=(V, FOCAL, WIDTH, HEIGHT, tile_px))
    assert called == list(spied if expect is None else expect), called
    rad = untile_image(rad.reshape(-1, 3), WIDTH, HEIGHT, tile_px, tx, ty)
    hit = untile_image(hit.reshape(-1), WIDTH, HEIGHT, tile_px, tx, ty)
    return np.asarray(jint.finalize_image(rad, hit, jcfg))


def jax_prepared_arrays(jprep) -> dict:
    """The JAX PreparedScene fields the port keeps, as numpy arrays."""
    out = {n: np.asarray(getattr(jprep.scene, n))
           for n in jscene.Scene._ARRAY_FIELDS}
    for n in ("block_min", "block_max", "block_obj", "node_min", "node_max",
              "skip", "leaf_first", "leaf_count"):
        out[n] = np.asarray(getattr(jprep, n))
    return out


def tilted_ground(manager, subdivisions: int):
    """The parity scene (procedural.sphere_on_ground) with its ground box
    turned 7 degrees about y and 3 about x around its centre, so no face
    of it is parallel to an axis.  On the axis-aligned box, the rays of
    the image's centre row and column lie in the planes of its faces
    (Möller–Trumbore's determinant is exactly 0): autograd through every
    ray-triangle pair (JAX's bruteforce training step, the port's
    ``render_radiance``) then multiplies a zero gradient by 1/0 and gives
    NaN.  Returns the manager."""
    P.sphere_on_ground(manager, subdivisions)
    c = (0.0, 9.0, 60.0)
    manager.transform_triangles(
        "ground", T.translate(c) @ T.rotate_y(math.radians(7.0))
        @ T.rotate_x(math.radians(3.0)) @ T.translate([-x for x in c]))
    return manager
