"""Two displaced icospheres on the checker-textured ground box, the second
sphere textured too, flat shading: a frozen copy of the program's
``scene/procedural.py::dense_textured_on_ground``, equal triangle for
triangle, with the same UVs and textures."""

from __future__ import annotations

import math

import numpy as np

from . import procedural as P

# the second sphere: right of and before the first, its shadow on the near
# ground in view at 600x400, focal 400
SPHERE2_POSE = (P.translate((12.0, -1.0, 36.0))
                @ P.rotate_y(math.radians(-23.0))
                @ P.rotate_x(math.radians(7.0)) @ P.scale(5.0, 5.0, 5.0))
SPHERE2_COLOR = (0.6, 0.6, 0.9)


def spherical_uvs(points: np.ndarray, size: int) -> np.ndarray:
    """Texel-space UVs [T, 3, 2] of triangles ``points`` [T, 3, 3] on a
    sphere about the origin: longitude and colatitude, scaled to ``size``
    texels; a triangle across the longitude seam has its small longitudes
    moved up by one turn."""
    p = points / np.linalg.norm(points, axis=-1, keepdims=True)
    u = 0.5 + np.arctan2(p[..., 2], p[..., 0]) / (2.0 * math.pi)
    v = np.arccos(np.clip(p[..., 1], -1.0, 1.0)) / math.pi
    seam = u.max(axis=1, keepdims=True) - u.min(axis=1, keepdims=True) > 0.5
    u = np.where(seam & (u < 0.5), u + 1.0, u)
    return (np.stack([u, v], axis=-1) * size).astype(np.float32)


def dense_textured_on_ground(subdivisions: int) -> P.SceneArrays:
    """"sphere" (the displaced icosphere of ``subdivisions``), "ground" (the
    box, the checker through texel-space UVs) and "sphere2" (a second
    displaced icosphere, drawn with seed 1, the checker through spherical
    UVs): 2 x 81,920 + 12 = 163,852 triangles at 6 subdivisions.  Every
    vertex normal is zero, as in an OBJ file without normals."""
    scene = P.textured_on_ground(subdivisions)
    for obj in scene.objects:
        obj.mesh.normals = np.zeros_like(obj.mesh.normals)
    second = P.icosphere(subdivisions, 0.08, seed=1)
    second.verts = P.apply_transform(SPHERE2_POSE, second.verts)
    centre = (SPHERE2_POSE @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
    second.uvs = spherical_uvs(second.verts[..., :3].astype(np.float64)
                               - centre, P.CHECKER)
    second.texture = "checker"
    scene.objects.append(P.Object("sphere2", second, SPHERE2_COLOR))
    return scene


def build(config: dict, seed: int) -> P.SceneArrays:
    """The same scene for every seed, so every seed does the same work."""
    return dense_textured_on_ground(int(config["subdivisions"]))
