"""Procedural meshes of the benchmark's scenes, in numpy.

A frozen copy of the port's ``scene/procedural.py`` and of the transforms it
uses, so that a later change to the port cannot move the scenes the
benchmark measures.  The icosphere is subdivided with array operations;
every midpoint is the same float64 expression as the port's loop, so the
triangles are equal to the port's.

A scene is a :class:`SceneArrays`: objects of triangles with their
materials, and the textures.  ``rtbench/scenes/port.py`` hands one to the
program; ``rtbench/reference/`` renders it without the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

# the reference's default material (Object.cpp:29-34)
DEFAULT_AMBIENT, DEFAULT_SPECULAR, DEFAULT_SHININESS = 0.2, 0.5, 15.0


@dataclasses.dataclass
class Mesh:
    """One object's triangles: homogeneous vertices [T, 3, 4] f32 (w = 1),
    vertex normals [T, 3, 3], texel-space UVs [T, 3, 2], and a texture name
    (or None) for every triangle of the object."""

    verts: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    texture: Optional[str] = None

    @property
    def num_triangles(self) -> int:
        return int(self.verts.shape[0])


@dataclasses.dataclass
class Object:
    name: str
    mesh: Mesh
    color: tuple
    ambient: float = DEFAULT_AMBIENT
    specular: float = DEFAULT_SPECULAR
    shininess: float = DEFAULT_SHININESS


@dataclasses.dataclass
class SceneArrays:
    """Objects in order (object id = position) and textures by name."""

    objects: List[Object]
    textures: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_triangles(self) -> int:
        return sum(o.mesh.num_triangles for o in self.objects)


# -- transforms (Transformation.cpp; GLM's column-major layout) --------------

def translate(position) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0:3, 3] = np.asarray(position, dtype=np.float32)
    return m


def scale(sx: float, sy: float, sz: float) -> np.ndarray:
    return np.diag(np.array([sx, sy, sz, 1.0], np.float32))


def rotate_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, s, -s, c
    return m


def rotate_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def apply_transform(matrix: np.ndarray, verts_h: np.ndarray) -> np.ndarray:
    return np.einsum("ij,...j->...i", matrix.astype(verts_h.dtype), verts_h)


# -- meshes -------------------------------------------------------------------

def mesh_from_triangles(tris: np.ndarray) -> Mesh:
    """[T, 3, 3] Cartesian triangles -> an untextured :class:`Mesh` with
    zero normals and UVs (an OBJ file without normals or textures)."""
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    verts = np.ones((n, 3, 4), np.float32)
    verts[..., :3] = tris
    return Mesh(verts, np.zeros((n, 3, 3), np.float32),
                np.zeros((n, 3, 2), np.float32))


_ICO_FACES = np.array(
    [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
     [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
     [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
     [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

def icosphere(subdivisions: int, displacement: float = 0.0,
              seed: int = 0) -> Mesh:
    """Unit icosphere of 20 * 4**subdivisions triangles, outward winding,
    pushed radially by ``displacement`` times a smooth field of three sine
    waves (axes, frequencies and phases drawn from ``seed``), so the mesh
    stays watertight."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    p = v / np.linalg.norm(v, axis=1, keepdims=True)
    f = _ICO_FACES
    for _ in range(subdivisions):
        # each edge once, in the order the port's loop meets it
        edges = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]],
                         axis=1).reshape(-1, 2)
        key = np.sort(edges, axis=1)
        _, first, inverse = np.unique(key[:, 0] * len(p) + key[:, 1],
                                      return_index=True,
                                      return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        a, b = edges[first[order], 0], edges[first[order], 1]
        m = (p[a] + p[b]) / 2.0
        m = m / np.linalg.norm(m, axis=1, keepdims=True)
        mid = (len(p) + rank[inverse.reshape(-1)]).reshape(-1, 3)
        p = np.concatenate([p, m])
        ab, bc, ca = mid[:, 0], mid[:, 1], mid[:, 2]
        f = np.stack([np.stack([f[:, 0], ab, ca], 1),
                      np.stack([f[:, 1], bc, ab], 1),
                      np.stack([f[:, 2], ca, bc], 1),
                      np.stack([ab, bc, ca], 1)], axis=1).reshape(-1, 3)
    if displacement:
        rng = np.random.default_rng(seed)
        axes = rng.normal(size=(3, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        freq = rng.uniform(2.0, 5.0, size=3)
        phase = rng.uniform(0.0, 2.0 * math.pi, size=3)
        bump = np.sin(p @ axes.T * freq + phase).sum(axis=1) / 3.0
        p = p * (1.0 + displacement * bump)[:, None]
    return mesh_from_triangles(p[f])


def box() -> Mesh:
    """The cube [-1, 1]^3 as 12 triangles with outward winding."""
    c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float64)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, cc, d in quads:
        tris += [[a, b, cc], [a, cc, d]]
    return mesh_from_triangles(c[np.asarray(tris)])


# -- the bench scene (bench.py:299-313) ---------------------------------------

BENCH_LIGHT = (500.0, -300.0, -200.0)
GROUND_POSE = translate((0.0, 9.0, 60.0)) @ scale(30.0, 2.0, 30.0)
SPHERE_CENTRE = (0.3, 0.2, 60.0)
SPHERE_POSE = (translate(SPHERE_CENTRE) @ rotate_y(math.radians(17.0))
               @ rotate_x(math.radians(11.0)) @ scale(4.0, 4.0, 4.0))
SPHERE_COLOR, GROUND_COLOR = (0.8, 0.7, 0.6), (0.0, 1.0, 0.0)
CHECKER, CHECKER_SQUARE, TEXELS_PER_UNIT = 128, 8, 2.0


def sphere_on_ground(subdivisions: int,
                     displacement: float = 0.08) -> SceneArrays:
    """The displaced icosphere ("sphere", flat colour) on the ground box
    ("ground", green), posed like the bench's bunny and ground."""
    sphere = icosphere(subdivisions, displacement)
    sphere.verts = apply_transform(SPHERE_POSE, sphere.verts)
    ground = box()
    ground.verts = apply_transform(GROUND_POSE, ground.verts)
    return SceneArrays([Object("sphere", sphere, SPHERE_COLOR),
                        Object("ground", ground, GROUND_COLOR)])


def face_normals(verts: np.ndarray) -> np.ndarray:
    g = verts[..., :3].astype(np.float64)
    n = np.cross(g[:, 1] - g[:, 0], g[:, 2] - g[:, 0])
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def smooth_on_ground(subdivisions: int) -> SceneArrays:
    """:func:`sphere_on_ground` with vertex normals: the sphere's radial
    directions from its centre, each ground face's own normal."""
    scene = sphere_on_ground(subdivisions)
    sphere, ground = scene.objects[0].mesh, scene.objects[1].mesh
    centre = (SPHERE_POSE @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
    r = sphere.verts[..., :3].astype(np.float64) - centre
    sphere.normals = (r / np.linalg.norm(r, axis=-1, keepdims=True)
                      ).astype(np.float32)
    ground.normals = np.repeat(face_normals(ground.verts)[:, None], 3,
                               axis=1).astype(np.float32)
    return scene


def checker_texture() -> np.ndarray:
    """[CHECKER, CHECKER, 3] uint8: light grey and dark green squares of
    CHECKER_SQUARE texels."""
    ij = np.arange(CHECKER) // CHECKER_SQUARE
    odd = (ij[:, None] + ij[None, :]) % 2 == 1
    return np.where(odd[..., None], np.array([40, 120, 40], np.uint8),
                    np.array([230, 230, 220], np.uint8)).astype(np.uint8)


def textured_on_ground(subdivisions: int) -> SceneArrays:
    """:func:`smooth_on_ground` with the ground textured by the checker
    through texel-space UVs, TEXELS_PER_UNIT texels per world unit along
    the two axes of each face's plane."""
    scene = smooth_on_ground(subdivisions)
    ground = scene.objects[1].mesh
    g = ground.verts[..., :3].astype(np.float64)
    axis = np.abs(face_normals(ground.verts)).argmax(axis=-1)
    lo = g.reshape(-1, 3).min(axis=0)
    uv = np.zeros(g.shape[:2] + (2,))
    for k, a in enumerate(axis):
        b, c = [x for x in range(3) if x != a]
        uv[k] = (g[k][:, [b, c]] - lo[[b, c]]) * TEXELS_PER_UNIT
    ground.uvs = uv.astype(np.float32)
    ground.texture = "checker"
    scene.textures["checker"] = checker_texture()
    return scene
