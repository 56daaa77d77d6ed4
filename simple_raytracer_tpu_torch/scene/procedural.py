"""Procedural meshes and scenes built in numpy.

The repository's tests and ``chip_smoke.py`` cannot rely on OBJ assets, so
the scenes they render are generated here: a displaced icosphere (the
stand-in for the 69,451-triangle Stanford bunny of ``bench.py``), a
12-triangle box used as the ground slab, the bench-like scene that
combines them, a dense two-sphere scene, smooth-normal and textured
variants of the bench-like scene, and a dense textured stand-in for the
reference's complex scene.  Each mesh is a :class:`MeshData`, so the
same triangles can be handed to any ``SceneManager.set_triangles``.
"""

from __future__ import annotations

import math

import numpy as np

from . import transforms as T
from .obj_loader import MeshData


def mesh_from_triangles(tris: np.ndarray) -> MeshData:
    """[T, 3, 3] Cartesian triangles -> an untextured :class:`MeshData`
    (homogeneous w = 1, zero vertex normals and UVs, white vertex color:
    the loader's defaults for an OBJ without normals or textures)."""
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    verts = np.ones((n, 3, 4), np.float32)
    verts[..., :3] = tris
    return MeshData(verts=verts,
                    normals=np.zeros((n, 3, 3), np.float32),
                    uvs=np.zeros((n, 3, 2), np.float32),
                    tri_color=np.ones((n, 3), np.float32),
                    tri_tex=np.full((n,), -1, np.int32),
                    textures=[])


def obj_text(mesh: MeshData) -> str:
    """``mesh``'s triangles as Wavefront OBJ text: three ``v`` lines per
    triangle (the w-divided vertices, each f32 written exactly) and one
    ``f`` line, so that loading it gives back the same triangles.  Stands
    in for an asset file of the reference's layout."""
    v = mesh.verts[..., :3] / mesh.verts[..., 3:4]
    lines = [f"v {float(x)!r} {float(y)!r} {float(z)!r}"
             for x, y, z in v.reshape(-1, 3)]
    lines += [f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}"
              for k in range(v.shape[0])]
    return "\n".join(lines) + "\n"


def icosphere(subdivisions: int, displacement: float = 0.0,
              seed: int = 0) -> MeshData:
    """Unit icosphere with 20 * 4**subdivisions triangles, outward winding.

    ``displacement`` > 0 pushes each vertex radially by a smooth field of
    three random low-frequency sine waves (phases and axes drawn from
    ``seed``), so the surface is bumpy like a scanned mesh but every
    shared vertex moves the same way and the mesh stays watertight.
    """
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    verts = [tuple(p) for p in v]
    for _ in range(subdivisions):
        cache = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                p = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                verts.append(tuple(p / np.linalg.norm(p)))
                cache[key] = len(verts) - 1
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = np.array(nf, np.int64)
    p = np.asarray(verts, np.float64)
    if displacement:
        rng = np.random.default_rng(seed)
        axes = rng.normal(size=(3, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        freq = rng.uniform(2.0, 5.0, size=3)
        phase = rng.uniform(0.0, 2.0 * math.pi, size=3)
        bump = np.sin(p @ axes.T * freq + phase).sum(axis=1) / 3.0
        p = p * (1.0 + displacement * bump)[:, None]
    return mesh_from_triangles(p[f])


def box() -> MeshData:
    """The cube [-1, 1]^3 as 12 triangles with outward winding."""
    c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                 np.float64)
    # corner index = 4*ix + 2*iy + iz; two triangles per face
    quads = [(0, 1, 3, 2), (4, 6, 7, 5),      # x = -1, x = +1
             (0, 4, 5, 1), (2, 3, 7, 6),      # y = -1, y = +1
             (0, 2, 6, 4), (1, 5, 7, 3)]      # z = -1, z = +1
    tris = []
    for a, b, cc, d in quads:
        tris += [[a, b, cc], [a, cc, d]]
    return mesh_from_triangles(c[np.asarray(tris)])


# The bench scene (bench.py:299-313): a mesh of bunny scale at z = 60 above a
# ground slab, the light at (500, -300, -200), focal 6000 * H / 1080.
BENCH_LIGHT = (500.0, -300.0, -200.0)
GROUND_POSE = T.translate((0.0, 9.0, 60.0)) @ T.scale(30.0, 2.0, 30.0)
# Off the camera axes: a sphere centred on them is cut by rays that run
# exactly along shared icosphere edges (pixel row/column 0), where the two
# sides of an edge tie and the winner flips between implementations.
SPHERE_POSE = (T.translate((0.3, 0.2, 60.0)) @ T.rotate_y(math.radians(17.0))
               @ T.rotate_x(math.radians(11.0)) @ T.scale(4.0, 4.0, 4.0))


def bench_focal(height: int) -> float:
    """The bench's focal length: 6000 pixels at 1080 rows (bench.py:317)."""
    return 6000.0 * height / 1080.0


def sphere_on_ground(manager, subdivisions: int, pose=SPHERE_POSE,
                     displacement: float = 0.08, seed: int = 0):
    """Add the displaced icosphere ("sphere") and the ground box ("ground")
    to ``manager`` (a SceneManager), posed and colored like the bench's
    bunny and ground (bench.py:301, :310).  Returns the manager."""
    sphere = icosphere(subdivisions, displacement, seed)
    sphere.verts = T.apply_transform(pose, sphere.verts)
    ground = box()
    ground.verts = T.apply_transform(GROUND_POSE, ground.verts)
    manager.set_triangles("sphere", sphere)
    manager.set_color("sphere", (0.8, 0.7, 0.6))
    manager.set_triangles("ground", ground)
    manager.set_color("ground", (0.0, 1.0, 0.0))
    return manager


# The dense scene's second sphere: right of and before the first, its shadow
# on the near ground around (-1, 7, 43), in view at 600x400 with focal 400
# (the first sphere's falls near (-11, 7, 66)).
SPHERE2_POSE = (T.translate((12.0, -1.0, 36.0)) @ T.rotate_y(math.radians(-23.0))
                @ T.rotate_x(math.radians(7.0)) @ T.scale(5.0, 5.0, 5.0))


def dense_on_ground(manager, subdivisions: int = 6):
    """A scene over 131,072 triangles: two displaced icospheres of
    ``subdivisions`` (6: 2 x 81,920 triangles) on the ground box, lit from
    BENCH_LIGHT, each casting a shadow in view at 600x400, focal 400.
    Scenes this dense take 32-pixel tiles, 256-ray shadow tiles and the
    1,024-wide plan (kernels/plan.py).  Returns the manager."""
    sphere_on_ground(manager, subdivisions)
    second = icosphere(subdivisions, 0.08, seed=1)
    second.verts = T.apply_transform(SPHERE2_POSE, second.verts)
    manager.set_triangles("sphere2", second)
    manager.set_color("sphere2", (0.6, 0.6, 0.9))
    return manager


CHECKER = 128           # texels per side of the textured ground's checker
CHECKER_SQUARE = 8      # texels per checker square
TEXELS_PER_UNIT = 2.0   # texel-space UV scale of the textured ground


def checker_texture():
    """[CHECKER, CHECKER, 3] uint8: a two-tone checker of CHECKER_SQUARE-
    texel squares (light grey and dark green)."""
    ij = np.arange(CHECKER) // CHECKER_SQUARE
    odd = (ij[:, None] + ij[None, :]) % 2 == 1
    return np.where(odd[..., None], np.array([40, 120, 40], np.uint8),
                    np.array([230, 230, 220], np.uint8)).astype(np.uint8)


def smooth_on_ground(manager, subdivisions: int):
    """:func:`sphere_on_ground` with real vertex normals: the displaced
    icosphere's are the radial directions from its centre (close enough to
    the surface normal of a mildly displaced sphere), the ground box's are
    each face's normal.  ``smooth_normal`` of all-zero normals is NaN, so a
    scene shaded with smooth normals needs these.  Returns the manager."""
    sphere_on_ground(manager, subdivisions)
    sphere = manager.objects["sphere"].mesh
    centre = (SPHERE_POSE @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
    r = sphere.verts[..., :3].astype(np.float64) - centre
    sphere.normals = (r / np.linalg.norm(r, axis=-1, keepdims=True)
                      ).astype(np.float32)
    ground = manager.objects["ground"].mesh
    g = ground.verts[..., :3].astype(np.float64)                # [12, 3, 3]
    n = np.cross(g[:, 1] - g[:, 0], g[:, 2] - g[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ground.normals = np.repeat(n[:, None], 3, axis=1).astype(np.float32)
    return manager


def _checker_ground(manager) -> None:
    """Texture the ground box with a :func:`checker_texture` installed as
    ``manager.textures.data["checker"]``, through texel-space UVs of
    TEXELS_PER_UNIT texels per world unit along the two axes of each face's
    plane."""
    ground = manager.objects["ground"].mesh
    g = ground.verts[..., :3].astype(np.float64)                # [12, 3, 3]
    n = np.cross(g[:, 1] - g[:, 0], g[:, 2] - g[:, 0])
    axis = np.abs(n).argmax(axis=-1)                            # face axis
    lo = g.reshape(-1, 3).min(axis=0)
    uv = np.zeros(g.shape[:2] + (2,))
    for k, a in enumerate(axis):
        b, c = [x for x in range(3) if x != a]
        uv[k] = (g[k][:, [b, c]] - lo[[b, c]]) * TEXELS_PER_UNIT
    ground.uvs = uv.astype(np.float32)
    ground.tri_tex = np.zeros(ground.num_triangles, np.int32)
    ground.textures = ["checker"]
    manager.textures.data["checker"] = checker_texture()


def textured_on_ground(manager, subdivisions: int):
    """:func:`smooth_on_ground` with a textured ground: the ground samples
    a checker through texel-space UVs (:func:`_checker_ground`).  Returns
    the manager."""
    smooth_on_ground(manager, subdivisions)
    _checker_ground(manager)
    return manager


def spherical_uvs(points: np.ndarray, size: int) -> np.ndarray:
    """Texel-space UVs [T, 3, 2] of triangles ``points`` [T, 3, 3] on a
    sphere about the origin: longitude and colatitude, scaled to ``size``
    texels.  A triangle that straddles the longitude seam has its small
    longitudes moved up by one turn, so it spans no more than itself
    (texture_fetch clamps the overhang to the texture's last column)."""
    p = points / np.linalg.norm(points, axis=-1, keepdims=True)
    u = 0.5 + np.arctan2(p[..., 2], p[..., 0]) / (2.0 * math.pi)
    v = np.arccos(np.clip(p[..., 1], -1.0, 1.0)) / math.pi
    seam = u.max(axis=1, keepdims=True) - u.min(axis=1, keepdims=True) > 0.5
    u = np.where(seam & (u < 0.5), u + 1.0, u)
    return (np.stack([u, v], axis=-1) * size).astype(np.float32)


def dense_textured_on_ground(manager, subdivisions: int = 6):
    """A stand-in for the reference's complex scene (a ground cube, two
    cats, the bunny and three textured trees: about 125k triangles, 123,463
    without the cats, whose OBJ file was never committed): the two spheres
    of :func:`dense_on_ground` (2 x 81,920 triangles at ``subdivisions``
    6, over 131,072 in all) on the checker ground of
    :func:`textured_on_ground`, the second sphere textured with the same
    checker through :func:`spherical_uvs`, so a frame hits thousands of
    small textured triangles as the trees' are.  Flat shading: the vertex
    normals stay zero.  Returns the manager."""
    dense_on_ground(manager, subdivisions)
    _checker_ground(manager)
    second = manager.objects["sphere2"].mesh
    centre = (SPHERE2_POSE @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
    second.uvs = spherical_uvs(second.verts[..., :3].astype(np.float64)
                               - centre, CHECKER)
    second.tri_tex = np.zeros(second.num_triangles, np.int32)
    second.textures = ["checker"]
    return manager
