"""Scene catalog: the reference's five scenes, parameterized.

A numpy copy of the JAX package's ``scene/catalog.py`` on the port's
SceneManager and transforms.  The reference selects scenes by commenting
code blocks in `main()` in or out (simple_raytracer.cpp:553-769).  Each
function here reproduces one block's geometry, colors, materials and camera
exactly (constants cited).  ``bake_view`` picks between the reference's
strategy (multiply inverse(viewMatrix) into all geometry + light per frame —
simple_raytracer.cpp:558,778 — forcing per-frame host rebuilds) and the
world-space strategy (geometry static, the camera's rays moved per frame by
``render_radiance(..., view_matrix=V)``; the BVH is built ONCE for the whole
sweep).

The scene functions return (scene_manager, view_matrix [4,4] np, light [3]
np).  In bake mode the returned light is already view-space and
view_matrix is None; in world mode pass the view matrix to
render(..., view_matrix=V).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import transforms as T
from .scene import SceneManager

LIGHT_WORLD = np.array([500.0, -300.0, -200.0], np.float32)   # :776


def _rad(deg: float) -> float:
    return float(np.radians(deg))


def orbit_view(angle_deg: float, radius: float, y: float, pitch_deg: float,
               yaw_offset_deg: float = 90.0) -> np.ndarray:
    """Turntable camera (simple_raytracer.cpp:546-551): position on a circle
    of ``radius`` at height ``y``, rotation (pitch, angle+yaw_offset, 0)."""
    rad = _rad(angle_deg)
    pos = (radius * np.cos(rad), y, radius * np.sin(rad))
    return T.view_matrix(pos, (_rad(pitch_deg), _rad(angle_deg + yaw_offset_deg), 0.0))


def _finalize(sm: SceneManager, view: Optional[np.ndarray], bake_view: bool,
              transform_light: bool = True):
    """Apply the inverse-view bake (reference mode) or return the view for
    ray-space transformation (world mode)."""
    if view is None:
        return sm, None, LIGHT_WORLD.copy()
    if bake_view:
        inv = np.linalg.inv(view).astype(np.float32)
        for key in list(sm.objects.keys()):
            sm.transform_triangles(key, inv)
        if transform_light:
            light_h = inv @ np.array([*LIGHT_WORLD, 1.0], np.float32)  # :778
            return sm, None, light_h[:3]
        return sm, None, LIGHT_WORLD.copy()
    return sm, view, LIGHT_WORLD.copy()


def complex_scene(root: str, angle_deg: float = 0.0, bake_view: bool = True):
    """The ACTIVE scene (simple_raytracer.cpp:553-618): green ground cube,
    2 cats (cat.obj is not committed upstream -> empty meshes, soft-fail),
    white Stanford bunny, 3 oak trees.  Camera orbit r=50, y=-50, pitch 30."""
    sm = SceneManager(root=root)
    view = orbit_view(angle_deg, radius=50.0, y=-50.0, pitch_deg=30.0)

    cube = sm.load_obj_file(os.path.join(root, "obj/cube.obj"), key="ground")
    sm.set_color(cube, (0.0, 1.0, 0.0))                              # :564
    sm.transform_triangles(cube, T.scale(35.0, 35.0, 35.0))          # :565
    sm.transform_triangles(cube, T.translate((0.0, 10.0, 0.0)))      # :566

    cat = sm.load_obj_file(os.path.join(root, "obj/cat/cat.obj"), key="cat0")
    sm.set_properties(cat, specular=0.0)                             # :572
    cat1 = sm.instance(cat, "cat1")                                  # :573-574
    for key, yaw, pos in ((cat, 125.0, (25.0, -25.0, -14.0)),        # :576-580
                          (cat1, 70.0, (25.0, -25.0, 8.0))):         # :583-587
        sm.transform_triangles(key, T.scale(0.35, 0.35, 0.35))
        sm.transform_triangles(key, T.rotate_x(_rad(-90.0)))
        sm.transform_triangles(key, T.rotate_y(_rad(yaw)))
        sm.transform_triangles(key, T.translate(pos))

    bunny = sm.load_obj_file(
        os.path.join(root, "obj/stanford-bunny.obj"), key="bunny")
    sm.set_color(bunny, (0.9, 0.9, 0.9))                             # :591
    sm.transform_triangles(bunny, T.scale(50.0, 50.0, 50.0))         # :592
    sm.transform_triangles(bunny, T.rotate_x(_rad(181.0)))           # :593
    sm.transform_triangles(bunny, T.rotate_y(_rad(90.0)))            # :594
    sm.transform_triangles(bunny, T.translate((25.0, -23.0, 0.0)))   # :596

    tree = sm.load_obj_file(os.path.join(root, "obj/tree/tree.obj"), key="tree0")
    sm.set_properties(tree, specular=0.0)                            # :602
    tree1 = sm.instance(tree, "tree1")                               # :604-605
    tree2 = sm.instance(tree, "tree2")                               # :606-607
    for key, s, pos in ((tree, 0.03, (-6.0, -25.0, -25.0)),          # :609-612
                        (tree1, 0.035, (-6.0, -25.0, 0.0)),          # :614-617
                        (tree2, 0.03, (-6.0, -25.0, 25.0))):         # :619-622
        sm.transform_triangles(key, T.scale(s, s, s))
        sm.transform_triangles(key, T.rotate_x(_rad(-90.0)))
        sm.transform_triangles(key, T.translate(pos))

    return _finalize(sm, view, bake_view)


def six_spheres(root: str, angle_deg: float = 0.0, bake_view: bool = True):
    """Commented scene 1 (simple_raytracer.cpp:622-673): 6 spheres, STATIC
    camera at the origin (no view matrix, light untransformed)."""
    sm = SceneManager(root=root)
    s0 = sm.load_obj_file(os.path.join(root, "sphere.obj"), key="sphere0")
    sm.transform_triangles(s0, T.translate((0.0, 6.0, 30.0)))        # :640
    offsets = [(6.0, 0.0, 0.0), (-6.0, 0.0, 0.0), (0.0, -12.0, 0.0),
               (6.0, -12.0, 0.0), (-6.0, -12.0, 0.0)]                # :645-665
    for k, off in enumerate(offsets):
        key = sm.instance(s0, f"sphere{k + 1}")
        sm.set_color(key, (1.0, 0.0, 0.0))                           # :645
        sm.transform_triangles(key, T.translate(off))
    return _finalize(sm, None, bake_view)


def big_cat(root: str, angle_deg: float = 0.0, bake_view: bool = True):
    """Commented scene 2 (simple_raytracer.cpp:677-697): one cat at 0.5x,
    camera orbit r=50, y=-50, pitch 30."""
    sm = SceneManager(root=root)
    view = orbit_view(angle_deg, radius=50.0, y=-50.0, pitch_deg=30.0)
    cat = sm.load_obj_file(os.path.join(root, "obj/cat/cat.obj"), key="cat")
    sm.set_properties(cat, specular=0.0)                             # :690
    sm.transform_triangles(cat, T.scale(0.5, 0.5, 0.5))              # :691
    sm.transform_triangles(cat, T.rotate_x(_rad(-90.0)))             # :692
    sm.transform_triangles(cat, T.translate((14.0, -20.0, -8.0)))    # :695
    return _finalize(sm, view, bake_view)


def one_cube(root: str, angle_deg: float = 0.0, bake_view: bool = True):
    """Commented scene 3 (simple_raytracer.cpp:703-722): default-red cube at
    20x rotated 25 deg; camera orbit r=100, y=0, pitch 0."""
    sm = SceneManager(root=root)
    view = orbit_view(angle_deg, radius=100.0, y=0.0, pitch_deg=0.0)
    cube = sm.load_obj_file(os.path.join(root, "cube.obj"), key="cube")
    sm.transform_triangles(cube, T.scale(20.0, 20.0, 20.0))          # :715
    sm.transform_triangles(cube, T.rotate_y(_rad(25.0)))             # :716
    return _finalize(sm, view, bake_view)


def four_cubes(root: str, angle_deg: float = 0.0, bake_view: bool = True):
    """Commented scene 4 (simple_raytracer.cpp:726-769): 4 colored cubes;
    camera orbit r=100, y=0, pitch 0."""
    sm = SceneManager(root=root)
    view = orbit_view(angle_deg, radius=100.0, y=0.0, pitch_deg=0.0)
    c0 = sm.load_obj_file(os.path.join(root, "cube.obj"), key="cube0")
    sm.set_color(c0, (1.0, 1.0, 0.0))                                # :738
    sm.transform_triangles(c0, T.scale(10.0, 10.0, 10.0))            # :739
    placements = [((1.0, 0.0, 1.0), (0.0, -15.0, -15.0)),            # :742-744
                  ((1.0, 0.0, 0.0), (0.0, -15.0, 15.0)),             # :746-748
                  ((0.0, 1.0, 0.0), (0.0, 15.0, 15.0))]              # :750-752
    for k, (color, pos) in enumerate(placements):
        key = sm.instance(c0, f"cube{k + 1}")
        sm.set_color(key, color)
        sm.transform_triangles(key, T.translate(pos))
    sm.transform_triangles(c0, T.translate((0.0, 15.0, -15.0)))      # :755
    return _finalize(sm, view, bake_view)


CATALOG = {
    "complex": complex_scene,
    "six_spheres": six_spheres,
    "big_cat": big_cat,
    "one_cube": one_cube,
    "four_cubes": four_cubes,
}
