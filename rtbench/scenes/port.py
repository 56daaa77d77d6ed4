"""Hand a benchmark scene to the program under test through its public
``SceneManager``."""

from __future__ import annotations

import numpy as np

from .procedural import SceneArrays


def to_port(scene: SceneArrays):
    """The program's ``Scene`` of ``scene``: one object per entry, in
    order, with its material, and each texture registered by name."""
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.scene.obj_loader import MeshData
    sm = sr.SceneManager()
    for name, img in scene.textures.items():
        sm.textures.data[name] = img
    for obj in scene.objects:
        m = obj.mesh
        n = m.num_triangles
        textured = m.texture is not None
        sm.set_triangles(obj.name, MeshData(
            verts=m.verts, normals=m.normals, uvs=m.uvs,
            tri_color=np.ones((n, 3), np.float32),
            tri_tex=np.full((n,), 0 if textured else -1, np.int32),
            textures=[m.texture] if textured else []))
        sm.set_color(obj.name, obj.color)
        sm.set_properties(obj.name, obj.ambient, obj.specular, obj.shininess)
    return sm.build()
