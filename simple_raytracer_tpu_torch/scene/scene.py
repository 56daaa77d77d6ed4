"""Scene (SoA tensors) and the SceneManager builder API.

The reference keeps string-keyed maps of AoS ``vector<Triangle>`` per object
(ObjectManager, Object.h:59-89) and loops over objects per ray
(simple_raytracer.cpp:409).  Here ALL objects are concatenated into one global
SoA triangle soup with an object-id column, so one kernel intersects the whole
scene; the reference's "skip self object" shadow rule
(simple_raytracer.cpp:331) becomes a compare on the object id.

Textures of heterogeneous sizes are packed into one flat atlas with
per-texture (offset, width, height) tables.

Host math stays numpy: :meth:`SceneManager.build` and
``accel.prepared.prepare`` run on the host and wrap their finished arrays as
CPU tensors; one ``.to(device)`` moves the result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import transforms as T
from .obj_loader import (DEFAULT_AMBIENT, DEFAULT_COLOR, DEFAULT_SHININESS,
                         DEFAULT_SPECULAR, MeshData, TextureRegistry, load_obj)


@dataclasses.dataclass
class Scene:
    """The unit every renderer consumes.

    All triangle-indexed tensors are in GLOBAL order (objects concatenated).
    ``verts`` is homogeneous [T,3,4]; the reference stores vec4 vertices and
    divides by w inside Möller–Trumbore (simple_raytracer.cpp:45-47).
    """

    verts: torch.Tensor        # [T, 3, 4] f32
    vnormals: torch.Tensor     # [T, 3, 3] f32
    tri_normal: torch.Tensor   # [T, 3] f32 — precomputed flat geometric normal
    uvs: torch.Tensor          # [T, 3, 2] f32 (baked texel coords)
    tri_color: torch.Tensor    # [T, 3] f32
    tri_tex: torch.Tensor      # [T] i32 (global texture id, -1 = none)
    tri_obj: torch.Tensor      # [T] i32 (object id)
    obj_color: torch.Tensor    # [O, 3] f32
    obj_ambient: torch.Tensor  # [O] f32
    obj_specular: torch.Tensor # [O] f32
    obj_shininess: torch.Tensor# [O] f32
    tex_data: torch.Tensor     # [P, 3] f32 in [0,1] — flattened texture atlas
    tex_offset: torch.Tensor   # [K] i32 — start pixel of texture k in tex_data
    tex_width: torch.Tensor    # [K] i32
    tex_height: torch.Tensor   # [K] i32
    # True iff the atlas holds real textures (not the 1x1 dummy).
    has_textures: bool = False

    ARRAY_FIELDS = ("verts", "vnormals", "tri_normal", "uvs", "tri_color",
                    "tri_tex", "tri_obj", "obj_color", "obj_ambient",
                    "obj_specular", "obj_shininess", "tex_data",
                    "tex_offset", "tex_width", "tex_height")

    @property
    def num_triangles(self) -> int:
        return int(self.verts.shape[0])

    @property
    def num_objects(self) -> int:
        return int(self.obj_color.shape[0])

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def verts_cart(self) -> torch.Tensor:
        """Cartesian vertices [T, 3, 3]: the homogeneous divide of the
        reference's Möller–Trumbore prologue (simple_raytracer.cpp:45-47)."""
        return self.verts[..., :3] / self.verts[..., 3:4]

    def to(self, device) -> "Scene":
        return dataclasses.replace(self, **{
            n: getattr(self, n).to(device) for n in self.ARRAY_FIELDS})

    def numpy(self) -> Dict[str, np.ndarray]:
        """Every array field as a host numpy array."""
        return {n: getattr(self, n).detach().cpu().numpy()
                for n in self.ARRAY_FIELDS}


def scene_from_numpy(arrays: Dict[str, np.ndarray],
                     has_textures: bool) -> Scene:
    """Copy host arrays (the fields of :class:`Scene`) into CPU tensors."""
    return Scene(**{n: torch.from_numpy(np.array(arrays[n], order="C"))
                    for n in Scene.ARRAY_FIELDS},
                 has_textures=bool(has_textures))


def from_jax_arrays(arrays: Dict[str, np.ndarray],
                    has_textures: bool = False) -> Scene:
    """The JAX package's ``Scene`` fields, as numpy arrays keyed by field
    name, -> the port's :class:`Scene` (same names and layouts)."""
    dtypes = {"tri_tex": np.int32, "tri_obj": np.int32,
              "tex_offset": np.int32, "tex_width": np.int32,
              "tex_height": np.int32}
    return scene_from_numpy(
        {n: np.asarray(arrays[n], dtypes.get(n, np.float32))
         for n in Scene.ARRAY_FIELDS}, has_textures)


@dataclasses.dataclass
class _ObjectEntry:
    mesh: MeshData
    color: Tuple[float, float, float]
    ambient: float
    specular: float
    shininess: float


class SceneManager:
    """Mirror of the reference's ObjectManager (Object.h:59-89): string-keyed
    objects, per-object transforms, instancing by key copy, then a single
    :meth:`build` that concatenates everything into a :class:`Scene`."""

    def __init__(self, root: str = "."):
        self.textures = TextureRegistry(root=root)
        self.objects: Dict[str, _ObjectEntry] = {}
        self._order: List[str] = []   # deterministic (insertion) object order

    # -- loading / instancing -------------------------------------------------
    def load_obj_file(self, path: str, key: Optional[str] = None) -> str:
        """Object.cpp:25-170.  Missing files yield an empty mesh (soft failure)."""
        key = key or path
        mesh = load_obj(path, textures=self.textures)
        self.objects[key] = _ObjectEntry(mesh, DEFAULT_COLOR, DEFAULT_AMBIENT,
                                         DEFAULT_SPECULAR, DEFAULT_SHININESS)
        if key not in self._order:
            self._order.append(key)
        return key

    def instance(self, src_key: str, new_key: str, copy_properties: bool = True,
                 copy_color: bool = False) -> str:
        """Object instancing = copying a triangle list under a new key
        (simple_raytracer.cpp:564-567, :688-695).  Reference semantics: the
        scene driver copies objTriangles and objProperties but NEVER objColors
        — the unordered_map default-inserts black (0,0,0) for the new key
        unless the driver sets it explicitly afterwards."""
        src = self.objects[src_key]
        e = _ObjectEntry(src.mesh.copy(),
                         src.color if copy_color else (0.0, 0.0, 0.0),
                         src.ambient if copy_properties else DEFAULT_AMBIENT,
                         src.specular if copy_properties else DEFAULT_SPECULAR,
                         src.shininess if copy_properties else DEFAULT_SHININESS)
        self.objects[new_key] = e
        if new_key not in self._order:
            self._order.append(new_key)
        return new_key

    # -- per-object state (Object.cpp:287-293, Object.h:63-64) ---------------
    def set_color(self, key: str, color) -> None:
        self.objects[key].color = tuple(float(c) for c in color)

    def get_color(self, key: str):
        return self.objects[key].color

    def set_properties(self, key: str, ambient: Optional[float] = None,
                       specular: Optional[float] = None,
                       shininess: Optional[float] = None) -> None:
        e = self.objects[key]
        if ambient is not None:
            e.ambient = float(ambient)
        if specular is not None:
            e.specular = float(specular)
        if shininess is not None:
            e.shininess = float(shininess)

    def get_triangles(self, key: str) -> MeshData:
        return self.objects[key].mesh

    def set_triangles(self, key: str, mesh: MeshData) -> None:
        """Install ``mesh`` under ``key``; a new key gets the reference's
        default material (Object.cpp:29-34)."""
        if key in self.objects:
            self.objects[key].mesh = mesh
        else:
            self.objects[key] = _ObjectEntry(
                mesh, DEFAULT_COLOR, DEFAULT_AMBIENT, DEFAULT_SPECULAR,
                DEFAULT_SHININESS)
        if key not in self._order:
            self._order.append(key)

    # -- transforms (Object.cpp:183-190) --------------------------------------
    def transform_triangles(self, key: str, matrix: np.ndarray) -> None:
        mesh = self.objects[key].mesh
        mesh.verts = T.apply_transform(matrix, mesh.verts)

    # -- build ----------------------------------------------------------------
    def build(self) -> Scene:
        """Concatenate all objects into one :class:`Scene` (CPU tensors)."""
        keys = self._order
        meshes = [self.objects[k].mesh for k in keys]
        O = len(keys)

        # global texture table: registry names in stable order
        tex_names = [n for n in self.textures.data.keys()]
        tex_gid = {n: i for i, n in enumerate(tex_names)}

        vs, ns, us, tcs, tts, tos = [], [], [], [], [], []
        for oid, (k, m) in enumerate(zip(keys, meshes)):
            t = m.num_triangles
            vs.append(m.verts)
            ns.append(m.normals)
            us.append(m.uvs)
            tcs.append(m.tri_color)
            # remap per-mesh texture ids to global atlas ids
            local2global = np.array(
                [tex_gid.get(n, -1) for n in m.textures], dtype=np.int32)
            tt = m.tri_tex.copy()
            valid = tt >= 0
            tt[valid] = local2global[tt[valid]] if len(local2global) else -1
            tts.append(tt)
            tos.append(np.full((t,), oid, dtype=np.int32))

        def cat(arrs, empty_shape, dtype=np.float32):
            if not arrs or sum(a.shape[0] for a in arrs) == 0:
                return np.zeros(empty_shape, dtype)
            return np.concatenate(arrs, axis=0)

        verts = cat(vs, (0, 3, 4))
        # flat geometric normals precomputed once (simple_raytracer.cpp:32-37
        # is the ACTIVE normal path)
        vc = verts[..., :3] / verts[..., 3:4] if verts.shape[0] else verts[..., :3]
        e1 = vc[:, 1] - vc[:, 0]
        e2 = vc[:, 2] - vc[:, 0]
        nrm = np.cross(e1, e2)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        tri_normal = (nrm / np.maximum(ln, 1e-30)).astype(np.float32)
        # texture atlas
        datas, offs, ws, hs = [], [], [], []
        off = 0
        for n in tex_names:
            img = self.textures.data[n]
            h, w = img.shape[0], img.shape[1]
            datas.append(img.reshape(-1, 3).astype(np.float32) / 255.0)
            offs.append(off)
            ws.append(w)
            hs.append(h)
            off += h * w
        if not datas:   # keep shapes non-empty for gather friendliness
            datas = [np.zeros((1, 3), np.float32)]
            offs, ws, hs = [0], [1], [1]

        return scene_from_numpy(dict(
            verts=np.asarray(verts, np.float32),
            vnormals=np.asarray(cat(ns, (0, 3, 3)), np.float32),
            tri_normal=tri_normal,
            uvs=np.asarray(cat(us, (0, 3, 2)), np.float32),
            tri_color=np.asarray(cat(tcs, (0, 3)), np.float32),
            tri_tex=np.asarray(cat(tts, (0,), np.int32), np.int32),
            tri_obj=np.asarray(cat(tos, (0,), np.int32), np.int32),
            obj_color=(np.array([self.objects[k].color for k in keys],
                                np.float32)
                       if O else np.zeros((0, 3), np.float32)),
            obj_ambient=np.array(
                [self.objects[k].ambient for k in keys], np.float32),
            obj_specular=np.array(
                [self.objects[k].specular for k in keys], np.float32),
            obj_shininess=np.array(
                [self.objects[k].shininess for k in keys], np.float32),
            tex_data=np.concatenate(datas, axis=0),
            tex_offset=np.array(offs, np.int32),
            tex_width=np.array(ws, np.int32),
            tex_height=np.array(hs, np.int32),
        ), has_textures=bool(tex_names))
