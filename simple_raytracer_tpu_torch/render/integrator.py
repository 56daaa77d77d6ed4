"""The shading integrator: hit records -> radiance, and the frame's finish.

Counterpart of the JAX package's ``render/integrator.py``:
``light_sample_positions``, ``gather_hit_records``, ``material_select``,
``records_from_attrs``, ``shade_records``, ``shade`` and
``finalize_image``.  The fused frame shades inside its nearest-hit kernel
(kernels/nearest.py); the soft-shadow frame shades here, from the records
the fetch mode of that kernel returns; the paged frame gathers its records
by winner id (flat, textured or smooth-normal) and shades here.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import shading as sh
from ..utils.metrics import span


def light_sample_positions(light_pos, num_samples: int,
                           jitter_step: float) -> torch.Tensor:
    """Soft-shadow light sample positions (simple_raytracer.cpp:362-383):
    the reference moves the light cumulatively, +jitter on x, y, z in
    rotation AFTER each sample, so sample 0 is the base light.  [S, 3]."""
    offsets = np.zeros((num_samples, 3), dtype=np.float32)
    acc = np.zeros(3, dtype=np.float32)
    for s in range(num_samples):
        offsets[s] = acc
        acc[s % 3] += jitter_step
    light = torch.as_tensor(light_pos, dtype=torch.float32)
    return light[None, :] + torch.from_numpy(offsets).to(light.device)


def gather_hit_records(scene, tri_idx: torch.Tensor,
                       cfg: RenderConfig, gather=None) -> dict:
    """Per-ray shading record by global triangle id (JAX
    render/integrator.py::gather_hit_records).  Only the columns the config
    uses are packed into one [T, K] table (object and texture ids as f32,
    exact below 2**24; the object's material expanded per triangle; the
    Cartesian vertices for smooth or textured shading; the vertex normals
    for smooth shading, else the flat normal; the texel UVs for textured
    scenes), and one row gather by ``tri_idx`` (-1 reads row 0) reads
    them: ``table[idx]``, or ``gather(table, idx)``."""
    idx = tri_idx.clamp_min(0).long()
    smooth = bool(cfg.shading.smooth_normals)
    textured = scene.has_textures
    tobj = scene.tri_obj.long()
    cols = [scene.tri_obj.to(torch.float32)[:, None],
            scene.tri_tex.to(torch.float32)[:, None],
            scene.obj_color[tobj], scene.obj_ambient[tobj][:, None],
            scene.obj_specular[tobj][:, None],
            scene.obj_shininess[tobj][:, None]]
    if smooth or textured:
        verts_cart = scene.verts[..., :3] / scene.verts[..., 3:4]
        cols.append(verts_cart.reshape(-1, 9))
    cols.append(scene.vnormals.reshape(-1, 9) if smooth else scene.tri_normal)
    if textured:
        cols.append(scene.uvs.reshape(-1, 6))
    table = torch.cat(cols, dim=1)
    # ONE [R, K] gather
    packed = table[idx] if gather is None else gather(table, idx)
    rec = {"obj": packed[:, 0].to(torch.int32),
           "tex_id": packed[:, 1].to(torch.int32),
           "color": packed[:, 2:5], "ambient": packed[:, 5],
           "specular": packed[:, 6], "shininess": packed[:, 7]}
    c = 8
    if smooth or textured:
        rec["tri_v"] = packed[:, c:c + 9].reshape(-1, 3, 3)
        c += 9
    if smooth:
        rec["vnormals"] = packed[:, c:c + 9].reshape(-1, 3, 3)
        c += 9
    else:
        rec["normal"] = packed[:, c:c + 3]
        c += 3
    if textured:
        rec["uvs"] = packed[:, c:c + 6].reshape(-1, 3, 2)
    return rec


def material_select(scene, obj: torch.Tensor) -> dict:
    """Per-ray material (color [R, 3], ambient, specular, shininess [R]) by
    an unrolled select over the scene's few objects, not a gather."""
    R = obj.shape[0]
    dev = obj.device
    color = torch.zeros((R, 3), dtype=scene.obj_color.dtype, device=dev)
    amb = torch.zeros((R,), dtype=scene.obj_ambient.dtype, device=dev)
    spec = torch.zeros((R,), dtype=scene.obj_specular.dtype, device=dev)
    shin = torch.zeros((R,), dtype=scene.obj_shininess.dtype, device=dev)
    for o in range(scene.obj_color.shape[0]):
        m = obj == o
        color = torch.where(m[:, None], scene.obj_color[o], color)
        amb = torch.where(m, scene.obj_ambient[o], amb)
        spec = torch.where(m, scene.obj_specular[o], spec)
        shin = torch.where(m, scene.obj_shininess[o], shin)
    return {"color": color, "ambient": amb, "specular": spec,
            "shininess": shin}


def _material_gather(scene, obj: torch.Tensor) -> dict:
    """Per-ray material by gathers from the object tables (scenes of more
    objects than :func:`material_select` unrolls)."""
    o = obj.long()
    return {"color": scene.obj_color[o], "ambient": scene.obj_ambient[o],
            "specular": scene.obj_specular[o],
            "shininess": scene.obj_shininess[o]}


def records_from_attrs(scene, attrs: torch.Tensor) -> dict:
    """Shading record of flat, untextured hits from the fetch mode's rows
    (attrs [R, 4]: flat normal xyz, object id; kernels/nearest.py)."""
    with span("srt.shade"):
        obj = torch.round(attrs[:, 3]).to(torch.int32)
        rec = {"obj": obj,
               "tex_id": torch.full_like(obj, -1),
               "normal": attrs[:, :3]}
        rec.update(material_select(scene, obj))
        return rec


def shade_records(scene, cfg: RenderConfig, record: dict,
                  origin: torch.Tensor, direction: torch.Tensor,
                  t: torch.Tensor, light_pos,
                  shadow_fn: Optional[Callable] = None) -> torch.Tensor:
    """Shading core over per-ray records (:func:`gather_hit_records` or
    :func:`records_from_attrs`, or the ring's records of dist/ring.py,
    which carry no material: it is then selected by object id, from
    ``scene``'s small tables) -> tone-mapped radiance [R, 3] (misses
    hold garbage; mask with isfinite(t)).  The base color is the texel of
    a textured hit (the record's UVs at the hit's barycentrics), else the
    material color; the normal is the interpolated vertex normal with
    smooth shading, else the record's flat normal (or that of its
    vertices).  S = num_samples Phong
    evaluations, one per light sample, each divided by shadow_dim where
    ``shadow_fn`` (point, light, self_obj, hit) -> bool [S * R] says the
    sample is occluded, summed, then tone-mapped.  A single-object scene
    is never shadowed (the reference skips the hit object's own triangles,
    simple_raytracer.cpp:331), so its shadow pass is dropped."""
    scfg, lcfg = cfg.shading, cfg.light
    obj = record["obj"].clamp_min(0)
    hit = torch.isfinite(t)
    point = origin + torch.where(hit, t, 0.0)[:, None] * direction
    has_uv = scene.has_textures and "uvs" in record
    bary = None
    if has_uv or scfg.smooth_normals:
        bary = sh.barycentric(record["tri_v"], point)
    if "color" not in record:
        record = {**record, **(material_select(scene, obj)
                               if scene.num_objects <= 8
                               else _material_gather(scene, obj))}
    base = record["color"]
    if has_uv:
        tex_rgb = sh.texture_fetch(scene.tex_data, scene.tex_offset,
                                   scene.tex_width, scene.tex_height,
                                   record["tex_id"],
                                   sh.interpolate_uv(record["uvs"], bary))
        base = torch.where((record["tex_id"] >= 0)[:, None], tex_rgb, base)
    if scfg.smooth_normals:
        normal = sh.smooth_normal(record["vnormals"], bary)
    elif "normal" in record:
        normal = record["normal"]
    else:
        normal = sh.flat_normal(record["tri_v"])
    light_color = torch.tensor(lcfg.color, dtype=point.dtype,
                               device=point.device)
    samples = light_sample_positions(light_pos, lcfg.num_samples,
                                     lcfg.jitter_step)
    S, R = lcfg.num_samples, point.shape[0]
    if scene.obj_color.shape[0] <= 1:
        shadow_fn = None
    shadowed = None
    if shadow_fn is not None and lcfg.enable_shadows:
        # one query for all S samples, sample-major; miss origins pinned to
        # 0 (the shadow front end repairs them from the hit mask)
        pts = torch.where(hit[:, None], point, 0.0)
        shadowed = shadow_fn(
            pts.expand(S, R, 3).reshape(S * R, 3),
            samples[:, None, :].expand(S, R, 3).reshape(S * R, 3),
            obj.expand(S, R).reshape(S * R),
            hit=hit.expand(S, R).reshape(S * R)).reshape(S, R)
    accum = torch.zeros_like(point)
    for s in range(S):
        c = sh.phong(normal, point, direction, samples[s].expand(R, 3),
                     light_color, base, record["ambient"],
                     record["specular"], record["shininess"],
                     double_sided=scfg.double_sided_diffuse,
                     specular_nl=scfg.specular_nl_factor)
        if shadowed is not None:
            c = torch.where(shadowed[s][:, None], c / lcfg.shadow_dim, c)
        accum = accum + c
    if scfg.tonemap_enabled:
        accum = sh.tonemap(accum, scfg.reinhard_offset, scfg.gamma)
    return accum


def shade(scene, cfg: RenderConfig, origin: torch.Tensor,
          direction: torch.Tensor, t: torch.Tensor, tri_idx: torch.Tensor,
          light_pos, shadow_fn: Optional[Callable] = None,
          record: Optional[dict] = None) -> torch.Tensor:
    """Shade rays [R, 3] from their nearest hits (t [R], inf = miss;
    tri_idx [R], -1 = miss): the hits' ``record``, or with none the record
    gathered by ``tri_idx`` (:func:`gather_hit_records`), through
    :func:`shade_records`.  Returns tone-mapped radiance [R, 3]; misses
    hold garbage."""
    if scene.num_triangles == 0 or scene.obj_color.shape[0] == 0:
        return torch.zeros_like(origin)
    with span("srt.shade"):
        if record is None:
            record = gather_hit_records(scene, tri_idx, cfg)
        return shade_records(scene, cfg, record, origin, direction, t,
                             light_pos, shadow_fn)


def finalize_image(radiance: torch.Tensor, hit: torch.Tensor,
                   cfg: RenderConfig) -> torch.Tensor:
    """Quantize + background fill -> [H, W, 3] uint8.

    Reproduces: int(c*255) truncation (:447-449); pixels that are missed OR
    shade to exactly (0,0,0) become light blue (173,216,230) (:476-487).
    """
    with span("srt.finish"):
        q = sh.quantize_255(radiance) if cfg.shading.quantize_truncate \
            else torch.round(radiance * 255.0)
        q = torch.where(hit[..., None], q, torch.zeros_like(q))
        is_black = (q == 0.0).all(dim=-1)
        bg = torch.tensor(cfg.background, dtype=q.dtype, device=q.device)
        out = torch.where(is_black[..., None], bg, q)
        return out.clamp(0, 255).to(torch.uint8)
