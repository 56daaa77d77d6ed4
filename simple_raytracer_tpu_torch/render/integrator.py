"""The shading integrator: hit records -> radiance, and the frame's finish.

Counterpart of the JAX package's ``render/integrator.py``:
``light_sample_positions``, ``gather_hit_records``, ``material_select``,
``records_from_attrs``, ``shade_records``, ``shade`` and
``finalize_image``.  The fused frame shades inside its nearest-hit kernel
(kernels/nearest.py); the soft-shadow frame shades here, from the records
the fetch mode of that kernel returns; the gather and paged frames, and
the bruteforce and BVH modes, shade here by winner id (flat, textured or
smooth-normal): on the card in one kernel (csrc/shade.cu,
:func:`shade_cuda`), elsewhere by gathering the records
(:func:`shade_plain`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..kernels import build, table
from ..ops import shading as sh
from ..utils.metrics import count, span

# torch.pow's own kernels for these exponents of the tone map's gamma
# (ATen's pow_tensor_scalar), by csrc/shade.cu's pow_gamma kind; powf else
POW_KINDS = {2.0: 1, 3.0: 2, -2.0: 3, 0.5: 4, -0.5: 5, -1.0: 6}


@functools.lru_cache(maxsize=None)
def _sample_offsets(num_samples: int, jitter_step: float,
                    device: torch.device) -> torch.Tensor:
    """The light samples' offsets from the light [S, 3], on ``device``,
    made once per (S, jitter step, device)."""
    offsets = np.zeros((num_samples, 3), dtype=np.float32)
    acc = np.zeros(3, dtype=np.float32)
    for s in range(num_samples):
        offsets[s] = acc
        acc[s % 3] += jitter_step
    return torch.from_numpy(offsets).to(device)


def light_sample_positions(light_pos, num_samples: int,
                           jitter_step: float) -> torch.Tensor:
    """Soft-shadow light sample positions (simple_raytracer.cpp:362-383):
    the reference moves the light cumulatively, +jitter on x, y, z in
    rotation AFTER each sample, so sample 0 is the base light.  [S, 3], on
    the light's device, with no copy from the host once its offsets are
    made."""
    light = torch.as_tensor(light_pos, dtype=torch.float32)
    return light[None, :] + _sample_offsets(num_samples, float(jitter_step),
                                            light.device)


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
        shadowed = _shadow_found(shadow_fn, point, hit, obj, samples)
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


def _shadow_found(shadow_fn, point, hit, obj, samples) -> torch.Tensor:
    """One shadow query for all S light ``samples`` [S, 3], sample-major,
    from the points [R, 3] of the hits ``hit`` [R] of objects ``obj`` [R]
    -> found [S, R] bool.  Miss origins are pinned to 0 (the shadow front
    end repairs them from the hit mask)."""
    S, R = samples.shape[0], point.shape[0]
    pts = torch.where(hit[:, None], point, 0.0)
    return shadow_fn(
        pts.expand(S, R, 3).reshape(S * R, 3),
        samples[:, None, :].expand(S, R, 3).reshape(S * R, 3),
        obj.expand(S, R).reshape(S * R),
        hit=hit.expand(S, R).reshape(S * R)).reshape(S, R)


def shade(scene, cfg: RenderConfig, origin: torch.Tensor,
          direction: torch.Tensor, t: torch.Tensor, tri_idx: torch.Tensor,
          light_pos, shadow_fn: Optional[Callable] = None,
          record: Optional[dict] = None) -> torch.Tensor:
    """Shade rays [R, 3] from their nearest hits (t [R], inf = miss;
    tri_idx [R], -1 = miss) by the ``shade`` role of kernels/table.py:
    :func:`shade_cuda` on the card, :func:`shade_plain` for CPU tensors, a
    given ``record`` (the soft branch's :func:`records_from_attrs`,
    dist/ring.py's) or a gradient to carry (diff/render.py).  Returns
    tone-mapped radiance [R, 3]; misses hold garbage."""
    if scene.num_triangles == 0 or scene.obj_color.shape[0] == 0:
        return torch.zeros_like(origin)
    with span("srt.shade"):
        return table.run("shade", scene, cfg, origin, direction, t, tri_idx,
                         light_pos, shadow_fn, record)


def shade_plain(scene, cfg: RenderConfig, origin: torch.Tensor,
                direction: torch.Tensor, t: torch.Tensor,
                tri_idx: torch.Tensor, light_pos,
                shadow_fn: Optional[Callable] = None,
                record: Optional[dict] = None) -> torch.Tensor:
    """:func:`shade` in plain PyTorch, on any device, for every record and
    under autograd: the hits' ``record``, or with none the record gathered
    by ``tri_idx`` (:func:`gather_hit_records`), through
    :func:`shade_records`."""
    if record is None:
        record = gather_hit_records(scene, tri_idx, cfg)
    return shade_records(scene, cfg, record, origin, direction, t,
                         light_pos, shadow_fn)


def shade_cuda(scene, cfg: RenderConfig, origin: torch.Tensor,
               direction: torch.Tensor, t: torch.Tensor,
               tri_idx: torch.Tensor, light_pos,
               shadow_fn: Optional[Callable] = None,
               record: Optional[dict] = None) -> torch.Tensor:
    """:func:`shade_plain`'s radiance with no record, on the card: the
    light samples (their offsets made once on the device), one shadow query
    of all of them through ``shadow_fn`` (as :func:`shade_records` makes
    it), then csrc/shade.cu's kernel (:func:`shade_launch`), equal to
    :func:`shade_plain` bit for bit; the host reads nothing back.
    ``record`` is never given (kernels/table.py sends a record to
    :func:`shade_plain`)."""
    lcfg = cfg.light
    samples = light_sample_positions(
        torch.as_tensor(light_pos, dtype=torch.float32, device=origin.device),
        lcfg.num_samples, lcfg.jitter_step)
    found = None
    if (shadow_fn is not None and lcfg.enable_shadows
            and scene.obj_color.shape[0] > 1):
        hit = torch.isfinite(t)
        point = origin + torch.where(hit, t, 0.0)[:, None] * direction
        obj = scene.tri_obj[tri_idx.clamp_min(0).long()]
        found = _shadow_found(shadow_fn, point, hit, obj, samples)
    return shade_launch(scene, cfg, origin, direction, t, tri_idx, samples,
                        found)


def shade_launch(scene, cfg: RenderConfig, origin: torch.Tensor,
                 direction: torch.Tensor, t: torch.Tensor,
                 tri_idx: torch.Tensor, samples: torch.Tensor,
                 found: Optional[torch.Tensor] = None) -> torch.Tensor:
    """csrc/shade.cu's kernel alone, one launch: the tone-mapped radiance
    [R, 3] of the rays' hits under the light ``samples`` [S, 3], a sample
    divided by ``shadow_dim`` where ``found`` [S, R] (bool; None: no
    shadow) is set.  The scene's tensors are read in place; the rays, t,
    ids (int32) and flags are made contiguous.  It counts its launches
    (``integrator.shade_cuda.launches``)."""
    scfg, lcfg = cfg.shading, cfg.light
    dev = origin.device
    R, S = origin.shape[0], samples.shape[0]
    smooth = bool(scfg.smooth_normals)
    f32, i32 = torch.float32, torch.int32
    o, d, t = origin.contiguous(), direction.contiguous(), t.contiguous()
    idx = tri_idx.to(i32).contiguous()
    found = None if found is None else found.contiguous()
    normals = scene.vnormals if smooth else scene.tri_normal
    ops = {"origin": (o, f32), "direction": (d, f32), "t": (t, f32),
           "tri_idx": (idx, i32), "verts": (scene.verts, f32),
           "normals": (normals, f32), "uvs": (scene.uvs, f32),
           "tri_obj": (scene.tri_obj, i32), "tri_tex": (scene.tri_tex, i32),
           "obj_color": (scene.obj_color, f32),
           "obj_ambient": (scene.obj_ambient, f32),
           "obj_specular": (scene.obj_specular, f32),
           "obj_shininess": (scene.obj_shininess, f32),
           "tex_data": (scene.tex_data, f32),
           "tex_offset": (scene.tex_offset, i32),
           "tex_width": (scene.tex_width, i32),
           "tex_height": (scene.tex_height, i32),
           "samples": (samples, f32)}
    if found is not None:
        ops["found"] = (found, torch.bool)
    build.check_tensors(dev, **ops)
    if (o.shape != (R, 3) or d.shape != (R, 3) or t.shape != (R,)
            or idx.shape != (R,) or samples.shape != (S, 3)
            or (found is not None and found.shape != (S, R))):
        raise ValueError("shade_launch: want o, d [R, 3], t, tri_idx [R], "
                         "samples [S, 3] and found [S, R]")
    out = torch.empty((R, 3), dtype=f32, device=dev)
    # torch divides by a Python number as a product by its f32 reciprocal
    inv_dim = float(np.float32(1.0) / np.float32(lcfg.shadow_dim))
    light = (ctypes.c_float * 3)(*lcfg.color)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.library().srt_shade(
            o.data_ptr(), d.data_ptr(), t.data_ptr(), idx.data_ptr(), R,
            scene.verts.data_ptr(), normals.data_ptr(),
            scene.uvs.data_ptr(), scene.tri_obj.data_ptr(),
            scene.tri_tex.data_ptr(), scene.obj_color.data_ptr(),
            scene.obj_ambient.data_ptr(), scene.obj_specular.data_ptr(),
            scene.obj_shininess.data_ptr(), scene.tex_data.data_ptr(),
            scene.tex_offset.data_ptr(), scene.tex_width.data_ptr(),
            scene.tex_height.data_ptr(), samples.data_ptr(), S,
            None if found is None else found.data_ptr(), light, inv_dim,
            scfg.reinhard_offset, scfg.gamma,
            POW_KINDS.get(float(scfg.gamma), 0), int(smooth),
            int(scene.has_textures), int(scfg.tonemap_enabled),
            int(scfg.double_sided_diffuse), int(scfg.specular_nl_factor),
            out.data_ptr(), stream)
    build.check(rc, "shade_kernel")
    count("integrator.shade_cuda.launches", int(R > 0))
    return out


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
