"""The shading integrator: hit records -> radiance, and the frame's finish.

Counterpart of the JAX package's ``render/integrator.py`` for flat,
untextured records: ``light_sample_positions``, ``material_select``,
``records_from_attrs``, ``shade_records``, ``shade`` and
``finalize_image``.  The fused frame shades inside its nearest-hit kernel
(kernels/nearest.py); the soft-shadow frame shades here, from the records
the fetch mode of that kernel returns.  The record gather of the JAX
``gather_hit_records`` and the textured and smooth-normal records are not
ported yet (ROADMAP.md, Open items §1 items 7c-7e).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..ops import shading as sh


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


def records_from_attrs(scene, attrs: torch.Tensor) -> dict:
    """Shading record of flat, untextured hits from the fetch mode's rows
    (attrs [R, 4]: flat normal xyz, object id; kernels/nearest.py)."""
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
    """Shading core over per-ray records -> tone-mapped radiance [R, 3]
    (misses hold garbage; mask with isfinite(t)).  S = num_samples Phong
    evaluations, one per light sample, each divided by shadow_dim where
    ``shadow_fn`` (point, light, self_obj, hit) -> bool [S * R] says the
    sample is occluded, summed, then tone-mapped.  A single-object scene
    is never shadowed (the reference skips the hit object's own triangles,
    simple_raytracer.cpp:331), so its shadow pass is dropped."""
    scfg, lcfg = cfg.shading, cfg.light
    if scfg.smooth_normals or "normal" not in record:
        raise NotImplementedError(
            "smooth-normal and textured records are not ported yet "
            "(ROADMAP.md, Open items §1 item 7e)")
    hit = torch.isfinite(t)
    point = origin + torch.where(hit, t, 0.0)[:, None] * direction
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
            record["obj"].clamp_min(0).expand(S, R).reshape(S * R),
            hit=hit.expand(S, R).reshape(S * R)).reshape(S, R)
    accum = torch.zeros_like(point)
    for s in range(S):
        c = sh.phong(record["normal"], point, direction,
                     samples[s].expand(R, 3), light_color, record["color"],
                     record["ambient"], record["specular"],
                     record["shininess"], double_sided=scfg.double_sided_diffuse,
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
    """Shade flat rays [R, 3] from their nearest hits (t [R], inf = miss;
    tri_idx [R]) and the hits' ``record`` (:func:`records_from_attrs`).
    Returns tone-mapped radiance [R, 3]; misses hold garbage."""
    if scene.num_triangles == 0 or scene.obj_color.shape[0] == 0:
        return torch.zeros_like(origin)
    if record is None:
        raise NotImplementedError(
            "the record gather is not ported yet (ROADMAP.md, Open items "
            "§1 item 7e)")
    return shade_records(scene, cfg, record, origin, direction, t, light_pos,
                         shadow_fn)


def finalize_image(radiance: torch.Tensor, hit: torch.Tensor,
                   cfg: RenderConfig) -> torch.Tensor:
    """Quantize + background fill -> [H, W, 3] uint8.

    Reproduces: int(c*255) truncation (:447-449); pixels that are missed OR
    shade to exactly (0,0,0) become light blue (173,216,230) (:476-487).
    """
    q = sh.quantize_255(radiance) if cfg.shading.quantize_truncate \
        else torch.round(radiance * 255.0)
    q = torch.where(hit[..., None], q, torch.zeros_like(q))
    is_black = (q == 0.0).all(dim=-1)
    bg = torch.tensor(cfg.background, dtype=q.dtype, device=q.device)
    out = torch.where(is_black[..., None], bg, q)
    return out.clamp(0, 255).to(torch.uint8)
