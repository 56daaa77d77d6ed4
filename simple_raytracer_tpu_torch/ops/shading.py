"""Shading ops in plain PyTorch (simple_raytracer.cpp:79-200, :348-449):
barycentric coordinates, normals, Phong, texture fetch, tone map.

Reference quirks reproduced (PARITY.md rows 14-21): diffuse uses abs(n·l);
the specular term carries an extra n·l factor and no object color; no
distance falloff; tone mapping happens before the truncating quantization.
"""

from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1, keepdim=True)


def barycentric(verts_cart: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Dot-product (Ericson) barycentric coordinates
    (simple_raytracer.cpp:79-117).  verts_cart [..., 3, 3], point [..., 3]
    -> [..., 3] = (u, v, w) with ``point ≈ u*p1 + v*p2 + w*p3``."""
    p1 = verts_cart[..., 0, :]
    v0 = verts_cart[..., 1, :] - p1
    v1 = verts_cart[..., 2, :] - p1
    v2 = point - p1
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d11 = (v1 * v1).sum(-1)
    d20 = (v2 * v0).sum(-1)
    d21 = (v2 * v1).sum(-1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return torch.stack([u, v, w], dim=-1)


def flat_normal(verts_cart: torch.Tensor) -> torch.Tensor:
    """Geometric normal normalize(cross(p2 - p1, p3 - p1))
    (simple_raytracer.cpp:32-37), not flipped toward the ray."""
    v1 = verts_cart[..., 1, :] - verts_cart[..., 0, :]
    v2 = verts_cart[..., 2, :] - verts_cart[..., 0, :]
    n = torch.linalg.cross(v1, v2, dim=-1)
    return n / _norm(n)


def _bary_mix(bary: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_v bary[..., v] * x[..., v, :] (the JAX einsum "...v,...vk->...k")."""
    return (bary[..., :, None] * x).sum(-2)


def smooth_normal(vnormals: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Vertex-normal interpolation (simple_raytracer.cpp:132-140; commented
    out in the reference at :162-163, behind ShadingConfig.smooth_normals
    here).  vnormals [..., 3, 3], bary [..., 3] -> unit [..., 3]."""
    n = _bary_mix(bary, vnormals)
    return n / _norm(n)


def interpolate_uv(uvs: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of the baked texel coordinates
    (simple_raytracer.cpp:121-128): uvs [..., 3, 2] -> [..., 2]."""
    return _bary_mix(bary, uvs)


def texture_fetch(tex_data, tex_offset, tex_width, tex_height, tex_id,
                  texel) -> torch.Tensor:
    """Nearest texel from the flat atlas (tex_data [P, 3]; per-texture
    offset, width and height [K]).  ``texel`` [..., 2] are interpolated
    texel-space coordinates; like the reference they are truncated toward
    zero with no shade-time wrap (simple_raytracer.cpp:350-361; the wrap
    was baked per vertex at load), then clamped to the texture's rectangle.
    tex_id < 0 reads texture 0 (callers select the object color there)."""
    tid = tex_id.clamp_min(0).long()
    w = tex_width[tid].long()
    h = tex_height[tid].long()
    x = torch.minimum(texel[..., 0].to(torch.int32).long().clamp_min(0),
                      w - 1)
    y = torch.minimum(texel[..., 1].to(torch.int32).long().clamp_min(0),
                      h - 1)
    return tex_data[tex_offset[tid].long() + y * w + x]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """glm::reflect: I - 2*dot(N, I)*N."""
    return incident - 2.0 * (normal * incident).sum(-1, keepdim=True) * normal


def phong(normal, point, ray_dir, light_pos, light_color, obj_color,
          ambient_strength, specular_strength, shininess,
          double_sided: bool = True, specular_nl: bool = True):
    """Phong illumination (simple_raytracer.cpp:144-200), [..., 3] rows:
    diffuse = (1/pi) color light |n.l|, ambient = (1/pi) amb color light,
    specular = light spec (n.l) max(r.v, 0)**shin."""
    l = light_pos - point
    l = l / _norm(l)
    nl = (normal * l).sum(-1, keepdim=True)
    nl = nl.abs() if double_sided else nl.clamp_min(0.0)
    diffuse = INV_PI * obj_color * light_color * nl
    ambient = INV_PI * ambient_strength[..., None] * obj_color * light_color
    v = -ray_dir / _norm(ray_dir)
    r = reflect(-l, normal)
    rv = (r * v).sum(-1, keepdim=True).clamp_min(0.0)
    nl_factor = nl if specular_nl else 1.0      # :196 quirk, toggleable
    specular = (light_color * specular_strength[..., None] * nl_factor
                * torch.pow(rv, shininess[..., None]))
    return diffuse + specular + ambient


def tonemap(color: torch.Tensor, reinhard_offset: float = 0.5,
            gamma: float = 1.1) -> torch.Tensor:
    """Reinhard variant c/(c+offset) then gamma pow(c, gamma)
    (simple_raytracer.cpp:389-398), before quantization as in the
    reference."""
    c = color / (color + reinhard_offset)
    return torch.pow(c.clamp_min(0.0), gamma)


def quantize_255(color: torch.Tensor) -> torch.Tensor:
    """int(c*255) truncation (simple_raytracer.cpp:447-449), kept as float."""
    return torch.trunc(color * 255.0)
