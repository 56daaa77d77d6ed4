"""The plain reference: the raytracer's rules, pixel by pixel, in plain
PyTorch.

It works its answers out from the scene the benchmark built
(``rtbench/scenes``), and from nothing the program made: no BVH, plan,
table or prepared array.  Every pixel asked for is traced against every
triangle of every object whose bounding box its ray meets (the box is
padded, so the cull drops only pairs that cannot hit), then shaded by the
reference's rules (simple_raytracer.cpp; PARITY.md rows 14-21):

* primary ray of pixel (x, y): origin V[:3, 3], direction
  fx * V[:3, 0] + fy * V[:3, 1] + focal * V[:3, 2] with fx = x - W // 2,
  fy = y - H // 2, not normalized (:505-525);
* Möller–Trumbore with the determinant epsilon 1e-12, t >= 0, the nearest
  hit, ties to the lowest triangle id (:42-75);
* S light samples, sample s at the light moved by the cumulative jitter of
  +3 on x, y, z in turn (:362-383); a sample is shadowed when its ray from
  the hit point towards it meets any triangle of another object at any
  t >= 0 (no max t, :321-342), and then divided by 5 (:369);
* Phong per sample with |n.l| diffuse, ambient, and specular with the
  extra n.l factor, all over pi but the specular (:144-200); smooth
  normals by barycentric interpolation, texels by truncating the
  interpolated texel coordinates (:121-140, :350-361);
* the sum tone-mapped c / (c + 0.5) then ** 1.1, quantized by int(c * 255);
  a miss, or a pixel that quantizes to black, is the background
  (173, 216, 230) (:389-398, :447-449, :476-487).

``dtype`` sets the precision of every step (the control runs it in
bfloat16); the quantize reads the radiance as float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

EPS = 1e-12
JITTER, SHADOW_DIM = 3.0, 5.0
REINHARD, GAMMA = 0.5, 1.1
BACKGROUND = (173, 216, 230)
INV_PI = 1.0 / np.pi


@dataclasses.dataclass(frozen=True)
class Frame:
    """What one frame asks: the camera, its view matrix V (4x4, the ray
    space of Transformation.cpp:84-90), the light and the shading."""

    width: int
    height: int
    focal: float
    view: np.ndarray
    light: tuple
    samples: int = 1
    smooth_normals: bool = False
    shadows: bool = True


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cols(x: torch.Tensor):
    return x[..., 0], x[..., 1], x[..., 2]


def _mt(o, d, v0, e1, e2):
    """Möller–Trumbore's scalars (det, u·det, v·det, t·det): rays as
    [R, 1] columns, triangles as [1, T] rows (3-tuples each)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    tvec = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u_num = _dot(tvec, pvec)
    qvec = _cross(tvec, e1)
    return det, u_num, _dot(d, qvec), _dot(e2, qvec)


def _distance(det, u_num, v_num, t_num):
    inv = 1.0 / det
    u, v, t = u_num * inv, v_num * inv, t_num * inv
    ok = ((det.abs() >= EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0))
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def _occludes(det, u_num, v_num, t_num):
    """The same hit test without the division: u >= 0 <=> u·det·det >= 0,
    u <= 1 <=> |u·det| <= |det| once the sign holds; likewise v, u + v, t."""
    adet = det.abs()
    return ((adet >= EPS) & (u_num * det >= 0.0) & (u_num.abs() <= adet)
            & (v_num * det >= 0.0) & ((u_num + v_num).abs() <= adet)
            & (t_num * det >= 0.0))


class Reference:
    """A scene (``procedural.SceneArrays``) on ``device`` in ``dtype``."""

    def __init__(self, scene, device="cpu", dtype=torch.float32,
                 pairs_per_pass: Optional[int] = None):
        self.device, self.dtype = torch.device(device), dtype
        self.pairs = pairs_per_pass or (
            1 << 25 if self.device.type == "cuda" else 1 << 21)
        names = list(scene.textures)
        tris, vn, uv, tex, obj, ranges = [], [], [], [], [], []
        start = 0
        for k, o in enumerate(scene.objects):
            m = o.mesh
            n = m.num_triangles
            tris.append(m.verts[..., :3] / m.verts[..., 3:4])
            vn.append(m.normals)
            uv.append(m.uvs)
            tex.append(np.full(n, names.index(m.texture)
                               if m.texture is not None else -1, np.int64))
            obj.append(np.full(n, k, np.int64))
            ranges.append((start, start + n))
            start += n
        cart = np.concatenate(tris).astype(np.float32)
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device).to(dtype)
        self.verts = put(cart)                                   # [T, 3, 3]
        self.v0 = self.verts[:, 0]
        self.e1 = self.verts[:, 1] - self.verts[:, 0]
        self.e2 = self.verts[:, 2] - self.verts[:, 0]
        n = torch.linalg.cross(self.e1, self.e2, dim=-1)
        self.flat_normal = n / torch.linalg.norm(n, dim=-1, keepdim=True)
        self.vnormals = put(np.concatenate(vn))
        self.uvs = put(np.concatenate(uv))
        self.tri_tex = torch.as_tensor(np.concatenate(tex), device=self.device)
        self.tri_obj = torch.as_tensor(np.concatenate(obj), device=self.device)
        self.ranges = ranges
        self.color = put([o.color for o in scene.objects])
        self.ambient = put([o.ambient for o in scene.objects])
        self.specular = put([o.specular for o in scene.objects])
        self.shininess = put([o.shininess for o in scene.objects])
        self.textures = [put(scene.textures[nm].astype(np.float32) / 255.0)
                         for nm in names]
        # each object's box, padded so that no hit the arithmetic of this
        # dtype can give lies outside it
        pad = max(1e-3, 8.0 * torch.finfo(dtype).eps)
        self.boxes = []
        for a, b in ranges:
            p = cart[a:b].reshape(-1, 3).astype(np.float64)
            lo, hi = p.min(0), p.max(0)
            r = pad * (np.linalg.norm(hi - lo) + 1.0)
            self.boxes.append((torch.as_tensor(lo - r, device=self.device),
                               torch.as_tensor(hi + r, device=self.device)))

    # -- geometry ------------------------------------------------------------
    def _in_box(self, o, d, k: int) -> torch.Tensor:
        """Rays [R, 3] whose half-line t >= 0 meets object k's box
        (float64 slab test)."""
        lo, hi = self.boxes[k]
        o, d = o.double().expand_as(d), d.double()
        zero = d == 0
        inside = (o >= lo) & (o <= hi)
        safe = torch.where(zero, torch.ones_like(d), d)
        t1, t2 = (lo - o) / safe, (hi - o) / safe
        inf = torch.full_like(t1, float("inf"))
        tn = torch.where(zero, torch.where(inside, -inf, inf),
                         torch.minimum(t1, t2)).amax(-1)
        tf = torch.where(zero, torch.where(inside, inf, -inf),
                         torch.maximum(t1, t2)).amin(-1)
        return tf >= tn.clamp_min(0.0)

    def _tri_rows(self, a: int, b: int):
        return (tuple(x[None, a:b] for x in _cols(self.v0)),
                tuple(x[None, a:b] for x in _cols(self.e1)),
                tuple(x[None, a:b] for x in _cols(self.e2)))

    def nearest(self, o, d):
        """(t [R], triangle id [R]; inf and -1 on a miss).  ``o`` is
        [R, 3] or one origin [1, 3]."""
        R = d.shape[0]
        best_t = torch.full((R,), float("inf"), dtype=self.dtype,
                            device=self.device)
        best_i = torch.full((R,), -1, dtype=torch.int64, device=self.device)
        for k, (a, b) in enumerate(self.ranges):
            rays = torch.nonzero(self._in_box(o, d, k))[:, 0]
            if rays.numel() == 0:
                continue
            rows = max(1, min(rays.numel(), self.pairs // (b - a)))
            step = max(1, self.pairs // rows)
            for r0 in range(0, rays.numel(), rows):
                idx = rays[r0:r0 + rows]
                oc = _cols((o if o.shape[0] == 1 else o[idx])[:, None, :])
                dc = _cols(d[idx][:, None, :])
                bt = best_t[idx]
                bi = best_i[idx]
                for s in range(a, b, step):
                    v0, e1, e2 = self._tri_rows(s, min(b, s + step))
                    t = _distance(*_mt(oc, dc, v0, e1, e2))
                    tmin, arg = t.min(dim=1)
                    better = tmin < bt
                    bt = torch.where(better, tmin, bt)
                    bi = torch.where(better, arg + s, bi)
                best_t[idx], best_i[idx] = bt, bi
        return best_t, best_i

    def occluded(self, point, light, self_obj):
        """Shadow rays from ``point`` [N, 3] towards ``light`` [N, 3]: any
        hit at t >= 0 on a triangle of an object other than ``self_obj``."""
        d = light - point
        found = torch.zeros(point.shape[0], dtype=torch.bool,
                            device=self.device)
        for k, (a, b) in enumerate(self.ranges):
            rays = torch.nonzero((self_obj != k)
                                 & self._in_box(point, d, k))[:, 0]
            if rays.numel() == 0:
                continue
            rows = max(1, min(rays.numel(), self.pairs // (b - a)))
            step = max(1, self.pairs // rows)
            for r0 in range(0, rays.numel(), rows):
                idx = rays[r0:r0 + rows]
                oc = _cols(point[idx][:, None, :])
                dc = _cols(d[idx][:, None, :])
                hit = torch.zeros(idx.numel(), dtype=torch.bool,
                                  device=self.device)
                for s in range(a, b, step):
                    v0, e1, e2 = self._tri_rows(s, min(b, s + step))
                    hit |= _occludes(*_mt(oc, dc, v0, e1, e2)).any(dim=1)
                found[idx] = hit
        return found

    # -- a frame's pixels ------------------------------------------------------
    def rays(self, frame: Frame, pixels: torch.Tensor):
        """Primary rays of row-major pixel ids [M]: (origin [1, 3], d [M, 3])."""
        V = torch.as_tensor(np.asarray(frame.view, np.float32),
                            device=self.device).to(self.dtype)
        fx = (pixels % frame.width - frame.width // 2).to(self.dtype)
        fy = (pixels // frame.width - frame.height // 2).to(self.dtype)
        C = V[:3, 2] * torch.tensor(float(frame.focal), dtype=self.dtype,
                                    device=self.device)
        d = (fx[:, None] * V[:3, 0] + fy[:, None] * V[:3, 1]) + C
        return V[None, :3, 3], d

    def pixels(self, frame: Frame, pixels) -> np.ndarray:
        """The quantized colours [M, 3] uint8 of row-major pixel ids."""
        return self.classified(frame, pixels)[0]

    def classified(self, frame: Frame, pixels):
        """(colours [M, 3] uint8, the hit object [M] (-1: a miss), whether
        any light sample of the pixel is shadowed [M] bool)."""
        pixels = torch.as_tensor(np.asarray(pixels, np.int64),
                                 device=self.device)
        o, d = self.rays(frame, pixels)
        t, idx = self.nearest(o, d)
        rgb, shadowed = self.shade(frame, o, d, t, idx)
        obj = torch.where(idx >= 0, self.tri_obj[idx.clamp_min(0)], -1)
        return (finalize(rgb, torch.isfinite(t)).cpu().numpy(),
                obj.cpu().numpy(), shadowed.any(0).cpu().numpy())

    def light_samples(self, frame: Frame) -> torch.Tensor:
        off = np.zeros((frame.samples, 3), np.float32)
        acc = np.zeros(3, np.float32)
        for s in range(frame.samples):
            off[s] = acc
            acc[s % 3] += JITTER
        base = np.asarray(frame.light, np.float32)
        return torch.as_tensor(base[None] + off,
                               device=self.device).to(self.dtype)

    def shade(self, frame: Frame, o, d, t, idx):
        """(tone-mapped radiance [M, 3] of the hits (misses: garbage),
        which light samples are shadowed [S, M])."""
        hit = torch.isfinite(t)
        i = idx.clamp_min(0)
        obj = self.tri_obj[i]
        point = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
        tri = self.verts[i]
        base = self.color[obj]
        bary = None
        if frame.smooth_normals or self.textures:
            bary = _barycentric(tri, point)
        if self.textures:
            tex = self.tri_tex[i]
            texel = (bary[:, :, None] * self.uvs[i]).sum(1)
            fetched = torch.zeros_like(base)
            for k, img in enumerate(self.textures):
                h, w = img.shape[0], img.shape[1]
                x = texel[:, 0].float().to(torch.int32).long().clamp(0, w - 1)
                y = texel[:, 1].float().to(torch.int32).long().clamp(0, h - 1)
                fetched = torch.where((tex == k)[:, None], img[y, x], fetched)
            base = torch.where((tex >= 0)[:, None], fetched, base)
        if frame.smooth_normals:
            n = (bary[:, :, None] * self.vnormals[i]).sum(1)
            normal = n / torch.linalg.norm(n, dim=-1, keepdim=True)
        else:
            normal = self.flat_normal[i]
        lights = self.light_samples(frame)
        S, M = lights.shape[0], point.shape[0]
        shadowed = torch.zeros((S, M), dtype=torch.bool, device=self.device)
        if frame.shadows and len(self.ranges) > 1:
            rows = torch.nonzero(hit)[:, 0]
            pts = point[rows].repeat(S, 1)
            tgt = lights[:, None, :].expand(S, rows.numel(), 3).reshape(-1, 3)
            occ = self.occluded(pts, tgt, obj[rows].repeat(S))
            shadowed[:, rows] = occ.reshape(S, rows.numel())
        v = -d / torch.linalg.norm(d, dim=-1, keepdim=True)
        amb = INV_PI * self.ambient[obj][:, None] * base
        spec = self.specular[obj][:, None]
        shin = self.shininess[obj][:, None]
        acc = torch.zeros_like(point)
        for s in range(S):
            l = lights[s] - point
            l = l / torch.linalg.norm(l, dim=-1, keepdim=True)
            nl = (normal * l).sum(-1, keepdim=True).abs()
            r = -l - 2.0 * (normal * -l).sum(-1, keepdim=True) * normal
            rv = (r * v).sum(-1, keepdim=True).clamp_min(0.0)
            c = INV_PI * base * nl + spec * nl * torch.pow(rv, shin) + amb
            c = torch.where(shadowed[s][:, None], c / SHADOW_DIM, c)
            acc = acc + c
        acc = acc / (acc + REINHARD)
        return torch.pow(acc.clamp_min(0.0), GAMMA), shadowed


def _barycentric(tri, p):
    """Ericson's dot-product barycentrics (simple_raytracer.cpp:79-117)."""
    p1 = tri[:, 0]
    v0, v1, v2 = tri[:, 1] - p1, tri[:, 2] - p1, p - p1
    d00, d01, d11 = (v0 * v0).sum(-1), (v0 * v1).sum(-1), (v1 * v1).sum(-1)
    d20, d21 = (v2 * v0).sum(-1), (v2 * v1).sum(-1)
    den = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    return torch.stack([1.0 - v - w, v, w], dim=-1)


def finalize(rgb: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """int(c * 255) of the float32 radiance; misses and black pixels take
    the background.  [M, 3] uint8."""
    q = torch.trunc(rgb.float() * 255.0)
    q = torch.where(hit[:, None], q, torch.zeros_like(q))
    black = (q == 0.0).all(dim=-1)
    bg = torch.tensor(BACKGROUND, dtype=q.dtype, device=q.device)
    return torch.where(black[:, None], bg, q).clamp(0, 255).to(torch.uint8)
