"""Primary rays: pinhole camera at the view-space origin.

Reference (simple_raytracer.cpp:505-525): for pixel column i in [-W/2, W/2)
and row j in [-H/2, H/2), ray direction = (i, j, focal), origin (0,0,0),
directions NOT normalized.  With a view matrix V (Transformation.cpp:84-90)
the rays move instead of the world: origin V[:3, 3], direction
V[:3, :3] @ (i, j, focal).

The bruteforce and BVH modes take rays in row-major image order
(:func:`primary_rays`, :func:`primary_rays_world`).  The tiled renderer
works in 2D-TILE-MAJOR order: flat ray index
``((tyi * tx + txi) * tile_px + y_in_tile) * tile_px + x_in_tile``.  Its
kernels rebuild each ray from its pixel index and a few per-frame constants
(:func:`tile_ray_dirs`), so no ray array is ever stored.
"""

from __future__ import annotations

import torch


def primary_rays(width: int, height: int, focal: float = 400.0,
                 normalize: bool = False, device=None):
    """All primary rays of a W x H image in row-major order: origins
    [H, W, 3] at 0 and directions (i, j, focal) with column i in
    [-W/2, W - W/2) and row j in [-H/2, H - H/2)."""
    i = torch.arange(-(width // 2), width - width // 2, dtype=torch.float32,
                     device=device)
    j = torch.arange(-(height // 2), height - height // 2,
                     dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")          # [H, W]
    d = torch.stack([ii, jj, torch.full_like(ii, float(focal))], dim=-1)
    if normalize:
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.zeros_like(d), d


def primary_rays_world(width: int, height: int, view_matrix,
                       focal: float = 400.0, normalize: bool = False,
                       device=None):
    """World-space primary rays of the camera ``view_matrix`` V
    (Transformation.cpp:84-90 convention): origin V[:3, 3], direction
    V[:3, :3] @ (i, j, focal), normalized after the rotation if asked.
    The scene stays static and the rays move (JAX
    ops/camera.py::primary_rays_world).  [H, W, 3] each."""
    _, d = primary_rays(width, height, focal, normalize=False, device=device)
    V = torch.as_tensor(view_matrix, dtype=torch.float32, device=d.device)
    d = torch.einsum("ij,hwj->hwi", V[:3, :3], d)
    if normalize:
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return V[:3, 3].expand(d.shape), d


def primary_rays_tiled(width: int, height: int, tile_px: int,
                       focal: float = 400.0, normalize: bool = False,
                       view_matrix=None, device=None):
    """All primary rays in tile-major order.  Ragged sizes are padded UP to
    tile multiples with real out-of-frame rays (pixel coordinates beyond
    width/height).  Returns (o [Rp, 3], d [Rp, 3], tx, ty),
    Rp = tx * ty * tile_px**2."""
    tx = -(-width // tile_px)
    ty = -(-height // tile_px)
    n = tx * ty * tile_px * tile_px
    idx = torch.arange(n, dtype=torch.int32, device=device)
    tp2 = tile_px * tile_px
    tile_id = idx // tp2
    r = idx % tp2
    py = (tile_id // tx) * tile_px + r // tile_px
    px = (tile_id % tx) * tile_px + r % tile_px
    i = px.to(torch.float32) - (width // 2)
    j = py.to(torch.float32) - (height // 2)
    d = torch.stack([i, j, torch.full_like(i, float(focal))], dim=-1)
    if view_matrix is not None:
        V = torch.as_tensor(view_matrix, dtype=torch.float32, device=device)
        d = d @ V[:3, :3].T
        o = V[:3, 3].expand(d.shape)
    else:
        o = torch.zeros_like(d)
    if normalize:
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return o, d, tx, ty


def tile_ray_dirs(cam: torch.Tensor, px0: torch.Tensor, py0: torch.Tensor,
                  tile_px: int):
    """Directions of every ray of the given tiles, rebuilt from the pixel
    index as the kernels do: d = fx * A + fy * B + C with (fx, fy) the
    pixel's offset from the image centre and A, B, C the camera rows of
    ``cam`` (kernels/plan.py::make_cam).  px0/py0 [n] i32 are the tiles'
    pixel origins relative to the centre.  Returns (dx, dy, dz), each
    [n, tile_px**2]."""
    lane = torch.arange(tile_px * tile_px, dtype=torch.int32,
                        device=cam.device)
    fx = (px0[:, None] + lane % tile_px).to(torch.float32)
    fy = (py0[:, None] + lane // tile_px).to(torch.float32)
    return tuple(fx * cam[c] + fy * cam[3 + c] + cam[6 + c] for c in range(3))


def untile_image(flat: torch.Tensor, width: int, height: int, tile_px: int,
                 tx: int, ty: int) -> torch.Tensor:
    """Tile-major flat results [Rp, ...] -> row-major [H, W, ...] (inverse
    of the tile-major ordering; a reshape/transpose, no gather)."""
    trail = tuple(flat.shape[1:])
    img = flat.reshape((ty, tx, tile_px, tile_px) + trail)
    img = img.movedim(2, 1)                  # [ty, tile_px, tx, tile_px, ...]
    img = img.reshape((ty * tile_px, tx * tile_px) + trail)
    return img[:height, :width]
