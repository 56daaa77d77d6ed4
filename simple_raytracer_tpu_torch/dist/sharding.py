"""Process meshes and data-parallel (ray-sharded) rendering (JAX
``dist/sharding.py``).

JAX lays its devices out in a ``Mesh`` and runs ``shard_map`` over it.  Here
one process drives one card, and a :class:`Mesh` lays the processes of the
``torch.distributed`` group out on named axes, with one process group per
axis line through this process: a 2-D (dp, gp) mesh has its gp rings and
its dp columns.  What JAX's collectives become:

* ``shard_map`` over P(axis): each process computes its own contiguous slab;
* ``out_specs=P(axis)``: :meth:`Axis.all_gather`, onto every process;
* ``psum``: :meth:`Axis.all_reduce` (SUM);
* ``ppermute`` to i + 1: :meth:`Axis.rotate` (``batch_isend_irecv``).

NCCL carries CUDA tensors, gloo CPU tensors (``device="cpu"``).

* **DP** (:func:`render_radiance_sharded`): the primary rays, row-major,
  split into equal contiguous slabs, the scene replicated; each process
  renders its slab and the frame is gathered.  Tiled mode renders each
  slab through ``render_flat_tiled`` with no camera (kernels/tiled.py).
* **GP** (the geometry-sharded ring): dist/ring.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..accel.prepared import PreparedScene, target_device
from ..config import RenderConfig
from ..ops.camera import primary_rays
from ..render import integrator
from ..utils import pad_rays
from .multihost import backend_for, init_distributed, local_device


class Axis:
    """The process group of one mesh axis (or of the whole mesh) through
    this process: its members' global ``ranks`` in axis order, and this
    process's ``index`` among them."""

    def __init__(self, name, group, ranks, index: int):
        self.name, self.group, self.ranks, self.index = (name, group,
                                                         tuple(ranks), index)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every member's ``x`` (equal shapes), concatenated along dim 0
        in axis order, on every member."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every member's ``x``, in place, on every member."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def rotate_start(self, x: torch.Tensor):
        """Post the send of ``x`` to the next member (index + 1, mod size)
        and the receive of the previous member's; returns (requests, the
        receive buffer).  On an axis of one the rotation is the identity."""
        x = x.contiguous()
        if self.size == 1:
            return [], x
        buf = torch.empty_like(x)
        n = self.size
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, self.ranks[(self.index + 1) % n],
                       self.group),
            dist.P2POp(dist.irecv, buf, self.ranks[(self.index - 1) % n],
                       self.group)])
        return reqs, buf

    @staticmethod
    def rotate_wait(pending) -> torch.Tensor:
        reqs, buf = pending
        for r in reqs:
            r.wait()
        return buf

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's ``ppermute`` to i + 1: the previous member's ``x``."""
        return self.rotate_wait(self.rotate_start(x))


@dataclasses.dataclass
class Mesh:
    """Processes laid out on named axes, row-major: the process of global
    rank r sits at ``np.unravel_index(r, shape)``.  ``shape`` and ``coord``
    map each axis name to its size and to this process's index on it;
    ``device`` is the device this process drives."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coord: Dict[str, int]
    device: torch.device
    axes: Dict[object, Axis]

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def index(self) -> int:
        """This process's place in the mesh, row-major over the axes."""
        return int(np.ravel_multi_index(
            [self.coord[a] for a in self.axis_names],
            [self.shape[a] for a in self.axis_names]))

    def axis(self, names) -> Axis:
        """The group of one axis name, or of a tuple of names: one name in
        the tuple is that axis; every name is the whole mesh."""
        if isinstance(names, str):
            return self.axes[names]
        names = tuple(names)
        if len(names) == 1:
            return self.axes[names[0]]
        if set(names) != set(self.axis_names) or len(names) != len(
                self.axis_names):
            raise ValueError(f"no group for axes {names} of a mesh of "
                             f"{self.axis_names}")
        return self.axes[None]


def world_of_one(device) -> None:
    """A process group of this process alone (an in-memory store, no
    network), so that one process runs the same collectives."""
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              shape: Optional[Tuple[int, ...]] = None,
              device="cuda") -> Mesh:
    """A mesh over the first ``n_devices`` processes of the group (all of
    them by default), e.g. ``make_mesh(4, ("dp", "gp"), (2, 2))``.

    With no group initialised it joins the one torchrun's environment names
    (multihost.init_distributed), else forms a world of one process.  It
    raises ValueError when fewer processes exist than were asked for, as
    JAX's raises for devices.  Every process of the group must call it (the
    axis groups are made collectively); one outside the mesh raises.  The
    groups use NCCL for a CUDA ``device`` (each process on the card of its
    LOCAL_RANK) and gloo for "cpu"."""
    dev = local_device(target_device(device))
    if not dist.is_initialized():
        init_distributed(device=dev)
    if not dist.is_initialized():
        world_of_one(dev)
    world = dist.get_world_size()
    n = n_devices or world
    if world < n:
        raise ValueError(f"make_mesh: {n} processes requested but only "
                         f"{world} in the group (launch one per device, "
                         f"e.g. torchrun --nproc-per-node {n})")
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("multi-axis mesh needs an explicit shape")
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"shape {shape} for axes {axis_names} and {n} "
                         f"processes")
    be = backend_for(dev)
    rank = dist.get_rank()
    grid = np.arange(n).reshape(shape)
    axes = {}
    # every process makes every group, in one order
    for k, name in enumerate(axis_names):
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, backend=be)
            if rank in ranks:
                axes[name] = Axis(name, g, ranks, ranks.index(rank))
    whole = list(range(n))
    g = None if len(axis_names) == 1 else dist.new_group(whole, backend=be)
    if rank >= n:
        raise ValueError(f"process {rank} is outside the mesh of {n}")
    axes[None] = Axis(axis_names, g or axes[axis_names[0]].group, whole,
                      rank)
    coord = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank,
                                                                   shape))))
    return Mesh(tuple(axis_names), dict(zip(axis_names, shape)), coord, dev,
                axes)


def slab(x: torch.Tensor, index: int, n: int) -> torch.Tensor:
    """Contiguous slab ``index`` of ``n`` of x's rows (a multiple of n)."""
    rows = x.shape[0] // n
    return x[index * rows:(index + 1) * rows]


def slab_index(mesh: Mesh, axes) -> int:
    """This process's ray slab under JAX's P(axes): row-major over
    ``axes`` in the order given."""
    return int(np.ravel_multi_index([mesh.coord[a] for a in axes],
                                    [mesh.shape[a] for a in axes]))


def gather_slabs(mesh: Mesh, axes, x: torch.Tensor) -> torch.Tensor:
    """Every slab ``x`` of P(axes) (one axis, or every axis of the mesh
    in any order), gathered over those axes in slab order."""
    full = mesh.axis(axes).all_gather(x)
    if len(axes) == 1:
        return full
    rows = x.shape[0]
    coords = np.stack(np.unravel_index(
        np.arange(mesh.size), [mesh.shape[a] for a in mesh.axis_names]), 1)
    pos = {a: k for k, a in enumerate(mesh.axis_names)}
    slab_of = np.ravel_multi_index([coords[:, pos[a]] for a in axes],
                                   [mesh.shape[a] for a in axes])
    perm = np.argsort(slab_of)
    return torch.cat([full[r * rows:(r + 1) * rows] for r in perm])


def on_mesh_device(operand, cfg: RenderConfig, mesh: Mesh):
    """The operand prepared (or for bruteforce moved) onto the mesh's
    device; a PreparedScene must already be there."""
    from ..render.renderer import ensure_prepared
    op = ensure_prepared(operand, cfg, mesh.device)
    if op.device != mesh.device:
        raise ValueError(f"the scene is on {op.device}, the mesh on "
                         f"{mesh.device}")
    return op


def render_radiance_sharded(prep_or_scene, cfg: RenderConfig, light_pos,
                            mesh: Mesh, axis: str = "dp"):
    """Full-frame float render, rays sharded over ``mesh`` ``axis``.

    Returns (radiance [H, W, 3], hit [H, W]) on every process of the axis.
    The scene is replicated; each process renders an equal contiguous slab
    of the row-major rays (padded with the last ray to a multiple of the
    axis size): ``render_flat`` in bruteforce mode, ``render_flat_bvh`` in
    BVH mode (both ``cfg.ray_chunk`` rays at a time, as the unsharded
    frame), ``render_flat_tiled`` with no camera in tiled mode."""
    from ..accel import traverse
    from ..kernels import tiled
    from ..render.renderer import _map_ray_chunks, render_flat
    if cfg.mode not in ("bruteforce", "bvh", "tiled"):
        raise ValueError(f"unknown render mode: {cfg.mode}")
    if cfg.mode != "bruteforce" and not isinstance(prep_or_scene,
                                                   PreparedScene):
        raise TypeError(f"mode {cfg.mode!r} needs a PreparedScene")
    op = on_mesh_device(prep_or_scene, cfg, mesh)
    ax = mesh.axis(axis)
    cam = cfg.camera
    o, d = primary_rays(cam.width, cam.height, cam.focal, cam.normalize_dirs,
                        device=op.device)
    o, d, R = pad_rays(o.reshape(-1, 3), d.reshape(-1, 3), ax.size)
    o, d = slab(o, ax.index, ax.size), slab(d, ax.index, ax.size)
    light = torch.as_tensor(light_pos, dtype=torch.float32, device=op.device)
    if cfg.mode == "tiled":
        rad, hit = tiled.render_flat_tiled(op, cfg, light, None, rays=(o, d))
    else:
        flat = op.scene if isinstance(op, PreparedScene) else op
        body = ((lambda oo, dd: render_flat(flat, cfg, oo, dd, light))
                if cfg.mode == "bruteforce" else
                (lambda oo, dd: traverse.render_flat_bvh(op, cfg, oo, dd,
                                                         light)))
        rad, hit = _map_ray_chunks(body, o, d, cfg.ray_chunk)
    # one collective for both: the hit mask rides as a fourth column
    full = ax.all_gather(torch.cat([rad, hit.to(rad.dtype)[:, None]], 1))
    H, W = cam.height, cam.width
    return (full[:R, :3].reshape(H, W, 3),
            (full[:R, 3] != 0).reshape(H, W))


def render_sharded(prep_or_scene, cfg: RenderConfig, light_pos, mesh: Mesh,
                   axis: str = "dp") -> torch.Tensor:
    """Data-parallel full-frame render -> [H, W, 3] uint8 on every process
    of the axis."""
    op = on_mesh_device(prep_or_scene, cfg, mesh)
    rad, hit = render_radiance_sharded(op, cfg, light_pos, mesh, axis)
    return integrator.finalize_image(rad, hit, cfg)


__all__ = ["Axis", "Mesh", "gather_slabs", "make_mesh",
           "render_radiance_sharded", "render_sharded", "slab", "slab_index",
           "world_of_one"]
