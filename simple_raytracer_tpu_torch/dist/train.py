"""Differentiable rendering as training: scene parameters fit to a target
image by gradient descent (JAX ``dist/train.py``):

    loss(params) = sum((render(params) - target)**2) / (width * height)

``make_train_step`` builds the step; autograd gives the gradients.  With a
mesh (dist/sharding.py) the rays are split into contiguous slabs over one
axis, each process computes its slab's share of the loss and its gradients,
and ``all_reduce`` sums them (JAX inserts that psum through AD).
``make_train_step_composed`` shards the rays over two axes and the
triangles over one, rendering through the ring (dist/ring.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..accel.prepared import PreparedScene, target_device
from ..config import RenderConfig
from ..diff.render import render_radiance_diff
from ..kernels.plan import effective_tile_px
from ..ops.camera import primary_rays, primary_rays_tiled
from .sharding import slab, slab_index


@dataclasses.dataclass
class DiffParams:
    """The differentiable subset of the scene: vertices, materials, light
    and texture atlas.  JAX's fields in JAX's order, so the leaves of a
    checkpoint (utils/checkpoint.py) line up between the packages."""

    verts: torch.Tensor         # [T, 3, 4]
    obj_color: torch.Tensor     # [O, 3]
    obj_ambient: torch.Tensor   # [O]
    obj_specular: torch.Tensor  # [O]
    obj_shininess: torch.Tensor # [O]
    tex_data: torch.Tensor      # [P, 3]
    light_pos: torch.Tensor     # [3]

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def extract_params(scene, light_pos) -> DiffParams:
    """The scene's differentiable tensors (detached) and the light."""
    return DiffParams(
        verts=scene.verts.detach(), obj_color=scene.obj_color.detach(),
        obj_ambient=scene.obj_ambient.detach(),
        obj_specular=scene.obj_specular.detach(),
        obj_shininess=scene.obj_shininess.detach(),
        tex_data=scene.tex_data.detach(),
        light_pos=torch.as_tensor(light_pos, dtype=torch.float32,
                                  device=scene.device).detach())


def apply_params(scene, p: DiffParams):
    """Rebind the params into the scene; returns (scene, light)."""
    return dataclasses.replace(
        scene, verts=p.verts, obj_color=p.obj_color,
        obj_ambient=p.obj_ambient, obj_specular=p.obj_specular,
        obj_shininess=p.obj_shininess, tex_data=p.tex_data), p.light_pos


@dataclasses.dataclass
class ReplicatedParams:
    """The params that stay replicated under geometry sharding (materials,
    texture atlas, light; per-triangle data rides in the shards).  JAX's
    fields in JAX's order."""

    obj_color: torch.Tensor
    obj_ambient: torch.Tensor
    obj_specular: torch.Tensor
    obj_shininess: torch.Tensor
    tex_data: torch.Tensor
    light_pos: torch.Tensor

    def leaves(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def params_from_jax(arrays, device="cuda", cls=DiffParams):
    """The JAX package's ``DiffParams`` (or, with ``cls``,
    ``ReplicatedParams``) as numpy arrays, its leaves in order as
    ``jax.tree.leaves`` gives them -> the port's, as float32 tensors on
    ``device``: how weights are carried across."""
    dev = target_device(device)
    n = len(dataclasses.fields(cls))
    if len(arrays) != n:
        raise ValueError(f"{len(arrays)} leaves, {cls.__name__} has {n}")
    return cls(*[torch.from_numpy(np.array(a, np.float32)).to(dev)
                 for a in arrays])


def _reduced(leaves, loss, mesh, axes):
    """(loss, gradients of ``leaves``) summed over the processes of
    ``mesh``'s ``axes`` (as given, without a mesh); a leaf the loss does
    not reach has gradient 0."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if mesh is not None:
        ax = mesh.axis(axes)
        ax.all_reduce(loss)
        for g in grads:
            ax.all_reduce(g)
    return loss, grads


def make_train_step(scene, cfg: RenderConfig, mesh=None, axis: str = "dp",
                    lr: float = 1e-3, remat: bool = False,
                    optimizer: Optional[Callable] = None):
    """A step fitting DiffParams to a target radiance image [H, W, 3].

    Returns ``step(params, target) -> (params, loss)``, the SGD update
    ``p - lr * grad``.  With ``optimizer``, a factory of a
    ``torch.optim.Optimizer`` over a list of tensors (optax's place in
    JAX), it returns ``step(params, opt_state, target) -> (params,
    opt_state, loss)``, and ``step.init(params)`` builds the first
    opt_state.  The SGD step's ``step.value_and_grad(params, target) ->
    (loss, DiffParams of gradients)`` is the step without its update, and
    ``step.loss_fn(params, target)`` the loss alone, differentiable.

    ``scene`` is a Scene, or a PreparedScene, whose ``scene`` (the padded,
    BVH-ordered triangles) the params must come from.  With a PreparedScene
    in ``"bvh"`` or ``"tiled"`` mode the loss renders through that mode's
    intersector and the fixed-topology recompute (diff/render.py): the only
    form that scales to 1080p on a mesh of bunny scale.  Every other case
    renders in bruteforce mode, through the same recompute (the hits under
    ``no_grad``, Möller–Trumbore at the winners), which gives the gradient
    of autograd through every triangle pass without keeping the passes.
    The tiled rays go in tile-major order, as the frame's; the target is
    reordered to match and the rays past the frame's edge are masked out.

    ``remat`` recomputes the forward render in the backward
    (``torch.utils.checkpoint``): the intersectors run twice a step.
    The tiled walks are kernels/table.py's (``table.using(table.plain())``
    for the plain walks).

    With ``mesh`` (dist/sharding.py; the scene on its device), the step's
    rays (tile-major in tiled mode) are split into equal contiguous slabs
    over ``axis``, with their target rows and mask; each process takes its
    slab's loss over width * height and its gradients, ``all_reduce`` sums
    both over the axis, and every process applies the same update.  On an
    axis of one process the step equals the step without a mesh bit for
    bit.  ``step.loss_fn`` is then this process's share."""
    prep = scene if isinstance(scene, PreparedScene) else None
    base = prep.scene if prep is not None else scene
    dev = base.device
    if mesh is not None and dev != mesh.device:
        raise ValueError(f"the scene is on {dev}, the mesh on "
                         f"{mesh.device}")
    cam = cfg.camera
    fast = prep is not None and cfg.mode in ("bvh", "tiled")
    fwd_cfg = cfg if fast else cfg.replace(mode="bruteforce")
    tile_layout = None
    if fast and cfg.mode == "tiled":
        # tile-major rays, as the frame's: row-major rays would give the
        # tiled plans row slivers with loose direction bounds
        tpx = effective_tile_px(cfg, base.num_triangles)
        o, d, tx, ty = primary_rays_tiled(cam.width, cam.height, tpx,
                                          cam.focal, cam.normalize_dirs,
                                          device=dev)
        tile_layout = (tpx, tx, ty)
    else:
        o, d = primary_rays(cam.width, cam.height, cam.focal,
                            cam.normalize_dirs, device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    n_pixels = cam.width * cam.height
    part = lambda x: x                    # this process's rows
    if mesh is not None:
        ax = mesh.axis(axis)
        if o.shape[0] % ax.size:
            raise ValueError(f"rays {o.shape[0]} not divisible by mesh axis "
                             f"{ax.size}")
        part = lambda x: slab(x, ax.index, ax.size)
        o, d = part(o), part(d)

    def flat_target(target):
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        if tile_layout is None:
            return target.reshape(-1, 3)
        tpx, tx, ty = tile_layout
        tt = F.pad(target, (0, 0, 0, tx * tpx - cam.width,
                            0, ty * tpx - cam.height))
        return tt.reshape(ty, tpx, tx, tpx, 3).permute(
            0, 2, 1, 3, 4).reshape(-1, 3)

    # the tile-major frame is padded with real rays past its edge, which
    # may hit geometry while the target is zero there: a ones image through
    # the same padding is the mask that keeps them out of the loss
    mask = part(flat_target(torch.ones((cam.height, cam.width, 3),
                                       device=dev))[:, :1])

    def render_loss(params: DiffParams, target_flat):
        s, light = apply_params(base, params)
        operand = dataclasses.replace(prep, scene=s) if fast else s
        radiance, hit = render_radiance_diff(
            operand, fwd_cfg, light, origin=o, direction=d,
            apex=tile_layout is not None)
        pred = torch.where(hit[:, None], radiance, 0.0) * mask
        return ((pred - target_flat) ** 2).sum()

    def loss_fn(params: DiffParams, target):
        # over width * height before the all-reduce, so that one process
        # divides where the step without a mesh does
        tt = part(flat_target(target))
        if remat:
            return checkpoint(render_loss, params, tt,
                              use_reentrant=False) / n_pixels
        return render_loss(params, tt) / n_pixels

    def value_and_grad(params: DiffParams, target):
        leaves = [p.detach().requires_grad_(True) for p in params.leaves()]
        loss, grads = _reduced(leaves, loss_fn(DiffParams(*leaves), target),
                               mesh, axis)
        return loss, DiffParams(*grads)

    if optimizer is not None:
        def init(params: DiffParams):
            return optimizer([p.detach().clone().requires_grad_(True)
                              for p in params.leaves()])

        def opt_step(params: DiffParams, opt_state, target):
            leaves = opt_state.param_groups[0]["params"]
            with torch.no_grad():
                for leaf, p in zip(leaves, params.leaves()):
                    leaf.copy_(p)
            opt_state.zero_grad(set_to_none=False)
            loss, grads = _reduced(leaves, loss_fn(DiffParams(*leaves),
                                                   target), mesh, axis)
            for leaf, g in zip(leaves, grads):
                leaf.grad = g
            opt_state.step()
            return (DiffParams(*[x.detach().clone() for x in leaves]),
                    opt_state, loss)

        opt_step.init = init
        return opt_step

    def step(params: DiffParams, target):
        loss, grads = value_and_grad(params, target)
        with torch.no_grad():
            new = [p.detach() - lr * g for p, g in
                   zip(params.leaves(), grads.leaves())]
        return DiffParams(*new), loss

    step.value_and_grad = value_and_grad
    step.loss_fn = loss_fn
    return step



def make_train_step_composed(scene, cfg: RenderConfig, mesh,
                             dp_axis: str = "dp", gp_axis: str = "gp",
                             lr: float = 1e-3):
    """The composed DP x geometry-parallel step over a 2-D mesh (JAX
    ``train.py:226-291``).

    The row-major rays are sharded over both axes (dp major: every process
    owns a home slab), the triangles over ``gp_axis`` (replicated over
    ``dp_axis``), and each process renders its slab around its gp ring
    (dist/ring.py::render_flat_ring).  Materials, light and texture atlas
    are differentiable through the shading (``ReplicatedParams``);
    per-triangle data is not.  Each process's loss and gradients are
    summed over the whole mesh, and the SGD update is the same on every
    process.  Returns (step, params0, shard): ``step(params, target [H, W,
    3]) -> (params, loss)``, the scene's params with the light at zeros
    (as JAX's), and this process's GeometryShard."""
    from .ring import render_flat_ring, shard_geometry
    dev = mesh.device
    scene = scene.to(dev)
    cam = cfg.camera
    o, d = primary_rays(cam.width, cam.height, cam.focal, cam.normalize_dirs,
                        device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    R = o.shape[0]
    axes = (dp_axis, gp_axis)
    n_total = mesh.shape[dp_axis] * mesh.shape[gp_axis]
    if R % n_total:
        raise ValueError(f"rays {R} not divisible by {n_total} processes")
    gp = mesh.axis(gp_axis)
    shard = shard_geometry(scene, gp.size, cfg, device="cpu")[gp.index]
    shard = shard.to(dev)
    k = slab_index(mesh, axes)
    oo, dd = slab(o, k, n_total), slab(d, k, n_total)

    def loss_fn(params: ReplicatedParams, target):
        s = dataclasses.replace(
            scene, obj_color=params.obj_color, obj_ambient=params.obj_ambient,
            obj_specular=params.obj_specular,
            obj_shininess=params.obj_shininess, tex_data=params.tex_data)
        rad, hit = render_flat_ring(s, shard, cfg, oo, dd, params.light_pos,
                                    gp, apex=True)
        pred = torch.where(hit[:, None], rad, 0.0)
        tt = slab(torch.as_tensor(target, dtype=torch.float32,
                                  device=dev).reshape(-1, 3), k, n_total)
        return ((pred - tt) ** 2).sum() / R

    def step(params: ReplicatedParams, target):
        leaves = [p.detach().requires_grad_(True) for p in params.leaves()]
        loss, grads = _reduced(leaves, loss_fn(ReplicatedParams(*leaves),
                                               target), mesh, axes)
        with torch.no_grad():
            new = [p.detach() - lr * g for p, g in zip(leaves, grads)]
        return ReplicatedParams(*new), loss

    step.loss_fn = loss_fn
    params0 = ReplicatedParams(
        obj_color=scene.obj_color.detach(),
        obj_ambient=scene.obj_ambient.detach(),
        obj_specular=scene.obj_specular.detach(),
        obj_shininess=scene.obj_shininess.detach(),
        tex_data=scene.tex_data.detach(),
        light_pos=torch.zeros(3, dtype=torch.float32, device=dev))
    return step, params0, shard
