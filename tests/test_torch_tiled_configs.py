"""PyTorch port, the tiled configurations that take no pixel rebuild or no
cull lists: ``hit_tile`` sub-tiles, normalized primary directions, and
range-only plans (``cull_maxv`` <= 0, or more than 65,536 windows or
pages).

Both packages get the same padded, BVH-ordered scene (``from_jax_prepared``)
and the same rays, handed to both as numpy arrays; the JAX kernels run in
interpret mode.  Bars: plans equal as int32; K1's fetch mode over explicit
rays at the nearest kernel's bars (t rtol 1e-4 / atol 1e-6, idx equal on
>= 99.9%, the attribute rows equal where idx is); frames at the JAX
package's image bars (tests/test_tiled.py:90-94: within 1 on >= 99.9% of
pixels, equal on >= 98%), with spies on the JAX side showing which of its
steps ran.  A walk over a range-only plan gives the list plan's (t, idx) on
every lane, and so the same gradients.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.dist.train import (DiffParams, apply_params,
                                                   extract_params)
from simple_raytracer_tpu_torch.diff.render import render_radiance_diff
from simple_raytracer_tpu_torch.kernels import nearest, paged, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.kernels import tiled
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.render.integrator import finalize_image
from simple_raytracer_tpu_torch.render.renderer import render

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled as jtiled
from simple_raytracer_tpu.kernels import tiled_t
from simple_raytracer_tpu.ops.camera import primary_rays_tiled, untile_image
from simple_raytracer_tpu.render import integrator as jint

from _torch_parity import (LIGHT, VIEW, configs, jax_prepared_arrays,
                           managers)

W = H = 64
FOCAL = 200.0
TPX = 32
TILE = TPX * TPX
SUB = 256
MAXV = 248
S4 = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when
    other test processes load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(x):
    return jnp.asarray(x.numpy())


_SCENES = {}


def _scene(textured: bool = False):
    """(port PreparedScene on the CPU, JAX PreparedScene) of the parity
    scene (icosphere(2) on the box ground) or its textured variant."""
    if textured not in _SCENES:
        _, jsm = managers(2, textured=textured)
        _cfg, jcfg = configs()
        jprep = jprepare(jsm.build(), jcfg)
        prep = from_jax_prepared(jax_prepared_arrays(jprep),
                                 has_textures=textured,
                                 num_triangles=int(jprep.num_triangles),
                                 page_tris=_cfg.bvh.page_tris, device="cpu")
        _SCENES[textured] = prep, jprep
    return _SCENES[textured]


def _configs(S: int = 1, **change):
    """(port, JAX) RenderConfig of the 64x64 frame at 32-pixel tiles."""
    cfg, jcfg = configs(num_samples=S)
    cam = dict(width=W, height=H, focal=FOCAL,
               normalize_dirs=change.pop("normalize_dirs", False))
    cfg = cfg.replace(tile_px=TPX, camera=sr.CameraConfig(**cam), **change)
    jcfg = jcfg.replace(tile_px=TPX, camera=type(jcfg.camera)(**cam),
                        **change)
    return cfg, jcfg


def _rays(view=VIEW, normalize: bool = False):
    """The frame's tile-major primary rays (o, d) [R, 3], port tensors."""
    vm = None if view is None else torch.from_numpy(view)
    o, d, _, _ = tcam.primary_rays_tiled(W, H, TPX, FOCAL, normalize,
                                         view_matrix=vm)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _jax_frame(jprep, jcfg, monkeypatch, module, expect):
    """JAX ``render_flat_tiled`` on the frame (the moved view), as JAX's
    renderer calls it (no cam_spec for normalized rays), asserting that of
    the steps ``hits``, ``hits_attrs``, ``hits_shaded``, ``anyhit`` and
    ``anyhit_from_t`` of ``module`` exactly ``expect`` ran, in order.
    Returns the image (uint8)."""
    called = []
    for name in ("hits", "hits_attrs", "hits_shaded", "anyhit",
                 "anyhit_from_t"):
        orig = getattr(module, name, None)
        if orig is not None:
            monkeypatch.setattr(
                module, name,
                lambda *a, _o=orig, _n=name, **k: (called.append(_n),
                                                   _o(*a, **k))[1])
    norm = jcfg.camera.normalize_dirs
    V = jnp.asarray(VIEW, jnp.float32)
    o, d, tx, ty = primary_rays_tiled(W, H, TPX, FOCAL, norm, view_matrix=V)
    cam_spec = None if norm else (V, FOCAL, W, H, TPX)
    rad, hit = jtiled.render_flat_tiled(
        jprep, jcfg, o.reshape(-1, 3), d.reshape(-1, 3), jnp.asarray(LIGHT),
        cam_spec=cam_spec)
    assert called == list(expect), called
    rad = untile_image(rad.reshape(-1, 3), W, H, TPX, tx, ty)
    hit = untile_image(hit.reshape(-1), W, H, TPX, tx, ty)
    return np.asarray(jint.finalize_image(rad, hit, jcfg))


FETCH = ("hits_attrs", "anyhit")
GATHER = ("hits", "anyhit")
# (textured scene, samples, config change, the port's branch, the JAX
# module spied, the steps JAX runs)
FRAMES = {
    "flat_s1_sub": (False, 1, dict(hit_tile=SUB), "soft", tiled_t, FETCH),
    "flat_s4_sub": (False, S4, dict(hit_tile=SUB), "soft", tiled_t, FETCH),
    "textured_sub": (True, 1, dict(hit_tile=SUB), "gather", tiled_t,
                     GATHER),
    "flat_s1_normalized": (False, 1, dict(normalize_dirs=True), "soft",
                           tiled_t, FETCH),
    "flat_s4_normalized": (False, S4, dict(normalize_dirs=True), "soft",
                           tiled_t, FETCH),
    "textured_normalized": (True, 1, dict(normalize_dirs=True), "gather",
                            tiled_t, GATHER),
    "flat_s1_maxv0": (False, 1, dict(cull_maxv=0), "gather", tiled_t,
                      GATHER),
    "flat_s4_maxv0": (False, S4, dict(cull_maxv=0), "gather", tiled_t,
                      GATHER),
    "textured_maxv0": (True, 1, dict(cull_maxv=0), "gather", tiled_t,
                       GATHER),
    "paged_maxv0": (False, 1, dict(cull_maxv=0, tiled_impl="paged"),
                    "paged", jtiled, GATHER),
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_frame_matches_jax(frame, monkeypatch):
    """Each configuration renders through both packages, the port in the
    branch that JAX's steps name, with no kernel launch on the CPU."""
    tex, S, change, branch, module, steps = FRAMES[frame]
    prep, jprep = _scene(tex)
    cfg, jcfg = _configs(S, **change)
    assert tiled.frame_branch(prep, cfg, TILE) == branch
    jimg = _jax_frame(jprep, jcfg, monkeypatch, module, steps)
    n0 = table.calls()
    img = render(prep, cfg, LIGHT, view_matrix=VIEW).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert table.calls() == n0
    assert img.shape == (H, W, 3)
    diff = np.abs(img.astype(int) - jimg.astype(int))
    print(f"frame {frame}: {int((diff > 0).any(-1).sum())} pixels differ, "
          f"max {int(diff.max())}")
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    bg = (img == np.array(cfg.background, np.uint8)).all(-1)
    assert 0.2 < (~bg).mean() < 0.95


def _excl(n: int, seed: int = 4):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(-2, 2, n).astype(np.int32))


def _shadow_rays():
    """Shadow rays toward the light from the frame's points at t = 60,
    ragged: the last tile is cut short."""
    o, d = _rays()
    p = (o + 60.0 * d / d.norm(dim=1, keepdim=True))[:-100]
    return p, torch.tensor(LIGHT) - p


@pytest.mark.parametrize("case", ["nearest", "nearest_grouped",
                                  "occlusion_hourglass", "occlusion_grouped",
                                  "pages", "pages_occlusion"])
def test_range_plan_matches_jax(case):
    """The range-only plans (``maxv`` 0) equal JAX's as int32: the nearest
    plan of primary rays (JAX ``tiled_t.cull`` drops the projective test
    there), the occlusion plan over any-hit windows with the hourglass
    test and each tile's own object dropped, the grouped plans of either
    (their width kept, zero mask words), and the page ranges of JAX
    ``kernels/tiled.py::_cull`` and ``cull_occl``."""
    prep, jprep = _scene()
    kc = sr.KernelConfig()
    if case.startswith("nearest"):
        o, d = _rays()
        tile, groups = SUB, 4 if case == "nearest_grouped" else 1
        ours = pl.cull_rays(prep, o, d, tile, 0, kc.window_blocks,
                            groups=groups)
        theirs = tiled_t.cull(jprep, _j(o), _j(d), tile, 0, groups=groups,
                              apex=True)
    elif case.startswith("occlusion"):
        o, d = _shadow_rays()
        tile, groups = TILE, 4 if case == "occlusion_grouped" else 1
        excl = _excl(-(-o.shape[0] // tile))
        ours = pl.cull_occl(prep, o, d, tile, 0, kc.window_blocks_ah, excl,
                            hourglass=True, groups=groups)
        theirs = tiled_t.cull(jprep, _j(o), _j(d), tile, 0, _j(excl),
                              wb=kc.window_blocks_ah, groups=groups,
                              hourglass=True)
    elif case == "pages":
        o, d = _rays()
        tile = SUB
        ours = paged.cull(prep, None, o, d, tile, 0, apex=True)
        theirs = jtiled._cull(_j(o), _j(d), tile, jprep, 0, apex=True)
    else:
        o, d = _shadow_rays()
        tile = TILE
        excl = _excl(-(-o.shape[0] // tile))
        ours = paged.cull_occl(prep, None, o, d, tile, 0, excl,
                               hourglass=True)
        theirs = jtiled._cull(_j(o), _j(d), tile, jprep, 0, _j(excl),
                              hourglass=True)
    theirs = np.asarray(theirs)
    assert ours.dtype == torch.int32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert (ours[:, 2:].numpy() == 0).all() and (ours[:, 1] > 0).any()


def _synthetic(num_blocks: int, seed: int = 7):
    """(port, JAX) stand-ins of a PreparedScene with ``num_blocks`` random
    32-triangle block boxes, most of them in front of the camera, on the
    CPU: the cull reads nothing else."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform([-40.0, -40.0, 20.0], [40.0, 40.0, 200.0],
                     (num_blocks, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2.0, (num_blocks, 3)).astype(np.float32)
    obj = rng.integers(0, 3, num_blocks).astype(np.int32)
    page_tris = 128
    num_pages = num_blocks * 32 // page_tris
    port = types.SimpleNamespace(
        device=torch.device("cpu"), num_blocks=num_blocks, block_size=32,
        page_tris=page_tris, num_pages=num_pages,
        block_min=torch.from_numpy(lo), block_max=torch.from_numpy(hi),
        block_obj=torch.from_numpy(obj))
    jax = types.SimpleNamespace(
        block_size=32, page_tris=page_tris, num_pages=num_pages,
        block_min=jnp.asarray(lo), block_max=jnp.asarray(hi),
        block_obj=jnp.asarray(obj))
    return port, jax


@pytest.mark.parametrize("case", ["windows", "pages"])
def test_route_over_65536_units(case):
    """Past 65,536 windows (131,076 blocks: 65,538 windows of 2) or pages
    (262,148 blocks: 65,537 pages of 4 blocks), list entries cannot name
    their unit: with list capacity asked for, both packages plan ranges
    only, and their plans are equal; one unit fewer keeps the lists."""
    o, d = _rays()
    o, d = o[:4 * SUB], d[:4 * SUB]
    if case == "windows":
        port, jax = _synthetic(131076)
        ours = pl.cull_rays(port, o, d, SUB, MAXV, 2)
        theirs = tiled_t.cull(jax, _j(o), _j(d), SUB, MAXV, apex=True)
        assert port.num_blocks // 2 == 65538
        assert not pl.range_only(MAXV, 65536)
    else:
        port, jax = _synthetic(262148)
        ours = paged.cull(port, None, o, d, SUB, MAXV, apex=True)
        theirs = jtiled._cull(_j(o), _j(d), SUB, jax, MAXV, apex=True)
        assert port.num_pages == 65537
    theirs = np.asarray(theirs)
    assert pl.range_only(MAXV, 65537)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert (ours[:, 3] == 0).all() and (ours[:, 1] > 0).all()


def test_fetch_over_rays_plain_matches_jax():
    """K1's fetch mode over explicit rays (``hits_attrs`` with no cam_spec,
    the plain version on the CPU) against JAX ``tiled_t.hits_attrs`` with
    cam_spec None, on the sub-tiles of the frame's primary rays."""
    prep, jprep = _scene()
    cfg, _ = _configs()
    o, d = _rays()
    jt, ji, ja = tiled_t.hits_attrs(jprep, _j(o), _j(d), SUB, cfg.mt_eps,
                                    MAXV, apex=True, cam_spec=None)
    jrec = jint.records_from_attrs(jprep.scene, ja)
    t, idx, a = nearest.hits_attrs(prep, cfg, None, MAXV, rays=(o, d),
                                   tile=SUB)
    jt, ji = np.asarray(jt), np.asarray(ji)
    t, idx, a = t.numpy(), idx.numpy(), a.numpy()
    hj, ho = np.isfinite(jt), np.isfinite(t)
    assert ho.sum() > 0.3 * t.size and (hj == ho).mean() > 0.999
    both = hj & ho
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)
    assert (idx == ji).mean() >= 0.999
    same = (idx == ji) & ho
    np.testing.assert_array_equal(a[same, :3], np.asarray(jrec["normal"])
                                  [same])
    np.testing.assert_array_equal(a[same, 3].astype(np.int32),
                                  np.asarray(jrec["obj"])[same])
    assert (a[~ho] == [0.0, 0.0, 0.0, -1.0]).all() and (idx[~ho] == -1).all()


def test_fetch_over_rays_plain_is_the_rays_walk_and_its_rows():
    """The fetch mode's plain version is the rays walk's (t, idx) with the
    winners' tri_attr rows, on a plan with list and range rows."""
    prep, _ = _scene()
    cfg, _ = _configs()
    o, d = _rays()
    wb = cfg.kernel.window_blocks
    plan = pl.cull_rays(prep, o, d, SUB, 4, wb)
    assert (plan[:, 3] == 1).any() and (plan[:, 3] == 0).any()
    o3, d3 = o.reshape(-1, SUB, 3), d.reshape(-1, SUB, 3)
    wt = wb * prep.block_size
    t, idx, a = nearest.tiled_nearest_rays_attrs_plain(
        plan, prep.tri, prep.tri_attr, o3, d3, wt, cfg.mt_eps)
    rt, ri = nearest.tiled_nearest_rays_plain(plan, prep.tri, o3, d3, wt,
                                              cfg.mt_eps)
    assert torch.equal(t, rt) and torch.equal(idx, ri)
    hit = (idx >= 0).reshape(-1)
    assert torch.equal(a[hit], prep.tri_attr[idx.reshape(-1)[hit].long()])
    assert (a[~hit] == torch.tensor([0.0, 0.0, 0.0, -1.0])).all()
    assert a.shape == (o.shape[0], 4)


@pytest.mark.parametrize("walk", ["rays", "pages", "sub_tiles", "fused"])
def test_range_walk_equals_list_walk(walk):
    """On the same rays, a walk over a range-only plan (no early break)
    gives the list plan's (t, idx) on every lane: K1's rays mode, K6 over
    page ranges, and K1's fused mode over the frame's range-only plan
    (built from the rays, the pixel origins in columns 4/5); so does K1's
    fetch mode over sub-tiles of the explicit rays against their full
    tiles."""
    prep, _ = _scene()
    cfg, _ = _configs()
    o, d = _rays()
    cs = (torch.from_numpy(VIEW), FOCAL, W, H, TPX)
    if walk == "rays":
        a = nearest.hits(prep, cfg, o, d, SUB, MAXV)
        b = nearest.hits(prep, cfg, o, d, SUB, 0)
    elif walk == "pages":
        a = paged.hits(prep, cfg, o, d, SUB, MAXV, apex=True)
        b = paged.hits(prep, cfg, o, d, SUB, 0, apex=True)
    elif walk == "sub_tiles":
        a = nearest.hits_attrs(prep, cfg, None, MAXV, rays=(o, d), tile=TILE)
        b = nearest.hits_attrs(prep, cfg, None, MAXV, rays=(o, d), tile=SUB)
        assert torch.equal(a[2], b[2])
    else:
        light = torch.tensor(LIGHT)
        a = nearest.hits_shaded(prep, cfg, light, cs, MAXV)
        plan = nearest.primary_plan(prep, cfg, cs, 0, (o, d))
        assert (plan[:, 3] == 0).all() and (plan[:, 1] > 0).any()
        args = list(nearest.shaded_args(prep, cfg, light, cs, MAXV))
        args[0] = plan
        b = nearest.tiled_nearest_shaded_plain(*args)
        b = (b[0].reshape(-1), b[1].reshape(-1), b[2].reshape(-1), b[3])
        assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    assert torch.isfinite(a[0]).sum() > 0.3 * a[0].numel()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_range_walk_gradients_equal_list_walk():
    """The tiled gradients of sum(radiance**2) over the hit pixels with
    ``cull_maxv=0`` (range-only plans, the gather branch's walks) equal the
    list plans', bit for bit: the same winners."""
    prep, _ = _scene()
    cfg, _ = _configs()
    cfg = cfg.replace(mode="tiled", camera=sr.CameraConfig(
        width=32, height=32, focal=100.0))

    def grads(c):
        leaves = [x.clone().requires_grad_(True)
                  for x in extract_params(prep.scene, LIGHT).leaves()]
        s, lp = apply_params(prep.scene, DiffParams(*leaves))
        rad, hit = render_radiance_diff(dataclasses.replace(prep, scene=s),
                                        c, lp)
        loss = (torch.where(hit[..., None], rad, 0.0) ** 2).sum()
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), g

    loss, full = grads(cfg)
    loss0, ranged = grads(cfg.replace(cull_maxv=0))
    assert loss0 == loss and loss > 0
    for a, b in zip(ranged, full):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_wants_rays_and_branches():
    """The branch of each configuration, and which frames need the primary
    rays: every branch but the fused one, and a fused frame whose primary
    plan is range-only."""
    prep, _ = _scene()
    tprep, _ = _scene(True)
    cfg, _ = _configs()
    assert tiled.frame_branch(prep, cfg, TILE) == "fused"
    assert not tiled.wants_rays(prep, cfg, TILE)
    for c in (cfg.replace(hit_tile=SUB), cfg.replace(cull_maxv=0),
              cfg.replace(camera=sr.CameraConfig(width=W, height=H,
                                                 normalize_dirs=True))):
        assert tiled.wants_rays(prep, c, TILE)
    assert tiled.frame_branch(tprep, cfg, TILE) == "fused"
    assert tiled.frame_branch(tprep, cfg.replace(hit_tile=SUB),
                              TILE) == "gather"
    with pytest.raises(ValueError, match="sub-tile"):
        tiled.frame_branch(prep, cfg.replace(hit_tile=300), TILE)
    # over 65,536 windows the fused frame keeps its branch, its plan
    # range-only; over 65,536 any-hit windows its shadow turns legacy (the
    # shadow tile pinned to the tile: such scenes default to 256 rays)
    cfg = cfg.replace(shadow_tile=TILE)
    def stand_in(num_blocks):
        return types.SimpleNamespace(
            num_blocks=num_blocks, block_size=prep.block_size,
            scene=prep.scene, device=prep.device,
            block_min=torch.zeros((num_blocks, 3)),
            block_max=torch.ones((num_blocks, 3)))
    big = stand_in(2 * 65537)
    assert tiled.frame_branch(big, cfg, TILE) == "fused"
    assert tiled.wants_rays(big, cfg, TILE)
    huge = stand_in(4 * 65537)
    assert tiled.frame_branch(huge, cfg, TILE) == "legacy"
    with pytest.raises(ValueError, match="rays"):
        nearest.primary_plan(big, cfg, (None, FOCAL, W, H, TPX), MAXV)


def test_normalized_frame_renders_its_own_rays():
    """A normalized frame's t is along unit directions: its rays' hit
    points equal the unnormalized frame's, and its image is the same."""
    prep, _ = _scene()
    cfg, _ = _configs()
    ncfg, _ = _configs(normalize_dirs=True)
    rad, hit = sr.render_radiance(prep, cfg, LIGHT, view_matrix=VIEW)
    nrad, nhit = sr.render_radiance(prep, ncfg, LIGHT, view_matrix=VIEW)
    assert torch.equal(hit, nhit)
    a = finalize_image(rad, hit, cfg).int()
    b = finalize_image(nrad, nhit, ncfg).int()
    assert ((a - b).abs() <= 1).float().mean() > 0.999
