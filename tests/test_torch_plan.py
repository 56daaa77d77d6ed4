"""PyTorch port: the cull planners (kernels/plan.py).

Soundness: a walk over the plan must equal a walk with culling off, for the
primary plan (nearest hits) and for the shadow plan (occlusion), on the
parity scene and under a moved camera.  The O(tiles) bounds must match the
JAX package's, and so must the primary plan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import anyhit, nearest, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.ops import intersect as tis

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled_t

from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, managers)

VIEWS = {"identity": None, "moved": VIEW}


@pytest.fixture(scope="module")
def scene():
    sm, jsm = managers()
    cfg, jcfg = configs()
    return (prepare(sm.build(), cfg, device="cpu"),
            jprepare(jsm.build(), jcfg), cfg)


def _cam_spec(view):
    v = None if view is None else torch.from_numpy(view)
    return (v, FOCAL, WIDTH, HEIGHT, TILE_PX)


@pytest.fixture(scope="module")
def unculled(scene):
    """Walks with culling off, once per view, in the plain kernels'
    arithmetic: the nearest hit of every primary ray against every
    triangle, then from those hits the shadow test against every triangle
    of another object, with and without a max-t."""
    prep, _, cfg = scene
    cache = {}

    def get(view):
        if view in cache:
            return cache[view]
        vmx, focal, wd, hd, tpx = _cam_spec(VIEWS[view])
        n = (wd // tpx) * (hd // tpx)
        px0, py0 = pl.tile_origins(n, wd // tpx, tpx, wd, hd)
        cam = pl.make_cam(vmx, focal, LIGHT)
        d = [x.reshape(-1, 1) for x in tcam.tile_ray_dirs(cam, px0, py0, tpx)]
        g = [prep.tri[None, :, i] for i in range(9)]
        t = tis.mt_distance(*tis.mt_numerators(
            (cam[9], cam[10], cam[11]), d, g[0:3], g[3:6], g[6:9]))
        bt, bi = t.min(dim=-1)                       # [R], lowest id on ties
        hit = torch.isfinite(bt)
        bi = torch.where(hit, bi.to(torch.int32), -1)
        ts = torch.where(hit, bt, 0.0)[:, None]
        p = [cam[9 + c] + ts * d[c] for c in range(3)]
        s = [cam[12 + c] - p[c] for c in range(3)]
        num = tis.mt_numerators(p, s, g[0:3], g[3:6], g[6:9])
        other = prep.scene.tri_obj[None, :] != \
            prep.scene.tri_obj[bi.clamp_min(0).long()][:, None]
        occ = {m: (tis.mt_occludes(*num, cfg.mt_eps, m) & other).any(dim=1)
               for m in (True, False)}
        cache[view] = (bt, bi, occ)
        return cache[view]
    return get


@pytest.mark.parametrize("view", list(VIEWS))
def test_primary_plan_walk_equals_unculled(scene, unculled, view):
    prep, _, cfg = scene
    caught = []
    with table.using({"nearest_shaded": table.spy("nearest_shaded", caught)}):
        t, idx, obj, _rgb, _b = nearest.hits_shaded(
            prep, cfg, torch.tensor(LIGHT), _cam_spec(VIEWS[view]),
            cfg.cull_maxv)
    bt, bi, _ = unculled(view)
    assert torch.isfinite(bt).sum() > 4000
    assert torch.equal(t, bt)
    assert torch.equal(idx, bi)
    plan = caught[0][0]
    assert (plan[:, 3] == 1).all()                    # every tile in list mode
    # the walk skips windows: the plan is a strict subset of the scene
    assert (plan[:, 2] < prep.num_blocks // cfg.kernel.window_blocks).all()


def test_range_mode_walk_equals_unculled(scene, unculled):
    """Tiles over the list capacity walk their covering window range."""
    prep, _, cfg = scene
    caught = []
    with table.using({"nearest_shaded": table.spy("nearest_shaded", caught)}):
        t, idx, *_ = nearest.hits_shaded(
            prep, cfg, torch.tensor(LIGHT), _cam_spec(None), 2)
    bt, bi, _ = unculled("identity")
    assert (caught[0][0][:, 3] == 0).any()
    assert torch.equal(t, bt)
    assert torch.equal(idx, bi)


def test_plan_entries_are_front_to_back(scene):
    prep, _, cfg = scene
    cs = _cam_spec(None)
    ab = pl.tile_bounds_plain(pl.camera_plain(prep, cs), cs, 4)
    plan = pl.cull(prep, cfg.cull_maxv, 2, ab, apex=True)
    for row in plan:
        cnt = int(row[2])
        e = row[pl.PLAN_AUX:pl.PLAN_AUX + cnt].long()
        b16 = e >> 16
        assert (b16[1:] >= b16[:-1]).all()
        w = e & 0xFFFF
        assert len(set(w.tolist())) == cnt
        lo, rng = int(row[0]), int(row[1])
        assert w.min() == lo and w.max() == lo + rng - 1


@pytest.mark.parametrize("view", list(VIEWS))
@pytest.mark.parametrize("no_max_t", [True, False])
def test_shadow_plan_walk_equals_unculled(scene, unculled, view, no_max_t):
    """The shadow plan (bounds rows -> interval + light-apex tests, minus
    each pure tile's own object) loses no occluder: its walk equals an
    any-hit test against every triangle of every other object."""
    prep, _, cfg = scene
    cfg = cfg.replace(light=type(cfg.light)(shadow_no_max_t=no_max_t))
    cs = _cam_spec(VIEWS[view])
    light = torch.tensor(LIGHT)
    cam = pl.camera(prep, cs, light)
    t, idx, obj, _rgb, bounds = nearest.hits_shaded(prep, cfg, light, cs,
                                                    cfg.cull_maxv, cam=cam)
    found = anyhit.anyhit_from_t(prep, cfg, t, obj, bounds, cam, cs,
                                 cfg.cull_maxv)
    bt, _, occ = unculled(view)
    assert torch.equal(t, bt)
    hit = torch.isfinite(t)
    ref = occ[no_max_t]
    assert ref[hit].sum() > 50                       # shadows in view
    assert torch.equal(found[hit], ref[hit])
    assert found[~hit].all()                         # miss lanes read True


@pytest.mark.parametrize("view", list(VIEWS))
def test_analytic_bounds_match_jax(scene, view):
    vm = VIEWS[view]
    cs = _cam_spec(vm)
    jcs = (None if vm is None else jnp.asarray(vm), FOCAL, WIDTH, HEIGHT,
           TILE_PX)
    ours = pl.tile_bounds_plain(pl.camera_plain(scene[0], cs), cs, 4)
    theirs = tiled_t.analytic_tile_bounds(jcs, 4)
    for k in ("omin", "omax", "dmin", "dmax", "s", "v", "w", "apex",
              "ru_lo", "ru_hi", "rv_lo", "rv_hi", "dw_hi"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.array_equal(ours["tile_bad"].numpy(),
                          np.asarray(theirs["tile_bad"]))


@pytest.mark.parametrize("view", list(VIEWS))
def test_primary_plan_matches_jax(scene, view):
    prep, jprep, cfg = scene
    vm = VIEWS[view]
    cs = _cam_spec(vm)
    ours = pl.cull(prep, cfg.cull_maxv, 2, pl.tile_bounds_plain(
        pl.camera_plain(prep, cs), cs, 4), apex=True)
    jcs = (None if vm is None else jnp.asarray(vm), FOCAL, WIDTH, HEIGHT,
           TILE_PX)
    theirs = np.asarray(tiled_t.cull(
        jprep, None, None, TILE_PX * TILE_PX, cfg.cull_maxv, apex=True,
        ab=tiled_t.analytic_tile_bounds(jcs, 4)))
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_shadow_frame_and_bounds_match_jax(scene):
    prep, jprep, _ = scene
    ours = pl.shadow_frame(prep.block_min, prep.block_max, LIGHT)
    theirs = tiled_t.shadow_frame(jprep, jnp.asarray(LIGHT))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    rng = np.random.default_rng(5)
    b = rng.normal(size=(6, 15)).astype(np.float32)
    b[:, 6] = [1, 1, 0, 1, 1, 0]
    b[:, 13] = [0.5, -2.0, 1.0, -0.5, 3.0, 1.0]
    b[:, 14] = b[:, 13] + [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    o = pl.analytic_shadow_bounds_exact(torch.from_numpy(b), LIGHT, ours)
    j = tiled_t.analytic_shadow_bounds_exact(jnp.asarray(b),
                                             jnp.asarray(LIGHT), theirs)
    for k in ("omin", "omax", "dmin", "dmax", "apex", "ru_lo", "ru_hi",
              "rv_lo", "rv_hi"):
        np.testing.assert_allclose(o[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-6, err_msg=k)


HIT_TILES = [(0, 4096, 4096), (4096, 4096, 4096), (8192, 4096, 4096),
             (4096, 1024, 1024), (2048, 1024, 1024), (1024, 4096, 1024),
             (128, 1024, 128), (384, 4096, None), (100, 4096, None),
             (192, 1024, None)]


@pytest.mark.parametrize("hit_tile, tile, want", HIT_TILES)
def test_hit_tile_matches_jax(hit_tile, tile, want):
    """The port's nearest-pass tile against JAX kernels/tiled.py::_hit_tile:
    0 or any value of at least the tile is the full tile, a divisor that is
    a multiple of 128 is a sub-tile, anything else is refused (JAX asserts,
    the port raises ValueError)."""
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu import config as jconfig
    from simple_raytracer_tpu.kernels import tiled as jtiled
    from simple_raytracer_tpu_torch.kernels import tiled
    cfg = sr.default_config().replace(hit_tile=hit_tile)
    jcfg = jconfig.default_config().replace(hit_tile=hit_tile)
    if want is None:
        with pytest.raises(AssertionError):
            jtiled._hit_tile(jcfg, tile)
        with pytest.raises(ValueError, match="no sub-tile"):
            tiled._hit_tile(cfg, tile)
        return
    assert jtiled._hit_tile(jcfg, tile) == want
    assert tiled._hit_tile(cfg, tile) == want


@pytest.mark.parametrize("maxv_big", [500, 1000, 2000])
@pytest.mark.parametrize("cull_maxv", [0, 248])
@pytest.mark.parametrize("nb", [100, 3000, 3002, 20000])
def test_effective_cull_maxv_matches_jax(maxv_big, cull_maxv, nb,
                                         monkeypatch):
    """KernelConfig.maxv_big widens the list cap of dense scenes (over
    1,500 windows of two blocks) as in JAX, whose ``effective_cull_maxv``
    reads only ``prep.block_min``'s rows (a stub here) and, unless set, the
    SRT_MAXV_BIG switch."""
    import types

    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu import config as jconfig
    from simple_raytracer_tpu.kernels import tiled as jtiled
    monkeypatch.delenv("SRT_MAXV_BIG", raising=False)
    cfg = sr.default_config().replace(
        cull_maxv=cull_maxv, kernel=sr.KernelConfig(maxv_big=maxv_big))
    jcfg = jconfig.default_config().replace(
        cull_maxv=cull_maxv, kernel=jconfig.KernelConfig(maxv_big=maxv_big))
    stub = types.SimpleNamespace(block_min=np.zeros((nb, 3), np.float32))
    ours = pl.effective_cull_maxv(cfg, nb, cfg.kernel.window_blocks)
    assert ours == jtiled.effective_cull_maxv(jcfg, stub)
    assert ours == (cull_maxv if cull_maxv <= 0 or nb <= 3000
                    else max(cull_maxv, min(maxv_big, 1016)))
