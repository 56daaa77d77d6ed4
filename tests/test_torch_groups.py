"""PyTorch port, kernels 4 and 5: the sub-group walks
(``KernelConfig.groups`` / ``groups_ah`` > 1), through their plain versions.

The JAX package cannot plan sub-groups: its ``cull_blocks_lists(groups > 1)``
reads a ``vis_fn`` that is no longer defined there (kernels/tiled.py:330),
so ``SRT_TILED_GROUPS`` > 1 raises NameError before its K4 or K5 launches.
The tests therefore hold the port's grouped plans to what that code meant:
the entry columns equal JAX's ungrouped plan at the grouped width, and the
mask words equal a rebuild from JAX's own visibility tests (``_visibility``,
``_visibility_hourglass``) at tile / G over window AABBs.  JAX's Pallas K4
and K5 (interpret mode, ``prec="highest"``) then walk the port's plans.

Both packages get the same padded, BVH-ordered parity scene
(``from_jax_prepared``) and the same rays.  Bars: plans and masks equal;
the grouped walks equal the ungrouped walks of the same entries bit for bit
in each package; port vs JAX at the nearest kernel's bars (t rtol 1e-4 /
atol 1e-6, idx equal on >= 99.9%: the JAX kernel forms its numerators as a
Gram contraction) and found equal on every lane.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import anyhit, nearest, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.render import integrator

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled as jtiled
from simple_raytracer_tpu.kernels import tiled_t

from _torch_cases import masked_occluder, masked_windows
from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_prepared_arrays, managers)

G = 4
MAXV = 248
TILE = TILE_PX * TILE_PX
S4 = 4
TS = 256                        # points per folded soft-shadow tile


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.fixture(scope="module")
def base():
    """The parity scene in both packages, the moved view's primary rays
    and the folded S = 4 soft-shadow rays of their hits (M = 1,024 rays
    per tile, sample-major within a tile, as kernels/tiled.py folds)."""
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    o, d, _, _ = tcam.primary_rays_tiled(WIDTH, HEIGHT, TILE_PX, FOCAL,
                                         view_matrix=torch.from_numpy(VIEW))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t, idx = nearest.hits(prep, cfg, o, d, TILE, MAXV, apex=True)
    hit = torch.isfinite(t)
    p = (o + torch.where(hit, t, 0.0)[:, None] * d)[hit]
    so = prep.scene.tri_obj[idx[hit].long()].to(torch.int32)
    nt = p.shape[0] // TS
    p = p[::p.shape[0] // (nt * TS)][:nt * TS].reshape(nt, TS, 3)
    so = so[::so.shape[0] // (nt * TS)][:nt * TS].reshape(nt, 1, TS)
    lights = integrator.light_sample_positions(LIGHT, S4, 3.0)
    so_ = so.expand(nt, S4, TS).reshape(nt, S4 * TS).contiguous()
    og = p[:, None].expand(nt, S4, TS, 3)
    dg = lights[None, :, None, :] - og
    return {"prep": prep, "jprep": jprep, "cfg": cfg, "o": o, "d": d,
            "so": (og.reshape(-1, 3), dg.reshape(-1, 3), so_)}


def _unpack(words):
    """Mask words [n, mv / 8] -> the 4-bit masks [n, mv] of the entries."""
    m4 = (words[:, :, None] >> (4 * np.arange(8))) & 0xF
    return m4.reshape(words.shape[0], -1)


def _check_masks(plan, o, d, tile, block_min, block_max, wb, hourglass):
    """The grouped plan's masks at every walked list entry equal what JAX's
    grouped planner meant (tiled.py:318-343): JAX's own visibility test at
    tile / G over window AABBs.  Returns the walked masks."""
    n = plan.shape[0]
    mv = (plan.shape[1] - pl.PLAN_AUX) * 8 // 9
    nw = block_min.shape[0] // wb
    wmin = jnp.asarray(block_min).reshape(nw, wb, 3).min(axis=1)
    wmax = jnp.asarray(block_max).reshape(nw, wb, 3).max(axis=1)
    op, dp, _ = jtiled.pad_rays(_j(o), _j(d), tile)
    fn = jtiled._visibility_hourglass if hourglass else jtiled._visibility
    vis, _, _ = fn(op, dp, tile // G, wmin, wmax)
    vis = np.asarray(vis).reshape(n, G, nw)
    mask4 = sum(vis[:, g].astype(np.int64) << g for g in range(G))
    ent = plan[:, pl.PLAN_AUX:pl.PLAN_AUX + mv]
    live = np.arange(mv)[None] < np.where(plan[:, 3] == 1, plan[:, 2],
                                          0)[:, None]
    want = np.take_along_axis(mask4, np.where(live, ent & 0xFFFF, 0), axis=1)
    ours = _unpack(plan[:, pl.PLAN_AUX + mv:])
    assert live.any()
    np.testing.assert_array_equal(ours[live], want[live])
    return ours[live]


def test_grouped_primary_plan_matches_jax(base):
    """The grouped nearest plan: entries equal JAX's ungrouped plan at the
    grouped width (``8 + maxv + maxv/8 + 8`` widened to 128), mask words
    equal the rebuild, and some masks clear a group."""
    prep, jprep = base["prep"], base["jprep"]
    o, d = base["o"], base["d"]
    plan = pl.cull_rays(prep, o, d, TILE, MAXV, 2, groups=G).numpy()
    pw = -(-(pl.PLAN_AUX + MAXV + MAXV // 8 + 8) // 128) * 128
    mv = pw - pl.PLAN_AUX
    assert plan.shape == (o.shape[0] // TILE, pw + mv // 8)
    flat = np.asarray(jtiled.cull_blocks_lists(
        _j(o), _j(d), TILE, jprep.block_min, jprep.block_max, MAXV,
        prep.block_size, 2 * prep.block_size, plan_w=pw, apex=True))
    np.testing.assert_array_equal(plan[:, :pw], flat)
    live = _check_masks(plan, o, d, TILE, jprep.block_min, jprep.block_max,
                        2, False)
    print(f"primary masks: {np.unique(live, return_counts=True)}")
    assert ((live != 0) & (live != 0xF)).any()
    # the ungrouped plan of the sublane planner is JAX's tiled_t.cull
    jplan = np.asarray(tiled_t.cull(jprep, _j(o), _j(d), TILE, MAXV,
                                    apex=True))
    np.testing.assert_array_equal(
        pl.cull_rays(prep, o, d, TILE, MAXV, 2).numpy(), jplan)


@pytest.mark.parametrize("hourglass", [False, True])
def test_grouped_occlusion_plan_matches_jax(base, hourglass):
    """The grouped occlusion plan of the folded soft-shadow rays (windows
    of 4 blocks, M = 1,024, groups of 256): the interval and the hourglass
    base tests."""
    prep, jprep = base["prep"], base["jprep"]
    o, d, so = base["so"]
    M = S4 * TS
    n = so.shape[0]
    excl = torch.from_numpy(
        np.random.default_rng(4).integers(-2, 2, n).astype(np.int32))
    plan = pl.cull_occl(prep, o, d, M, MAXV, 4, excl, hourglass=hourglass,
                        groups=G).numpy()
    pw = -(-(pl.PLAN_AUX + MAXV + MAXV // 8 + 8) // 128) * 128
    fn_kw = dict(plan_w=pw, hourglass=hourglass)
    flat = np.asarray(jtiled.cull_blocks_lists(
        _j(o), _j(d), M, jprep.block_min, jprep.block_max, MAXV,
        prep.block_size, 4 * prep.block_size, jprep.block_obj, _j(excl),
        **fn_kw))
    np.testing.assert_array_equal(plan[:, :pw], flat)
    live = _check_masks(plan, o, d, M, jprep.block_min, jprep.block_max, 4,
                        hourglass)
    print(f"occlusion masks: {np.unique(live, return_counts=True)}")


def test_grouped_nearest_plain_matches_jax_k4(base):
    """K4's plain version on the port's grouped plan vs JAX's Pallas K4
    (``tiled_nearest_t(groups=4)``) on the same plan; each equals its
    package's ungrouped walk of the same entries."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    o, d = base["o"], base["d"]
    plan = pl.cull_rays(prep, o, d, TILE, MAXV, 2, groups=G)
    n = plan.shape[0]
    o3, d3 = o.reshape(n, TILE, 3), d.reshape(n, TILE, 3)
    t, idx = nearest.tiled_nearest_grouped_plain(plan, prep.tri, o3, d3, 64,
                                                 cfg.mt_eps, G)
    mv = (plan.shape[1] - pl.PLAN_AUX) * 8 // 9
    flat = plan[:, :pl.PLAN_AUX + mv].contiguous()
    ut, ui = nearest.tiled_nearest_rays_plain(flat, prep.tri, o3, d3, 64,
                                              cfg.mt_eps)
    assert torch.equal(t, ut) and torch.equal(idx, ui)

    Ft, _, _ = tiled_t.ray_tile_features_t(_j(o), _j(d), TILE)
    jt, ji = (np.asarray(x) for x in tiled_t.tiled_nearest_t(
        Ft, _j(plan), jprep.gram_t, TILE, prep.block_size, 2, cfg.mt_eps,
        prec="highest", groups=G))
    jut, jui = (np.asarray(x) for x in tiled_t.tiled_nearest_t(
        Ft, _j(flat), jprep.gram_t, TILE, prep.block_size, 2, cfg.mt_eps,
        prec="highest"))
    np.testing.assert_array_equal(jt, jut)
    np.testing.assert_array_equal(ji, jui)
    t, idx = t.numpy(), idx.numpy()
    hj, ho = np.isfinite(jt), np.isfinite(t)
    assert ho.sum() > 4000 and (hj == ho).mean() > 0.999
    both = hj & ho
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)
    print(f"K4: idx differs on {int((idx != ji).sum())} of {idx.size}")
    assert (idx == ji).mean() >= 0.999


def test_grouped_anyhit_plain_matches_jax_k5(base):
    """K5's plain version on the port's grouped occlusion plan vs JAX's
    Pallas K5 (``tiled_anyhit_t(groups=4)``) on the same plan; each equals
    its package's ungrouped walk of the same entries."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    o, d, so = base["so"]
    M = S4 * TS
    n = so.shape[0]
    plan = pl.cull_occl(prep, o, d, M, MAXV, 4, None, hourglass=False,
                        groups=G)
    o3, d3 = o.reshape(n, M, 3), d.reshape(n, M, 3)
    args = (prep.tri, prep.block_obj, o3, d3, so, 128, prep.block_size,
            cfg.mt_eps, True)
    f = anyhit.tiled_anyhit_grouped_plain(plan, *args, G)
    mv = (plan.shape[1] - pl.PLAN_AUX) * 8 // 9
    flat = plan[:, :pl.PLAN_AUX + mv].contiguous()
    assert torch.equal(f, anyhit.tiled_anyhit_plain(flat, *args))

    Ft, _, _ = tiled_t.ray_tile_features_t(_j(o), _j(d), M)
    npad = jprep.gram_t.shape[1] // (4 * prep.block_size) \
        - jprep.block_obj.shape[0]
    bobj = jnp.concatenate([jprep.block_obj,
                            jnp.full((npad,), -1, jnp.int32)])
    sj = jnp.asarray(so.numpy(), jnp.float32).reshape(n, 1, M)
    jf, juf = (np.asarray(tiled_t.tiled_anyhit_t(
        Ft, sj, _j(p), jprep.gram_t, bobj, M, prep.block_size, 4,
        cfg.mt_eps, True, prec="highest", groups=g)) for p, g in
        ((plan, G), (flat, 1)))
    np.testing.assert_array_equal(jf, juf)
    f = f.numpy()
    print(f"K5: found differs on {int((f != jf).sum())} of {f.size} lanes, "
          f"{int(f.sum())} occluded")
    np.testing.assert_array_equal(f, jf)
    assert f.sum() > 50 and not f.all()


def test_grouped_nearest_plain_honors_masks():
    """Window 1 (the nearer quad) is masked to sub-groups 0 and 2: the
    other groups keep window 0's hit (the case the card's kernel is held
    to in tests/test_torch_cuda.py)."""
    tensors, rest, want = masked_windows()
    t, idx = table.run("nearest_grouped", *tensors, *rest)
    assert torch.equal(idx, want.to(torch.int32))
    torch.testing.assert_close(
        t, torch.where(want == 64, 5.0, 10.0).float() / 400.0)


def test_grouped_anyhit_plain_honors_masks():
    """The occluder's window is masked to sub-groups 0 and 2: only their
    rays find it."""
    tensors, rest, want = masked_occluder()
    assert torch.equal(table.run("anyhit_grouped", *tensors, *rest), want)


@pytest.mark.parametrize("m, groups", [(1000, 4), (96, 4), (128, 5)])
def test_groups_must_be_whole_warps(m, groups):
    """Sub-groups of the walks are whole warps (a multiple of 32 lanes),
    at most 4 of them."""
    with pytest.raises(ValueError, match="warps"):
        nearest.check_groups(m, groups)
