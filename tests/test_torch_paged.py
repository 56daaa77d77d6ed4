"""PyTorch port, the paged tiled frame (``RenderConfig.tiled_impl="paged"``):
the page planner, K6 (the nearest walk over explicit rays) and K7 (the
occlusion walk over pages) through their plain versions, the paged shadow
front end, and whole frames, flat, soft, textured and smooth-normal.

Both packages get the same padded, BVH-ordered scene (``from_jax_prepared``)
and the same rays, handed to both as numpy arrays.  The JAX kernels run in
interpret mode.  Bars: plans and visibility masks equal, entry bounds rtol
1e-6; K6 at the nearest kernel's bars (t rtol 1e-4 / atol 1e-6, idx equal on
>= 99.9%: the JAX kernel takes its numerators from a Gram contraction and
breaks exact ties per lane slot of a page); found equal on >= 99.99% of hit
lanes; frames at the JAX package's image bars (tests/test_tiled.py:90-94:
within 1 on >= 99.9% of pixels, equal on >= 98%).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import (from_jax_prepared,
                                                       prepare)
from simple_raytracer_tpu_torch.kernels import paged, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.kernels import tiled
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.render import integrator
from simple_raytracer_tpu_torch.render.renderer import render

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled as jtiled
from simple_raytracer_tpu.render.renderer import render as jrender

from _torch_cases import coincident_pages, two_pages
from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_prepared_arrays, managers)

S4 = 4
MAXV = 248
TILE = TILE_PX * TILE_PX
SOFT_TILES = 8


def _j(x):
    return jnp.asarray(x.numpy())


def _scenes(textured: bool = False):
    """The parity scene (or its textured variant) in both packages."""
    _, jsm = managers(textured=textured)
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             has_textures=textured,
                             num_triangles=int(jprep.num_triangles),
                             page_tris=cfg.bvh.page_tris, device="cpu")
    return prep, jprep


@pytest.fixture(scope="module")
def base():
    """The parity scene in both packages, the moved view's primary rays,
    and their nearest hits through K6's plain version."""
    prep, jprep = _scenes()
    cfg, _ = configs()
    o, d, _, _ = tcam.primary_rays_tiled(WIDTH, HEIGHT, TILE_PX, FOCAL,
                                         view_matrix=torch.from_numpy(VIEW))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t, idx = paged.hits(prep, cfg, o, d, TILE, MAXV, apex=True)
    hit = torch.isfinite(t)
    point = torch.where(hit[:, None],
                        o + torch.where(hit, t, 0.0)[:, None] * d, 0.0)
    obj = torch.where(hit, prep.scene.tri_obj[idx.clamp_min(0).long()], -1)
    return {"prep": prep, "jprep": jprep, "cfg": cfg, "o": o, "d": d,
            "t": t, "idx": idx, "hit": hit, "point": point, "obj": obj}


def _hard_rays(b):
    p = b["point"][b["hit"]]
    return p, torch.tensor(LIGHT) - p, b["obj"][b["hit"]]


def _soft_rays(b, ts=256):
    """S4 samples x ``ts`` points per tile, sample-major within a tile."""
    p, _, so = _hard_rays(b)
    step = p.shape[0] // (SOFT_TILES * ts)
    p = p[::step][:SOFT_TILES * ts].reshape(SOFT_TILES, ts, 3)
    so = so[::step][:SOFT_TILES * ts].reshape(SOFT_TILES, 1, ts)
    lights = integrator.light_sample_positions(LIGHT, S4, 3.0)
    o = p[:, None].expand(SOFT_TILES, S4, ts, 3)
    d = lights[None, :, None, :] - o
    so = so.expand(SOFT_TILES, S4, ts)
    return o.reshape(-1, 3), d.reshape(-1, 3), so.reshape(-1), S4 * ts


def _mixed_rays(n=2048, seed=5):
    """Rays of many origins (no shared apex): points around the camera
    aimed at the sphere, with jitter wide enough to hit the ground too."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-10.0, -8.0, 0.0], [10.0, 8.0, 20.0], (n, 3))
    aim = np.array([0.3, 0.2, 60.0]) + rng.normal(scale=4.0, size=(n, 3))
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy((aim - o).astype(np.float32)))


@pytest.mark.parametrize("maxv", [MAXV, 1000])
def test_primary_page_plan_matches_jax(base, maxv):
    """The page plan of primary rays (interval and projective tests) equals
    JAX ``_cull(apex=True)``; a request for 1,000 entries is clamped to
    the 256-wide plan, where the sublane planner widens it."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    o, d = base["o"], base["d"]
    ours = paged.cull(prep, cfg, o, d, TILE, maxv, apex=True)
    theirs = np.asarray(jtiled._cull(_j(o), _j(d), TILE, jprep, maxv,
                                     apex=True))
    n = o.shape[0] // TILE
    assert ours.shape == theirs.shape == (n, pl.PLAN_W)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert prep.num_pages == int(jprep.num_pages)
    cnt = ours[:, 2]
    assert (ours[:, 3] == 1).all() and (cnt > 0).any()
    assert int(cnt.max()) <= prep.num_pages
    ab = pl.ray_tile_bounds(o, d, TILE, apex="primary")
    wide = pl.cull(prep, maxv, paged.page_blocks(prep), ab, apex=True)
    assert wide.shape[1] == {MAXV: pl.PLAN_W, 1000: 1024}[maxv]


def test_projective_bounds_match_jax(base):
    """``visibility_px`` from the apex bounds of explicit primary rays
    equals JAX ``_visibility_px(o, d, ...)``; the entry bounds the plan
    keeps are the interval test's (the projective test refines the mask
    only, as in JAX), equal to JAX's at rtol 1e-6."""
    prep, jprep = base["prep"], base["jprep"]
    o, d = base["o"], base["d"]
    ab = pl.ray_tile_bounds(o, d, TILE, apex="primary")
    vis = pl.visibility_px(ab, prep.block_min, prep.block_max)
    jvis, _jtlo, jn = jtiled._visibility_px(_j(o), _j(d), TILE,
                                            jprep.block_min, jprep.block_max)
    assert jn == o.shape[0] // TILE
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    ivis, itlo = pl.visibility(ab, prep.block_min, prep.block_max)
    jivis, jitlo, _ = jtiled._visibility(_j(o), _j(d), TILE, jprep.block_min,
                                         jprep.block_max)
    np.testing.assert_array_equal(ivis.numpy(), np.asarray(jivis))
    v = ivis.numpy()
    np.testing.assert_allclose(itlo.numpy()[v], np.asarray(jitlo)[v],
                               rtol=1e-6)
    assert not bool(ab["tile_bad"].any()) and bool((ab["dw_hi"] > 0).all())
    assert (ivis & vis).sum() < ivis.sum()


@pytest.mark.parametrize("case", ["hard_apex_rev", "soft", "soft_hourglass"])
def test_occlusion_page_plan_matches_jax(base, case, monkeypatch):
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    if case == "hard_apex_rev":
        o, d, _ = _hard_rays(base)
        tile = 256
    else:
        o, d, _, tile = _soft_rays(base)
    n = -(-o.shape[0] // tile)
    excl = torch.from_numpy(
        np.random.default_rng(4).integers(-2, 2, n).astype(np.int32))
    apex_rev = case == "hard_apex_rev"
    hourglass = case == "soft_hourglass"
    monkeypatch.setenv("SRT_HOURGLASS", "1" if hourglass else "0")
    ours = paged.cull_occl(prep, cfg, o, d, tile, MAXV, excl,
                           apex_rev=apex_rev, hourglass=hourglass)
    theirs = np.asarray(jtiled.cull_occl(jprep, _j(o), _j(d), tile, MAXV,
                                         _j(excl), apex_rev=apex_rev))
    assert ours.shape == theirs.shape == (n, pl.PLAN_W)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    cnt = torch.where(ours[:, 3] == 1, ours[:, 2], ours[:, 1])
    assert (cnt > 0).any()


@pytest.mark.parametrize("rays", ["primary", "mixed"])
def test_nearest_plain_matches_jax(base, rays):
    """K6's plain version through ``paged.hits`` vs JAX ``tiled_hits``:
    the frame's primary rays (apex plan), and rays of many origins."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    if rays == "primary":
        o, d, apex, tile = base["o"], base["d"], True, TILE
        t, idx = base["t"], base["idx"]
    else:
        (o, d), apex, tile = _mixed_rays(), False, 256
        t, idx = paged.hits(prep, cfg, o, d, tile, MAXV)
    jt, ji = jtiled.tiled_hits(jprep, _j(o), _j(d), tile, cfg.mt_eps, MAXV,
                               apex=apex)
    jt, ji, t, idx = np.asarray(jt), np.asarray(ji), t.numpy(), idx.numpy()
    hj, ho = np.isfinite(jt), np.isfinite(t)
    assert ho.sum() > 0.3 * t.size and (hj == ho).mean() > 0.999
    both = hj & ho
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)
    differ = int((idx != ji).sum())
    print(f"K6 plain vs JAX ({rays}): idx differs on {differ} of {idx.size}")
    assert (idx == ji).mean() >= 0.999
    assert (idx[~ho] == -1).all()


@pytest.mark.parametrize("case", ["two_pages_true", "two_pages_lying",
                                  "coincident"])
def test_nearest_plain_cases(case):
    """The plain walk trusts an entry's bound, and breaks an exact tie
    across pages toward the lower triangle id whatever the walk order."""
    if case == "coincident":
        tensors, rest = coincident_pages()
        want = 5
    else:
        lying = case.endswith("lying")
        tensors, rest = two_pages(1.0 if lying else 0.0)
        want = 0 if lying else 128
    t, idx = paged.tiled_nearest_plain(*tensors, *rest)
    assert t.shape == idx.shape == (1, 4096)
    assert (idx == want).all() and torch.isfinite(t).all()


@pytest.mark.parametrize("case", ["hard", "soft"])
def test_anyhit_plain_matches_jax(base, case):
    """K7's plain version vs JAX ``tiled.anyhit`` on the same page plan."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    if case == "hard":
        o, d, so = _hard_rays(base)
        tile = 256
    else:
        o, d, so, tile = _soft_rays(base)
    n = -(-o.shape[0] // tile)
    so = torch.cat([so, so[-1:].expand(n * tile - so.shape[0])])
    so = so.reshape(n, tile).to(torch.int32)
    plan = paged.cull_occl(prep, cfg, o, d, tile, MAXV,
                           apex_rev=case == "hard", hourglass=False)
    jf = np.asarray(jtiled.anyhit(jprep, _j(o), _j(d),
                                  jnp.asarray(so.numpy(), jnp.float32),
                                  _j(plan), tile, cfg.mt_eps, True))
    with table.using({"anyhit_pages": paged.tiled_anyhit_plain}):
        f = paged.anyhit(prep, cfg, o, d, so, plan, tile)
    assert f.shape == (n, tile)
    R = o.shape[0]
    f, jf = f.numpy().reshape(-1)[:R], jf.reshape(-1)[:R]
    print(f"K7 plain vs JAX ({case}): found differs on "
          f"{int((f != jf).sum())} of {R} lanes")
    assert (f == jf).mean() >= 0.9999
    assert f.sum() > 50


@pytest.fixture(scope="module")
def shadow_queries(base):
    """The integrator's shadow query for S = 1 and S = 4 through both
    packages' paged ``tiled_shadow_fn``."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    out = {}
    for S in (1, S4):
        R = base["point"].shape[0]
        lights = integrator.light_sample_positions(LIGHT, S, 3.0)
        pts = base["point"].expand(S, R, 3).reshape(-1, 3)
        lps = lights[:, None].expand(S, R, 3).reshape(-1, 3)
        objs = base["obj"].clamp_min(0).expand(S, R).reshape(-1)
        hits = base["hit"].expand(S, R).reshape(-1)
        f = tiled.tiled_shadow_fn(prep, cfg, TILE, MAXV, S,
                                  tiled.shadow_impl("paged"))(
            pts, lps, objs, hit=hits)
        jf = jtiled.tiled_shadow_fn(jprep, TILE, cfg.mt_eps, MAXV, True, S,
                                    impl=jtiled)(
            _j(pts), _j(lps), _j(objs), hit=_j(hits))
        out[S] = (f.numpy(), np.asarray(jf), hits.numpy())
    return out


@pytest.mark.parametrize("S", [1, S4])
def test_paged_shadow_fn_matches_jax_per_lane(shadow_queries, S):
    f, jf, hits = shadow_queries[S]
    assert f.shape == jf.shape == hits.shape
    differ = int((f[hits] != jf[hits]).sum())
    print(f"paged shadow S={S}: found differs on {differ} of "
          f"{int(hits.sum())} hit lanes")
    assert (f[hits] == jf[hits]).mean() >= 0.9999
    per_sample = f.reshape(S, -1)[:, hits[:hits.size // S]].sum(axis=1)
    assert (per_sample > 50).all()


@pytest.fixture(scope="module")
def textured():
    return _scenes(textured=True)


FRAMES = {
    "flat_s1": (False, False, 1),
    "flat_s4": (False, False, S4),
    "textured_smooth_s4": (True, True, S4),
    "textured_flat_s1": (True, False, 1),
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_paged_frame_matches_jax(base, textured, frame):
    """Whole paged frames through both packages' ``render``."""
    tex, smooth, S = FRAMES[frame]
    prep, jprep = textured if tex else (base["prep"], base["jprep"])
    cfg, jcfg = configs(num_samples=S)
    cfg = cfg.replace(tiled_impl="paged",
                      shading=sr.ShadingConfig(smooth_normals=smooth))
    jcfg = jcfg.replace(tiled_impl="paged", shading=type(jcfg.shading)(
        smooth_normals=smooth))
    assert tiled.frame_branch(prep, cfg, TILE) == "paged"
    jimg = np.asarray(jrender(jprep, jcfg, LIGHT))
    n0 = table.calls()
    img = render(prep, cfg, LIGHT).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert table.calls() == n0
    assert img.shape == (HEIGHT, WIDTH, 3)
    diff = np.abs(img.astype(int) - jimg.astype(int))
    print(f"paged frame {frame}: {int((diff > 0).any(-1).sum())} pixels "
          f"differ, max {int(diff.max())}")
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    bg = (img == np.array(cfg.background, np.uint8)).all(-1)
    assert 0.2 < (~bg).mean() < 0.95
    if tex:
        # the checker shows: the ground holds both of its tones, green
        # squares and grey ones
        g = img[-20:].reshape(-1, 3).astype(int)
        assert (g[:, 1] > g[:, 0] + 10).sum() > 100
        assert ((abs(g[:, 1] - g[:, 0]) < 4) & (g[:, 0] > 30)).sum() > 100


def test_textured_on_ground_has_unit_normals_and_texels():
    sm, _ = managers(textured=True)
    scene = sm.build()
    assert scene.has_textures
    n = torch.linalg.norm(scene.vnormals, dim=-1)
    torch.testing.assert_close(n, torch.ones_like(n))
    ground = scene.tri_tex >= 0
    assert int(ground.sum()) == 12
    uv = scene.uvs[ground]
    assert float(uv.min()) >= 0.0 and float(uv.max()) <= 128.0


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    """``prepare`` and ``render`` default to the card and raise without
    one; ``device="cpu"`` runs the plain versions; an unknown
    ``tiled_impl`` raises ValueError."""
    sm, _ = managers(1)
    cfg, _ = configs()
    scene = sm.build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare(scene, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, cfg, LIGHT)
    prep = prepare(scene, cfg, device="cpu")
    assert prep.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_prepared({n: getattr(prep.scene, n).numpy()
                           for n in sr.Scene.ARRAY_FIELDS}
                          | {n: getattr(prep, n).numpy()
                             for n in ("block_min", "block_max",
                                       "block_obj")})
    with pytest.raises(ValueError, match="impl"):
        render(prep, cfg.replace(tiled_impl="pages"), LIGHT)
    img = render(prep, cfg.replace(tiled_impl="paged"), LIGHT)
    assert img.device.type == "cpu" and img.shape == (HEIGHT, WIDTH, 3)
