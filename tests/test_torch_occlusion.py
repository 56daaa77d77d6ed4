"""PyTorch port, the occlusion walk over explicit rays (K2′) and its two
callers: the legacy hard shadow and the folded soft shadow.

Both packages get the same padded, BVH-ordered parity scene
(``from_jax_prepared``) and the same rays: the hit points of the port's
nearest pass, handed to both as numpy arrays.  The JAX kernels run in
interpret mode.  Bars: visibility masks and plans equal, entry bounds rtol
1e-6; found equal per lane on hit lanes; the fetch mode at the nearest
kernel's bars (t rtol 1e-4 / atol 1e-6, idx equal on >= 99.9%); frames at
the JAX package's image bars (tests/test_tiled.py:90-94: within 1 on
>= 99.9% of pixels, equal on >= 98%), with spies on the JAX side showing
which branch it took.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import anyhit, nearest, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.kernels import tiled
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.render import integrator
from simple_raytracer_tpu_torch.render.renderer import render

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled as jtiled
from simple_raytracer_tpu.kernels import tiled_t
from simple_raytracer_tpu.ops.camera import primary_rays_tiled, untile_image
from simple_raytracer_tpu.render import integrator as jint

from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_prepared_arrays, managers)

S4 = 4
MAXV = 248


@pytest.fixture(scope="module")
def base():
    """The parity scene in both packages, and the hard-shadow query of the
    parity frame (moved view): hit points with misses pinned to 0, the hit
    mask and the winners' objects."""
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    vm = torch.from_numpy(VIEW)
    cs = (vm, FOCAL, WIDTH, HEIGHT, TILE_PX)
    t, _i, obj, _rgb, _b = nearest.hits_shaded(prep, cfg, torch.tensor(LIGHT),
                                               cs, MAXV)
    o, d, _, _ = tcam.primary_rays_tiled(WIDTH, HEIGHT, TILE_PX, FOCAL,
                                         view_matrix=vm)
    hit = torch.isfinite(t)
    point = torch.where(hit[:, None],
                        o.reshape(-1, 3) + torch.where(hit, t, 0.0)[:, None]
                        * d.reshape(-1, 3), 0.0)
    return {"jprep": jprep, "prep": prep, "cfg": cfg, "point": point,
            "hit": hit, "obj": obj}


def _hard_rays(b):
    """Shadow rays toward the one light from the hit points only."""
    p = b["point"][b["hit"]]
    return p, torch.tensor(LIGHT) - p


SOFT_TILES = 8


def _soft_rays(b, ts=256):
    """S4 samples x ``ts`` points per tile, sample-major within a tile, as
    the folded soft shadow lays them out."""
    p = b["point"][b["hit"]]
    p = p[::p.shape[0] // (SOFT_TILES * ts)][:SOFT_TILES * ts]
    p = p.reshape(SOFT_TILES, ts, 3)
    lights = integrator.light_sample_positions(LIGHT, S4, 3.0)
    o = p[:, None].expand(SOFT_TILES, S4, ts, 3)
    d = lights[None, :, None, :] - o
    return o.reshape(-1, 3), d.reshape(-1, 3), S4 * ts


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("rays", ["hard", "soft"])
def test_ray_visibility_matches_jax(base, rays):
    """Interval, light-apex and hourglass visibility from per-ray bounds."""
    if rays == "hard":
        o, d = _hard_rays(base)
        tile = 256
    else:
        o, d, tile = _soft_rays(base)
    prep, jprep = base["prep"], base["jprep"]
    n = -(-o.shape[0] // tile)
    excl = torch.from_numpy(
        np.random.default_rng(3).integers(-2, 2, n).astype(np.int32))
    ab = pl.ray_tile_bounds(o, d, tile, hourglass=True, apex="light")
    bmin, bmax, bobj = prep.block_min, prep.block_max, prep.block_obj
    args = (_j(o), _j(d), tile, jprep.block_min, jprep.block_max)
    jargs = (jprep.block_obj, _j(excl))
    ours = {"interval": pl.visibility(ab, bmin, bmax, bobj, excl),
            "hourglass": pl.visibility_hourglass(ab, bmin, bmax, bobj, excl),
            "apex_rev": (pl.visibility_px_rev(ab, bmin, bmax), None)}
    theirs = {"interval": jtiled._visibility(*args, *jargs),
              "hourglass": jtiled._visibility_hourglass(*args, *jargs),
              "apex_rev": jtiled._visibility_px_rev(*args)}
    for name, (vis, tlo) in ours.items():
        jvis, jtlo, jn = theirs[name]
        assert jn == n and vis.shape == (n, prep.num_blocks), name
        np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis),
                                      err_msg=name)
        if tlo is not None:
            v = vis.numpy()
            np.testing.assert_allclose(tlo.numpy()[v], np.asarray(jtlo)[v],
                                       rtol=1e-6, err_msg=name)
    interval = ours["interval"][0]
    assert (interval & ours["apex_rev"][0]).sum() < interval.sum()
    assert 0 < ours["hourglass"][0].sum()


@pytest.mark.parametrize("case", ["hard_apex_rev", "soft", "soft_hourglass"])
def test_cull_occl_matches_jax(base, case, monkeypatch):
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    if case == "hard_apex_rev":
        o, d = _hard_rays(base)
        tile = 256
    else:
        o, d, tile = _soft_rays(base)
    n = -(-o.shape[0] // tile)
    excl = torch.from_numpy(
        np.random.default_rng(4).integers(-2, 2, n).astype(np.int32))
    apex_rev = case == "hard_apex_rev"
    hourglass = case == "soft_hourglass"
    monkeypatch.setenv("SRT_HOURGLASS", "1" if hourglass else "0")
    ours = pl.cull_occl(prep, o, d, tile, MAXV, cfg.kernel.window_blocks_ah,
                        excl, apex_rev=apex_rev, hourglass=hourglass)
    theirs = np.asarray(tiled_t.cull_occl(jprep, _j(o), _j(d), tile, MAXV,
                                          _j(excl), apex_rev=apex_rev))
    assert ours.shape == theirs.shape == (n, pl.PLAN_W)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    cnt = torch.where(ours[:, 3] == 1, ours[:, 2], ours[:, 1])
    assert (cnt > 0).any()


@pytest.mark.parametrize("case", ["hard", "soft"])
def test_anyhit_plain_matches_jax(base, case):
    """K2′'s plain version vs the JAX ``tiled_t.anyhit`` on the same plan."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    if case == "hard":
        o, d = _hard_rays(base)
        tile = 256
        so = base["obj"][base["hit"]]
    else:
        o, d, tile = _soft_rays(base)
        so = base["obj"][base["hit"]]
        so = so[::so.shape[0] // (SOFT_TILES * 256)][:SOFT_TILES * 256]
        so = so.reshape(SOFT_TILES, 1, 256).expand(SOFT_TILES, S4, 256) \
            .reshape(-1)
    n = -(-o.shape[0] // tile)
    so = torch.cat([so, so[-1:].expand(n * tile - so.shape[0])])
    so = so.reshape(n, tile)
    plan = pl.cull_occl(prep, o, d, tile, MAXV, cfg.kernel.window_blocks_ah,
                        apex_rev=case == "hard")
    jf = np.asarray(tiled_t.anyhit(jprep, _j(o), _j(d),
                                   jnp.asarray(so.numpy(), jnp.float32),
                                   _j(plan), tile, cfg.mt_eps, True))
    with table.using({"anyhit": anyhit.tiled_anyhit_plain}):
        f = anyhit.anyhit(prep, cfg, o, d, so, plan, tile)
    assert f.shape == (n, tile)
    R = o.shape[0]
    np.testing.assert_array_equal(f.numpy().reshape(-1)[:R],
                                  jf.reshape(-1)[:R])
    assert f.sum() > 50


def test_anyhit_plain_ragged_tile_and_max_t():
    """M = 1023 rays per tile (S = 3 folds 341 points) and the max-t rule:
    a ray toward a light in front of the occluder is not shadowed."""
    from _torch_cases import ragged_rays
    tensors, rest, want = ragged_rays()
    for no_max_t in (True, False):
        f = anyhit.tiled_anyhit_plain(*tensors, *rest, no_max_t)
        assert f.shape == (2, 1023)
        assert torch.equal(f, want[no_max_t])


@pytest.fixture(scope="module")
def shadow_queries(base):
    """The integrator's shadow query for S = 1 and S = 4 through both
    packages' ``tiled_shadow_fn`` (S4 repeats the hit points per sample)."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    out = {}
    for S in (1, S4):
        R = base["point"].shape[0]
        lights = integrator.light_sample_positions(LIGHT, S, 3.0)
        pts = base["point"].expand(S, R, 3).reshape(-1, 3)
        lps = lights[:, None].expand(S, R, 3).reshape(-1, 3)
        objs = base["obj"].clamp_min(0).expand(S, R).reshape(-1)
        hits = base["hit"].expand(S, R).reshape(-1)
        tile = TILE_PX * TILE_PX
        f = tiled.tiled_shadow_fn(prep, cfg, tile, MAXV, S)(pts, lps, objs,
                                                            hit=hits)
        jf = jtiled.tiled_shadow_fn(jprep, tile, cfg.mt_eps, MAXV, True, S,
                                    impl=tiled_t)(
            _j(pts), _j(lps), _j(objs), hit=_j(hits))
        out[S] = (f.numpy(), np.asarray(jf), hits.numpy())
    return out


@pytest.mark.parametrize("S", [1, S4])
def test_shadow_fn_matches_jax_per_lane(shadow_queries, S):
    f, jf, hits = shadow_queries[S]
    assert f.shape == jf.shape == hits.shape
    np.testing.assert_array_equal(f[hits], jf[hits])
    # each sample shadows, and not alike: the fold kept samples apart
    per_sample = f.reshape(S, -1)[:, hits[:hits.size // S]].sum(axis=1)
    assert (per_sample > 50).all()
    if S > 1:
        assert len(set(per_sample.tolist())) > 1


def test_legacy_and_fused_hard_shadows_agree(base):
    """Port only: the legacy hard shadow (explicit rays, 256-ray tiles)
    and the fused one (rays rebuilt from t, primary tiles)."""
    prep, cfg = base["prep"], base["cfg"]
    light = torch.tensor(LIGHT)
    for vm in (None, torch.from_numpy(VIEW)):
        cs = (vm, FOCAL, WIDTH, HEIGHT, TILE_PX)
        cam = pl.camera(prep, cs, light)
        t, _i, obj, _rgb, bounds = nearest.hits_shaded(prep, cfg, light, cs,
                                                       MAXV, cam=cam)
        fused = anyhit.anyhit_from_t(prep, cfg, t, obj, bounds, cam, cs,
                                     MAXV)
        o, d, _, _ = tcam.primary_rays_tiled(WIDTH, HEIGHT, TILE_PX, FOCAL,
                                             view_matrix=vm)
        hit = torch.isfinite(t)
        point = torch.where(hit[:, None], o.reshape(-1, 3) + torch.where(
            hit, t, 0.0)[:, None] * d.reshape(-1, 3), 0.0)
        legacy = tiled.tiled_shadow_fn(prep, cfg, 256, MAXV)(
            point, light.expand(point.shape), obj, hit=hit)
        assert (legacy[hit] == fused[hit]).float().mean() >= 0.999
        assert legacy[hit].sum() > 200


@pytest.fixture(scope="module")
def attrs(base):
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    out = {}
    for name, vm in (("identity", None), ("moved", VIEW)):
        jcs = (None if vm is None else jnp.asarray(vm), FOCAL, WIDTH, HEIGHT,
               TILE_PX)
        R = (WIDTH // TILE_PX) * (HEIGHT // TILE_PX) * TILE_PX * TILE_PX
        dummy = jnp.zeros((R, 3), jnp.float32)      # rays come from cam_spec
        jt, ji, ja = tiled_t.hits_attrs(jprep, dummy, dummy,
                                        TILE_PX * TILE_PX, cfg.mt_eps, MAXV,
                                        apex=True, cam_spec=jcs)
        jrec = jint.records_from_attrs(jprep.scene, ja)
        cs = (None if vm is None else torch.from_numpy(vm), FOCAL, WIDTH,
              HEIGHT, TILE_PX)
        t, idx, a = nearest.hits_attrs(prep, cfg, cs, MAXV)
        out[name] = ((np.asarray(jt), np.asarray(ji),
                      np.asarray(jrec["normal"]), np.asarray(jrec["obj"])),
                     (t.numpy(), idx.numpy(), a.numpy()))
    return out


@pytest.mark.parametrize("view", ["identity", "moved"])
def test_hits_attrs_matches_jax(attrs, view):
    (jt, ji, jn, jo), (t, idx, a) = attrs[view]
    hj, ho = np.isfinite(jt), np.isfinite(t)
    assert hj.sum() > 4000 and (hj == ho).mean() > 0.999
    both = hj & ho
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)
    assert (idx == ji).mean() > 0.999
    same = (idx == ji) & ho
    np.testing.assert_allclose(a[same, :3], jn[same], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(a[same, 3].astype(np.int32), jo[same])
    assert (a[~ho] == [0.0, 0.0, 0.0, -1.0]).all() and (idx[~ho] == -1).all()


def test_light_samples_and_shade_records_match_jax(base):
    """The jittered samples (cumulative, sample 0 the base light) and the
    S-sample Phong sum with a given shadow pattern."""
    cfg, _ = configs(num_samples=S4)
    lp = integrator.light_sample_positions(LIGHT, 5, 3.0).numpy()
    jlp = np.asarray(jint.light_sample_positions(jnp.asarray(LIGHT), 5, 3.0))
    np.testing.assert_array_equal(lp, jlp)
    np.testing.assert_array_equal(lp[0], LIGHT)
    rng = np.random.default_rng(7)
    R = 512
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = (rng.normal(size=(R, 3)) + [0, 0, 3]).astype(np.float32)
    t = rng.uniform(1, 20, R).astype(np.float32)
    t[::17] = np.inf
    nrm = rng.normal(size=(R, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    obj = rng.integers(0, 2, R).astype(np.float32)
    attrs = np.concatenate([nrm, obj[:, None]], axis=1)
    shadow = rng.random(S4 * R) < 0.3
    prep, jprep = base["prep"], base["jprep"]
    rec = integrator.records_from_attrs(prep.scene, torch.from_numpy(attrs))
    got = integrator.shade_records(
        prep.scene, cfg, rec, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t), torch.tensor(LIGHT),
        lambda *a, **k: torch.from_numpy(shadow)).numpy()
    jrec = {"obj": jnp.asarray(obj.astype(np.int32)),
            "tex_id": jnp.full((R,), -1, jnp.int32),
            "normal": jnp.asarray(nrm)}
    jrec.update(jint.material_select(jprep.scene, jrec["obj"]))
    want = np.asarray(jint.shade_records(
        jprep.scene, configs(num_samples=S4)[1], jrec, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t), jnp.asarray(LIGHT),
        lambda *a, **k: jnp.asarray(shadow)))
    fin = np.isfinite(t)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    for k in ("color", "ambient", "specular", "shininess"):
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(jrec[k]),
                                      err_msg=k)


def _jax_frame(jprep, jcfg, tpx, spies, monkeypatch):
    """The JAX tiled frame (identity view) and the tiled_t entry points it
    called."""
    called = []
    for name in spies:
        orig = getattr(tiled_t, name)
        monkeypatch.setattr(
            tiled_t, name,
            lambda *a, _o=orig, _n=name, **k: (called.append(_n),
                                               _o(*a, **k))[1])
    o, d, tx, ty = primary_rays_tiled(WIDTH, HEIGHT, tpx, FOCAL, False)
    rad, hit = jtiled.render_flat_tiled(
        jprep, jcfg, o.reshape(-1, 3), d.reshape(-1, 3), jnp.asarray(LIGHT),
        cam_spec=(None, FOCAL, WIDTH, HEIGHT, tpx))
    rad = untile_image(rad.reshape(-1, 3), WIDTH, HEIGHT, tpx, tx, ty)
    hit = untile_image(hit.reshape(-1), WIDTH, HEIGHT, tpx, tx, ty)
    return np.asarray(jint.finalize_image(rad, hit, jcfg)), called


FRAMES = {
    "soft": (dict(num_samples=S4), {}, TILE_PX,
             ["hits_attrs", "anyhit"]),
    "legacy": ({}, dict(tile_px=32, shadow_tile=256), 32,
               ["hits_shaded", "anyhit"]),
}
SPIES = ("hits_shaded", "hits_attrs", "hits", "anyhit", "anyhit_from_t")


@pytest.mark.parametrize("frame", list(FRAMES))
def test_frame_matches_jax(base, frame, monkeypatch):
    light_kw, cfg_kw, tpx, want_calls = FRAMES[frame]
    cfg, jcfg = configs(**light_kw)
    cfg, jcfg = cfg.replace(**cfg_kw), jcfg.replace(**cfg_kw)
    jimg, called = _jax_frame(base["jprep"], jcfg, tpx, SPIES, monkeypatch)
    assert called == want_calls, called
    n0 = table.calls()
    img = render(base["prep"], cfg, LIGHT).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert table.calls() == n0
    assert img.shape == (HEIGHT, WIDTH, 3)
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    # the shadow is in the frame: unshadowed, the image is brighter
    off = render(base["prep"], cfg.replace(
        light=sr.LightConfig(enable_shadows=False, **light_kw)),
        LIGHT).numpy().astype(int)
    assert ((off - img).max(axis=-1) > 0).sum() > 200
