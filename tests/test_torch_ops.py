"""PyTorch port: ops (intersection, camera, shading, finish) vs the JAX ops.

Inputs are drawn from a seeded numpy generator and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.kernels.nearest import fused_phong
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.ops import intersect as tis
from simple_raytracer_tpu_torch.ops import shading as tsh
from simple_raytracer_tpu_torch.render import integrator as tint
from simple_raytracer_tpu_torch.render.integrator import finalize_image

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.ops import camera as jcam
from simple_raytracer_tpu.ops import intersect as jis
from simple_raytracer_tpu.ops import shading as jsh
from simple_raytracer_tpu.render import integrator as jint

from _torch_parity import LIGHT, VIEW, managers


def _rays_and_tris(n_rays=512, n_tris=64, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=0.5, size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    v = (rng.normal(scale=2.0, size=(n_tris, 3, 3))
         + np.array([0.0, 0.0, 6.0])).astype(np.float32)
    return o, d, v


def test_moller_trumbore_matches_jax():
    o, d, v = _rays_and_tris()
    ours = tis.moller_trumbore(torch.from_numpy(o)[:, None],
                               torch.from_numpy(d)[:, None],
                               torch.from_numpy(v)[None]).numpy()
    theirs = np.asarray(jis.moller_trumbore(o[:, None], d[:, None],
                                            v[None]))
    hit_o, hit_j = np.isfinite(ours), np.isfinite(theirs)
    assert hit_o.sum() > 1000
    assert (hit_o == hit_j).mean() > 0.999
    both = hit_o & hit_j
    np.testing.assert_allclose(ours[both], theirs[both], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("no_max_t", [True, False])
def test_occlusion_predicate_matches_division_form(no_max_t):
    """The division-free predicate agrees with t = MT distance: a hit at
    any t >= 0 (or, with a max-t, t <= 1)."""
    o, d, v = _rays_and_tris(seed=1)
    d = d * 5.0                     # so that about half the hits have t <= 1
    p1 = torch.from_numpy(v[:, 0])[None]
    e1 = torch.from_numpy(v[:, 1] - v[:, 0])[None]
    e2 = torch.from_numpy(v[:, 2] - v[:, 0])[None]
    num = tis.mt_numerators(tis.xyz(torch.from_numpy(o)[:, None]),
                            tis.xyz(torch.from_numpy(d)[:, None]),
                            tis.xyz(p1), tis.xyz(e1), tis.xyz(e2))
    occ = tis.mt_occludes(*num, 1e-12, no_max_t)
    t = tis.mt_distance(*num, 1e-12)
    ref = torch.isfinite(t) if no_max_t else t <= 1.0
    assert ref.sum() > 100
    assert (occ == ref).float().mean() > 0.999


def test_phong_and_tonemap_match_jax():
    rng = np.random.default_rng(2)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    p = rng.normal(scale=5.0, size=(256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    light = np.array([500.0, -300.0, -200.0], np.float32)
    lc = np.ones(3, np.float32)
    col = rng.uniform(size=(256, 3)).astype(np.float32)
    amb = rng.uniform(size=256).astype(np.float32)
    spec = rng.uniform(size=256).astype(np.float32)
    shin = rng.uniform(0.0, 30.0, size=256).astype(np.float32)
    shin[:8] = 0.0
    for ds, snl in ((True, True), (False, False)):
        args = (n, p, d, light, lc, col, amb, spec, shin)
        ours = tsh.phong(*map(torch.from_numpy, args), ds, snl).numpy()
        theirs = np.asarray(jsh.phong(*args, ds, snl))
        np.testing.assert_allclose(ours, theirs, rtol=2e-5, atol=2e-6)
    c = rng.uniform(0.0, 3.0, size=(256, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.tonemap(torch.from_numpy(c)).numpy(),
                               np.asarray(jsh.tonemap(c)), rtol=1e-6)
    np.testing.assert_array_equal(
        tsh.quantize_255(torch.from_numpy(c / 3)).numpy(),
        np.asarray(jsh.quantize_255(c / 3)))


def test_fused_phong_matches_phong():
    """The kernel's Phong term (premultiplied material rows, pow through
    exp/log, shininess 0 -> full specular) equals the integrator's phong."""
    rng = np.random.default_rng(3)
    N = 512
    n = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    n = n / n.norm(dim=1, keepdim=True)
    p = torch.from_numpy(rng.normal(scale=5.0, size=(N, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    light = torch.tensor([500.0, -300.0, -200.0])
    scene = sr.Scene(*[torch.zeros(0)] * 7,
                     obj_color=torch.tensor([[0.8, 0.7, 0.6], [0.0, 1.0, 0.0]]),
                     obj_ambient=torch.tensor([0.2, 0.3]),
                     obj_specular=torch.tensor([0.5, 0.9]),
                     obj_shininess=torch.tensor([15.0, 0.0]),
                     tex_data=torch.zeros(1, 3), tex_offset=torch.zeros(1),
                     tex_width=torch.ones(1), tex_height=torch.ones(1))
    from simple_raytracer_tpu_torch.kernels.nearest import material_table
    mat = material_table(scene, (1.0, 1.0, 1.0))
    obj = torch.from_numpy(rng.integers(0, 2, size=N))
    for ds, snl in ((True, True), (False, True), (True, False)):
        ours = torch.stack(fused_phong(
            tuple(n.unbind(1)), obj, tuple(p.unbind(1)), tuple(d.unbind(1)),
            tuple(light), mat, ds, snl), dim=1)
        ref = tsh.phong(n, p, d, light, torch.ones(3), scene.obj_color[obj],
                        scene.obj_ambient[obj], scene.obj_specular[obj],
                        scene.obj_shininess[obj], ds, snl)
        torch.testing.assert_close(ours, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("view", [None, VIEW])
def test_tile_major_rays_match_jax(view):
    W, H, tpx = 150, 70, 32
    o, d, tx, ty = tcam.primary_rays_tiled(W, H, tpx, 400.0,
                                           view_matrix=view)
    jo, jd, jtx, jty = jcam.primary_rays_tiled(W, H, tpx, 400.0,
                                               view_matrix=view)
    assert (tx, ty) == (jtx, jty)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    # the kernels' rebuild d = fx*A + fy*B + C
    from simple_raytracer_tpu_torch.kernels import plan as pl
    n = tx * ty
    px0, py0 = pl.tile_origins(n, tx, tpx, W, H)
    cam = pl.make_cam(None if view is None else torch.from_numpy(view),
                      400.0, (0.0, 0.0, 0.0))
    rd = torch.stack(tcam.tile_ray_dirs(cam, px0, py0, tpx), -1).reshape(-1, 3)
    if view is None:
        assert torch.equal(rd, d)            # exact for the identity view
    else:
        torch.testing.assert_close(rd, d, rtol=1e-6, atol=1e-4)
    img = torch.arange(o.shape[0] * 2, dtype=torch.float32).reshape(-1, 2)
    ours = tcam.untile_image(img, W, H, tpx, tx, ty).numpy()
    theirs = np.asarray(jcam.untile_image(jnp.asarray(img.numpy()), W, H,
                                          tpx, tx, ty))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("truncate", [True, False])
def test_finalize_image_matches_jax(truncate):
    rng = np.random.default_rng(4)
    rad = rng.uniform(0.0, 1.0, size=(24, 32, 3)).astype(np.float32)
    rad[:3] = 0.0                               # exact black -> background
    hit = rng.uniform(size=(24, 32)) > 0.3
    cfg = sr.default_config()
    cfg = cfg.replace(shading=type(cfg.shading)(quantize_truncate=truncate))
    jcfg = jconfig.default_config()
    jcfg = jcfg.replace(shading=type(jcfg.shading)(quantize_truncate=truncate))
    ours = finalize_image(torch.from_numpy(rad), torch.from_numpy(hit), cfg)
    theirs = np.asarray(jint.finalize_image(rad, hit, jcfg))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), theirs)


def _tris(rng, n):
    v = rng.normal(scale=3.0, size=(n, 3, 3)).astype(np.float32)
    bary = rng.dirichlet(np.ones(3), size=n).astype(np.float32)
    point = np.einsum("nv,nvk->nk", bary, v).astype(np.float32)
    return v, point


def test_shading_ops_match_jax():
    """barycentric, flat_normal, smooth_normal and interpolate_uv at rtol
    1e-6; texture_fetch reads the same texels (truncation toward zero, no
    wrap, clamped to each texture's rectangle)."""
    rng = np.random.default_rng(8)
    v, point = _tris(rng, 512)
    point[::7] += rng.normal(size=(len(point[::7]), 3)).astype(np.float32)
    ours = tsh.barycentric(torch.from_numpy(v), torch.from_numpy(point))
    bary = np.array(jsh.barycentric(v, point))
    np.testing.assert_allclose(ours.numpy(), bary, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsh.flat_normal(torch.from_numpy(v)).numpy(),
                               np.asarray(jsh.flat_normal(v)), rtol=1e-6,
                               atol=1e-7)
    vn = rng.normal(size=(512, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.smooth_normal(torch.from_numpy(vn), torch.from_numpy(bary))
        .numpy(), np.asarray(jsh.smooth_normal(vn, bary)), rtol=1e-6,
        atol=1e-6)
    uvs = rng.uniform(-8.0, 72.0, size=(512, 3, 2)).astype(np.float32)
    texel = tsh.interpolate_uv(torch.from_numpy(uvs), torch.from_numpy(bary))
    jtexel = np.array(jsh.interpolate_uv(uvs, bary))
    np.testing.assert_allclose(texel.numpy(), jtexel, rtol=1e-6, atol=1e-5)
    # an atlas of two textures (32x16 and 8x64), ids -1 read texture 0
    tex = rng.uniform(size=(32 * 16 + 8 * 64, 3)).astype(np.float32)
    off, w, h = (np.array(a, np.int32) for a in ((0, 512), (32, 8),
                                                 (16, 64)))
    tid = rng.integers(-1, 2, 512).astype(np.int32)
    args = (tex, off, w, h, tid, jtexel)
    ours = tsh.texture_fetch(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jsh.texture_fetch(*args)))
    clamped = (jtexel < 0).any(-1) | (jtexel[:, 0] >= w[np.maximum(tid, 0)])
    assert clamped.sum() > 50


@pytest.fixture(scope="module")
def textured_scenes():
    """The textured, smooth-normal parity scene (subdivision 1) in both
    packages."""
    sm, jsm = managers(1, textured=True)
    return sm.build(), jsm.build()


@pytest.mark.parametrize("kind", ["flat", "smooth", "textured_flat",
                                  "textured_smooth"])
def test_gather_hit_records_match_jax(textured_scenes, kind):
    """The packed one-row gather: the same columns, equal values, misses
    (id -1) read row 0."""
    if kind.startswith("textured"):
        scene, jscene_ = textured_scenes
    else:
        sm, jsm = managers(1)
        scene, jscene_ = sm.build(), jsm.build()
    smooth = kind.endswith("smooth")
    cfg = sr.default_config().replace(
        shading=sr.ShadingConfig(smooth_normals=smooth))
    jcfg = jconfig.default_config().replace(
        shading=jconfig.ShadingConfig(smooth_normals=smooth))
    idx = np.random.default_rng(9).integers(-1, scene.num_triangles, 300)
    idx = idx.astype(np.int32)
    rec = tint.gather_hit_records(scene, torch.from_numpy(idx), cfg)
    jrec = jint.gather_hit_records(jscene_, jnp.asarray(idx), jcfg)
    assert set(rec) == set(jrec)
    assert ("uvs" in rec) == kind.startswith("textured")
    assert ("vnormals" in rec) == smooth and ("normal" in rec) != smooth
    for k in rec:
        np.testing.assert_array_equal(rec[k].numpy(), np.asarray(jrec[k]),
                                      err_msg=k)


@pytest.mark.parametrize("smooth", [False, True])
def test_shade_textured_records_match_jax(textured_scenes, smooth):
    """shade_records on gathered textured (and smooth-normal) records, at
    points on the hit triangles, S = 4 samples with a given shadow pattern:
    rtol 1e-5."""
    scene, jscene_ = textured_scenes
    S, R = 4, 512
    light = dict(num_samples=S)
    cfg = sr.default_config().replace(
        shading=sr.ShadingConfig(smooth_normals=smooth),
        light=sr.LightConfig(**light))
    jcfg = jconfig.default_config().replace(
        shading=jconfig.ShadingConfig(smooth_normals=smooth),
        light=jconfig.LightConfig(**light))
    rng = np.random.default_rng(10)
    idx = rng.integers(0, scene.num_triangles, R).astype(np.int32)
    idx[:64] = np.flatnonzero(scene.tri_tex.numpy() >= 0)[
        rng.integers(0, 12, 64)]                   # textured ground hits
    v = (scene.verts[..., :3] / scene.verts[..., 3:4]).numpy()[idx]
    bary = rng.dirichlet(np.ones(3), size=R).astype(np.float32)
    point = np.einsum("nv,nvk->nk", bary, v).astype(np.float32)
    o = rng.normal(scale=2.0, size=(R, 3)).astype(np.float32)
    d = (point - o).astype(np.float32)
    t = np.ones(R, np.float32)
    t[::31] = np.inf
    shadow = rng.random(S * R) < 0.3
    lp = np.array(LIGHT, np.float32)
    rec = tint.gather_hit_records(scene, torch.from_numpy(idx), cfg)
    got = tint.shade_records(
        scene, cfg, rec, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t), torch.from_numpy(lp),
        lambda *a, **k: torch.from_numpy(shadow)).numpy()
    jrec = jint.gather_hit_records(jscene_, jnp.asarray(idx), jcfg)
    want = np.asarray(jint.shade_records(
        jscene_, jcfg, jrec, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        jnp.asarray(lp), lambda *a, **k: jnp.asarray(shadow)))
    fin = np.isfinite(t)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    # the texels reached the colour: textured hits differ from the
    # material colour's shading
    plain = tint.shade_records(
        scene, cfg, {k: x for k, x in rec.items() if k != "uvs"},
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
        torch.from_numpy(lp), lambda *a, **k: torch.from_numpy(shadow))
    assert (np.abs(plain.numpy()[:64] - got[:64]).max(-1) > 1e-3).sum() > 30
