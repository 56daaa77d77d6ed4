"""PyTorch port, differentiable rendering (``diff/render.py``) against the
JAX package's, on the same prepared scene.

The JAX side runs ``render_radiance_diff`` in bruteforce mode (plain jnp,
op by op); its gradients of sum(radiance**2) over the hit pixels with respect to every
field of ``DiffParams`` (vertices, materials, texture atlas, light) are the
reference, at JAX's own bars (tests/test_grad.py: rtol 2e-4, atol 1e-5):

* the port's bruteforce, BVH, tiled and paged gradients, with hard shadows
  and with S = 4 soft shadows, on the parity scene (icosphere(2) on the
  box ground, 64x32) and on its textured variant (``textured_on_ground``);
* light, vertex, texture and material gradients against finite
  differences (shadows off, as JAX's tests);
* the lean path (one [T, 13] table) against the record gather path;
  a ``hit_tile`` sub-tile against the full tile; the bruteforce recompute
  against autograd through the triangle passes of ``render_radiance``
  (which gives NaN where a ray lies in a face's plane);
* every gradient finite on frames with misses, a degenerate triangle 0
  included; a hit whose recompute misses its winner's moved triangle
  keeps the walk's t;
* the texture fit (``examples/fit_texture.py``) cuts its loss by 5x in 30
  Adam steps, as JAX's ``test_fit_texture_converges``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import (PreparedScene,
                                                        from_jax_prepared)
from simple_raytracer_tpu_torch.diff import (differentiable_hits,
                                             render_radiance_diff)
from simple_raytracer_tpu_torch.diff.render import _intersectors
from simple_raytracer_tpu_torch.dist.train import (DiffParams, apply_params,
                                                   extract_params)
from simple_raytracer_tpu_torch.examples import fit_texture
from simple_raytracer_tpu_torch.ops.camera import primary_rays
from simple_raytracer_tpu_torch.ops.intersect import moller_trumbore
from simple_raytracer_tpu_torch.render import integrator
from simple_raytracer_tpu_torch.render import renderer as trender

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.diff import render_radiance_diff as jdiff
from simple_raytracer_tpu.dist.train import apply_params as japply
from simple_raytracer_tpu.dist.train import extract_params as jextract

from _torch_parity import (LIGHT, jax_prepared_arrays, managers,
                           tilted_ground)

W, H, FOCAL = 64, 32, 100.0
FIELDS = [f.name for f in dataclasses.fields(DiffParams)]
RTOL, ATOL = 2e-4, 1e-5
# (mode, tiled_impl) of the port held to JAX's bruteforce gradients
MODES = [("bruteforce", None), ("bvh", None), ("tiled", None),
         ("tiled", "paged")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when
    other test processes load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(samples: int = 1, shadows: bool = True):
    light = dict(num_samples=samples, enable_shadows=shadows)
    cfg = sr.default_config().replace(
        camera=sr.CameraConfig(width=W, height=H, focal=FOCAL),
        light=sr.LightConfig(**light), bvh=sr.BVHConfig(split="sah"))
    jcfg = jconfig.default_config().replace(
        camera=jconfig.CameraConfig(width=W, height=H, focal=FOCAL),
        light=jconfig.LightConfig(**light),
        bvh=jconfig.BVHConfig(split="sah"))
    return cfg, jcfg


_SCENES = {}


def _scene(kind: str):
    """(port PreparedScene on the CPU, JAX PreparedScene) of the same
    padded, BVH-ordered triangles: "flat" (the parity scene), "textured"
    (its textured variant) or "tilted" (its ground turned off the axes)."""
    if kind not in _SCENES:
        build = {"flat": None, "textured": None,
                 "tilted": tilted_ground}[kind]
        _sm, jsm = managers(2, textured=kind == "textured", build=build)
        jprep = jprepare(jsm.build(), _configs()[1].replace(mode="tiled"))
        prep = from_jax_prepared(jax_prepared_arrays(jprep),
                                 has_textures=kind == "textured",
                                 device="cpu")
        _SCENES[kind] = prep, jprep
    return _SCENES[kind]


def _loss(rad, hit):
    return (torch.where(hit[..., None], rad, 0.0) ** 2).sum()


def port_grads(operand, cfg, light=LIGHT, **kw):
    """(loss, [grad of each DiffParams field, numpy]) of sum(radiance**2)
    over the hit pixels of ``render_radiance_diff(operand, cfg)``."""
    prep = operand if isinstance(operand, PreparedScene) else None
    base = operand.scene if prep is not None else operand
    leaves = [x.clone().requires_grad_(True)
              for x in extract_params(base, light).leaves()]
    s, lp = apply_params(base, DiffParams(*leaves))
    op = dataclasses.replace(prep, scene=s) if prep is not None else s
    loss = _loss(*render_radiance_diff(op, cfg, lp, **kw))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [np.zeros(p.shape, np.float32) if g is None
                         else g.numpy() for p, g in zip(leaves, grads)]


_JAX = {}


def jax_grads(kind: str, samples: int = 1):
    """JAX's bruteforce ``render_radiance_diff`` gradients of every
    DiffParams field on the scene ``kind``, evaluated op by op as the port
    evaluates them.  Under ``jax.jit`` XLA fuses the ops and rounds apart:
    on the textured ground, where one triangle's vertex gradient is a sum
    with heavy cancellation, JAX's jitted and op-by-op gradients differ by
    1%, and a ray at a texel seam reads the neighbouring texel."""
    key = (kind, samples)
    if key not in _JAX:
        jprep = _scene(kind)[1]
        jcfg = _configs(samples)[1].replace(mode="bruteforce")

        def loss(p):
            s, light = japply(jprep.scene, p)
            rad, hit = jdiff(s, jcfg, light)
            return jnp.sum(jnp.where(hit[..., None], rad, 0.0) ** 2)
        p0 = jextract(jprep.scene, jnp.asarray(LIGHT))
        g = jax.grad(loss)(p0)
        _JAX[key] = [np.asarray(getattr(g, n)) for n in FIELDS]
    return _JAX[key]


def _hold(got, want, names=FIELDS, rtol=RTOL, atol=ATOL):
    for a, b, name in zip(got, want, names):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("mode,impl", MODES)
def test_grads_match_jax_bruteforce(mode, impl, samples):
    """Every mode's gradients of every DiffParams field equal JAX's
    bruteforce ones, hard shadows and S = 4 soft shadows."""
    prep, _ = _scene("flat")
    cfg = _configs(samples)[0].replace(mode=mode, tiled_impl=impl)
    _, got = port_grads(prep if mode != "bruteforce" else prep.scene, cfg)
    want = jax_grads("flat", samples)
    _hold(got, want)
    for name in ("verts", "obj_color", "obj_ambient", "obj_specular",
                 "light_pos"):
        assert np.abs(want[FIELDS.index(name)]).sum() > 0, name


@pytest.mark.parametrize("mode,impl", MODES)
def test_textured_grads_match_jax_bruteforce(mode, impl):
    """The textured scene takes the record gather path: its atlas and
    material gradients equal JAX's too."""
    prep, _ = _scene("textured")
    cfg = _configs()[0].replace(mode=mode, tiled_impl=impl)
    _, got = port_grads(prep if mode != "bruteforce" else prep.scene, cfg)
    want = jax_grads("textured")
    _hold(got, want)
    for name in ("verts", "tex_data", "obj_shininess", "light_pos"):
        assert np.abs(want[FIELDS.index(name)]).sum() > 0, name


def _fd_loss(prep, cfg):
    def f(verts=None, light=LIGHT):
        s = prep.scene if verts is None else dataclasses.replace(
            prep.scene, verts=torch.as_tensor(verts))
        with torch.no_grad():
            return float(_loss(*render_radiance_diff(
                dataclasses.replace(prep, scene=s), cfg,
                torch.as_tensor(light, dtype=torch.float32))))
    return f


def test_light_grad_finite_difference():
    """The light gradient against central differences (bvh mode, shadows
    off: the shadow predicate is a step function; JAX test_grad.py)."""
    prep, _ = _scene("flat")
    cfg = _configs(shadows=False)[0].replace(mode="bvh")
    _, g = port_grads(prep, cfg)
    g = g[FIELDS.index("light_pos")]
    f = _fd_loss(prep, cfg)
    eps = 4.0
    light = np.asarray(LIGHT, np.float32)
    for k in range(3):
        e = np.zeros(3, np.float32)
        e[k] = eps
        fd = (f(light=light + e) - f(light=light - e)) / (2 * eps)
        np.testing.assert_allclose(g[k], fd, rtol=5e-2, atol=1e-6)


def test_vertex_grad_finite_difference():
    """The largest vertex gradients against central differences at two
    steps, skipping probes on a triangle-assignment edge (JAX
    test_grad.py)."""
    prep, _ = _scene("flat")
    cfg = _configs(shadows=False)[0].replace(mode="bvh")
    _, g = port_grads(prep, cfg)
    g = g[FIELDS.index("verts")]
    f = _fd_loss(prep, cfg)
    v = prep.scene.verts.numpy()
    order = np.argsort(np.abs(g[..., :3]).reshape(-1))[::-1][:6]

    def fd_at(ti, vi, ci, eps):
        vp, vm = v.copy(), v.copy()
        vp[ti, vi, ci] += eps
        vm[ti, vi, ci] -= eps
        return (f(vp) - f(vm)) / (2 * eps)

    checked = 0
    for o in order:
        ti, vi, ci = np.unravel_index(o, g[..., :3].shape)
        fd1, fd2 = fd_at(ti, vi, ci, 1e-2), fd_at(ti, vi, ci, 1e-3)
        if abs(fd1 - fd2) > 0.1 * max(abs(fd1), abs(fd2), 1e-3):
            continue
        np.testing.assert_allclose(g[ti, vi, ci], fd2, rtol=5e-2, atol=2e-3)
        checked += 1
    assert checked >= 2, "not enough smooth probes"


def test_texture_and_material_grads_finite_difference():
    """Atlas, specular, shininess and ambient gradients of the bruteforce
    ``render_radiance`` (autograd through the texel gather) against central
    differences on the textured scene (JAX test_grad_tex_mat.py)."""
    prep, _ = _scene("textured")
    scene = prep.scene
    cfg = _configs(shadows=False)[0].replace(
        camera=sr.CameraConfig(width=48, height=36, focal=FOCAL))
    names = ("tex_data", "obj_specular", "obj_shininess", "obj_ambient")

    def loss(**kw):
        return _loss(*sr.render_radiance(dataclasses.replace(scene, **kw),
                                         cfg, LIGHT))
    args = {n: getattr(scene, n).clone().requires_grad_(True) for n in names}
    grads = torch.autograd.grad(loss(**args), list(args.values()))
    g = {n: x.numpy() for n, x in zip(names, grads)}
    assert all(np.abs(x).sum() > 0 for x in g.values())

    def fd(name, index, eps):
        x = getattr(scene, name).clone()
        x[index] += eps
        hi = float(loss(**{name: x}))
        x[index] -= 2 * eps
        return (hi - float(loss(**{name: x}))) / (2 * eps)

    tex = g["tex_data"]
    for o in np.argsort(np.abs(tex).reshape(-1))[::-1][:4]:
        pi, ci = np.unravel_index(o, tex.shape)
        np.testing.assert_allclose(tex[pi, ci], fd("tex_data", (pi, ci),
                                                   1e-2),
                                   rtol=5e-2, atol=1e-4)
    for name, eps in (("obj_specular", 1e-3), ("obj_shininess", 1e-2),
                      ("obj_ambient", 1e-3)):
        np.testing.assert_allclose(g[name][0], fd(name, 0, eps), rtol=5e-2,
                                   atol=1e-3, err_msg=name)


@pytest.mark.parametrize("mode", ["bruteforce", "tiled"])
def test_lean_path_equals_record_gather_path(mode):
    """The lean path (one [T, 13] table, materials by select) against the
    record gather path (``differentiable_hits``, then ``integrator.shade``
    with ``gather_hit_records``): the same radiance, bit for bit, and the
    same gradients but for the order of their sums."""
    prep, _ = _scene("flat")
    cfg = _configs()[0].replace(mode=mode)
    operand = prep if mode != "bruteforce" else prep.scene
    lean_loss, lean = port_grads(operand, cfg)

    leaves = [x.clone().requires_grad_(True)
              for x in extract_params(prep.scene, LIGHT).leaves()]
    s, lp = apply_params(prep.scene, DiffParams(*leaves))
    op = dataclasses.replace(prep, scene=s) if mode != "bruteforce" else s
    hit_fn, shadow_fn = _intersectors(op, cfg, False, False)
    o, d = primary_rays(W, H, FOCAL)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t, idx = differentiable_hits(hit_fn, s.verts_cart(), o, d, cfg.mt_eps)
    rad = integrator.shade(s, cfg, o, d, t, idx, lp, shadow_fn)
    loss = _loss(rad.reshape(H, W, 3), torch.isfinite(t).reshape(H, W))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert float(loss.detach()) == lean_loss
    _hold([np.zeros(p.shape, np.float32) if x is None else x.numpy()
           for p, x in zip(leaves, grads)], lean, rtol=1e-5, atol=1e-7)


def test_hit_sub_tile_equals_full_tile():
    """``hit_tile`` sub-tiles of the tile-major stream (1,024 and 2,048
    rays of the 4,096-ray tile) give the same winners, so the same loss
    and gradients, bit for bit."""
    prep, _ = _scene("flat")
    cfg = _configs()[0].replace(mode="tiled")
    full_loss, full = port_grads(prep, cfg)
    for ht in (1024, 2048):
        loss, got = port_grads(prep, cfg.replace(hit_tile=ht))
        assert loss == full_loss
        for a, b, name in zip(got, full, FIELDS):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} at {ht}")


@pytest.mark.parametrize("kind", ["tilted", "flat"])
def test_recompute_equals_autograd_through_the_passes(kind, monkeypatch):
    """Bruteforce ``render_radiance`` under autograd keeps every triangle
    pass (here 21 of them) and differentiates every ray-triangle pair;
    ``render_radiance_diff`` differentiates the winners only.  On the
    built scene with the tilted ground both give the same gradients.  On
    the axis-aligned ground the rays of the centre row and column lie in
    faces' planes: the passes' gradients are NaN there, the recompute's
    finite."""
    build = tilted_ground if kind == "tilted" else None
    scene = managers(2, build=build)[0].build()
    cfg = _configs()[0]
    monkeypatch.setattr(trender, "PAIRS_PER_PASS", W * H * 16)
    names = ("verts", "obj_color", "light_pos")
    leaves = [x.clone().requires_grad_(True)
              for x in extract_params(scene, LIGHT).leaves()]
    s, lp = apply_params(scene, DiffParams(*leaves))
    loss = _loss(*sr.render_radiance(s, cfg, lp))
    passes = [g.numpy() for g in torch.autograd.grad(
        loss, [leaves[FIELDS.index(n)] for n in names])]
    _, got = port_grads(scene, cfg)
    got = [got[FIELDS.index(n)] for n in names]
    assert all(np.abs(g).sum() > 0 for g in got)
    if kind == "tilted":
        _hold(passes, got, names)
    else:
        assert not np.isfinite(passes[0]).all()
        assert all(np.isfinite(g).all() for g in got)


@pytest.mark.parametrize("mode,impl", MODES)
@pytest.mark.parametrize("kind", ["flat", "textured"])
def test_grads_finite_where_rays_miss(kind, mode, impl):
    """On frames where about two thirds of the rays miss, every gradient
    is finite: the lean path (flat) and the record gather path (textured,
    smooth normals)."""
    prep, _ = _scene(kind)
    cfg = _configs(4)[0].replace(
        mode=mode, tiled_impl=impl,
        shading=sr.ShadingConfig(smooth_normals=kind == "textured"))
    operand = prep if mode != "bruteforce" else prep.scene
    with torch.no_grad():
        _, hit = render_radiance_diff(operand, cfg, LIGHT)
    assert 0.2 < float(hit.float().mean()) < 0.5
    _, got = port_grads(operand, cfg)
    for g, name in zip(got, FIELDS):
        assert np.isfinite(g).all(), name
    assert np.abs(got[0]).sum() > 0


def test_grads_finite_with_a_degenerate_first_triangle():
    """A miss reads a real winner's row, not triangle 0's: with triangle 0
    degenerate (zero area, zero normals) and smooth textured shading, the
    shading of the misses stays finite and so does every gradient."""
    prep, _ = _scene("textured")
    scene = prep.scene
    verts = scene.verts.clone()
    verts[0] = verts[0, :1]
    vnormals = scene.vnormals.clone()
    vnormals[0] = 0.0
    bad = dataclasses.replace(scene, verts=verts, vnormals=vnormals)
    cfg = _configs()[0].replace(
        shading=sr.ShadingConfig(smooth_normals=True))
    _, got = port_grads(bad, cfg)
    for g, name in zip(got, FIELDS):
        assert np.isfinite(g).all(), name
    assert np.abs(got[0]).sum() > 0


def test_walk_verdict_stands_where_the_recompute_misses():
    """The tiled walks read the tables made at prepare time.  Move the
    ground's vertices by one ulp of w (as a training step does) and, at
    focal 30, the rays on its edges miss their winner's moved triangle in
    the recompute; their hits stand, with the walk's t and no gradient,
    so the frame loses no hit and every gradient is finite."""
    prep, _ = _scene("flat")
    cfg = _configs()[0].replace(mode="tiled", camera=sr.CameraConfig(
        width=W, height=H, focal=30.0))
    verts = prep.scene.verts.clone()
    verts[prep.scene.tri_obj == 1, :, 3] = float(
        np.nextafter(np.float32(1.0), np.float32(0.0)))
    moved = dataclasses.replace(prep, scene=dataclasses.replace(
        prep.scene, verts=verts))
    hit_fn, _ = _intersectors(moved, cfg, False, False)
    o, d = primary_rays(W, H, 30.0)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t_walk, idx = hit_fn(o, d)
    t = differentiable_hits(hit_fn, moved.scene.verts_cart(), o, d)[0]
    redo = moller_trumbore(
        o, d, moved.scene.verts_cart()[idx.clamp_min(0).long()])
    stands = (idx >= 0) & ~torch.isfinite(redo)
    assert int(stands.sum()) > 0
    assert torch.equal(t[stands], t_walk[stands])
    with torch.no_grad():
        _, hit0 = render_radiance_diff(prep, cfg, LIGHT)
    _, hit1 = render_radiance_diff(moved, cfg, LIGHT)
    assert torch.equal(hit0, hit1)
    _, got = port_grads(moved, cfg)
    for g, name in zip(got, FIELDS):
        assert np.isfinite(g).all(), name


def test_fit_texture_converges():
    """The texture fit's 30 Adam steps at 48x36 cut the image loss by more
    than 5x (JAX test_fit_texture_converges, on the procedural scene)."""
    scene, cfg = fit_texture.scene_and_config(None, 48, 36, device="cpu")
    _tex, losses, _target, _hit = fit_texture.fit(scene, cfg, LIGHT, 30)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] / 5.0, (losses[0], losses[-1])
