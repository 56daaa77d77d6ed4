"""PyTorch port, K1's textured and smooth-normal modes (JAX
``kernels/tiled_t.py::_fused_phong`` attribute modes 1 and 2) and the
one-sample textured and smooth-normal frames that run them.

* The map tables ``tri_tex_map`` and ``tri_nrm_map`` against the JAX
  package's ``attr_t`` (three bf16 limbs per value, decoded h + m + l in
  f32): equal bit for bit on every row.
* K1's plain version in modes 1 and 2 (``nearest.hits_shaded``) against
  JAX's ``tiled_t.hits_shaded`` (its Pallas kernel in interpret mode).  t
  at the JAX package's bars (tests/test_tiled.py:74-78: rtol 1e-4 / atol
  1e-6, idx equal on >= 99.9% of rays); on rays whose idx agrees: dw and sw
  at rtol 2e-4 / atol 2e-6, texel coordinates within 1e-2 texels (the hit
  points differ in their last bits, since JAX contracts a Gram matrix, and
  A p + c cancels), rgb at rtol 1e-4 / atol 1e-5, obj and tex id equal.
* The frames through ``render`` against JAX's frame, a spy showing that JAX
  ran ``hits_shaded``, at JAX's image bars (within 1 on >= 99.9% of pixels,
  equal on >= 98%).

Scenes: the parity scene (icosphere(3) on the box ground, 128x128), with a
checker-textured ground (``procedural.textured_on_ground``) or with radial
vertex normals and no texture (``procedural.smooth_on_ground``).  Each JAX
scene is prepared with the config it is rendered with: JAX picks the
attribute layout in ``prepare``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import (from_jax_prepared,
                                                        prepare, uv_affine_np)
from simple_raytracer_tpu_torch.kernels import nearest, table, tiled
from simple_raytracer_tpu_torch.render.renderer import render
from simple_raytracer_tpu_torch.scene import catalog
from simple_raytracer_tpu_torch.scene import procedural as P

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.accel import prepared as jprepared
from simple_raytracer_tpu.kernels import tiled_t
from simple_raytracer_tpu.scene import catalog as jcatalog

from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_frame, jax_prepared_arrays, managers)

TILE = TILE_PX * TILE_PX
SPIED = ("hits", "hits_attrs", "hits_shaded", "anyhit", "anyhit_from_t")


def _shading(cfg, jcfg, **kw):
    return (cfg.replace(shading=sr.ShadingConfig(**kw)),
            jcfg.replace(shading=jconfig.ShadingConfig(**kw)))


@pytest.fixture(scope="module")
def scenes():
    """The textured and the smooth-normal parity scenes in both packages,
    the JAX one prepared with the frame's config: {kind: (port prep, JAX
    prep)}."""
    out = {}
    for kind, build, smooth in (("textured", P.textured_on_ground, False),
                                ("smooth", P.smooth_on_ground, True)):
        _, jsm = managers(build=build)
        cfg, jcfg = _shading(*configs(), smooth_normals=smooth)
        jprep = jprepared.prepare(jsm.build(), jcfg)
        assert jprep.attr_tex == (kind == "textured")
        assert jprep.attr_smooth == (kind == "smooth")
        prep = from_jax_prepared(jax_prepared_arrays(jprep),
                                 has_textures=kind == "textured",
                                 num_triangles=int(jprep.num_triangles),
                                 device="cpu")
        out[kind] = (prep, jprep)
    return out


def _attr_rows(jprep, rows):
    """JAX ``attr_t`` rows [3 limbs x K] decoded per triangle: [Tp, K] f32,
    (h + m) + l in the kernel's order, from each triangle's lane."""
    a = np.asarray(jprep.attr_t).astype(np.float32)
    bs = jprep.block_size
    tp = jprep.scene.verts.shape[0]
    i = np.arange(tp)
    lane = (i // bs) * 4 * bs + i % bs
    k = len(rows) // 3
    h, m, l = (a[rows[j * k:(j + 1) * k]][:, lane].T for j in range(3))
    return (h + m) + l


def test_tex_map_equals_jax_attr_t(scenes):
    prep, jprep = scenes["textured"]
    tm = prep.tri_tex_map.numpy()
    uv = _attr_rows(jprep, list(range(12, 36)))       # 3 limbs x 8 values
    assert tm.shape == (uv.shape[0], 12)
    np.testing.assert_array_equal(tm[:, :8], uv)
    tex = np.asarray(jprep.attr_t)[36].astype(np.float32)
    bs = jprep.block_size
    i = np.arange(tm.shape[0])
    np.testing.assert_array_equal(tm[:, 8], tex[(i // bs) * 4 * bs + i % bs])
    np.testing.assert_array_equal(tm[:, 9:], 0.0)
    assert (tm[:, 8] == 0).sum() == 12           # the ground's faces
    assert np.abs(tm[:, :8]).max() > 1.0


def test_nrm_map_equals_jax_attr_t(scenes):
    prep, jprep = scenes["smooth"]
    nm = prep.tri_nrm_map.numpy()
    cn = _attr_rows(jprep, list(range(0, 12)))[:, :3]     # (cn, obj) limbs
    an = _attr_rows(jprep, list(range(12, 39)))           # 3 limbs x 9
    np.testing.assert_array_equal(nm[:, :3], cn)
    np.testing.assert_array_equal(nm[:, 3:], an)
    assert np.abs(nm[:, 3:]).max() > 0.01        # the sphere's varying normals


def test_degenerate_and_pad_rows_take_the_constant_map(scenes):
    """A zero-area triangle maps to its first vertex's value, as JAX's
    uv_affine_np; the prepared pad rows (degenerate copies, zero UVs and
    normals) hold the zero map."""
    tris = np.array([[[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [2.0, 2.0, 2.0]],
                     [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    uvs = np.array([[[3.0, 4.0], [5.0, 6.0], [7.0, 9.0]]] * 2)
    A, c = uv_affine_np(tris, uvs)
    jA, jc = jprepared.uv_affine_np(tris, uvs)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(A[0], 0.0)
    np.testing.assert_array_equal(c[0], [3.0, 4.0])
    assert np.abs(A[1]).max() > 0.1
    for kind, table in (("textured", "tri_tex_map"), ("smooth", "tri_nrm_map")):
        prep, _ = scenes[kind]
        tri = prep.tri.numpy()
        area = np.linalg.norm(np.cross(tri[:, 3:6], tri[:, 6:9]), axis=1)
        pad = area == 0
        assert pad.sum() > 100
        rows = getattr(prep, table).numpy()[pad]
        if kind == "textured":
            np.testing.assert_array_equal(rows[:, :8], 0.0)
            np.testing.assert_array_equal(rows[:, 8], -1.0)   # no texture
        else:
            np.testing.assert_array_equal(rows, 0.0)


@pytest.fixture(scope="module")
def k1_results(scenes):
    """K1 in each new mode through both packages on the moved view:
    {kind: (JAX outputs, port outputs)} as numpy."""
    out = {}
    for kind in ("textured", "smooth"):
        prep, jprep = scenes[kind]
        cfg, _ = _shading(*configs(), smooth_normals=kind == "smooth")
        R = (WIDTH // TILE_PX) * (HEIGHT // TILE_PX) * TILE
        dummy = jnp.zeros((R, 3), jnp.float32)     # rays come from cam_spec
        jres = tiled_t.hits_shaded(
            jprep, dummy, dummy, TILE, cfg.mt_eps, jnp.asarray(LIGHT),
            jnp.asarray(cfg.light.color, jnp.float32), cfg.cull_maxv,
            (jnp.asarray(VIEW), FOCAL, WIDTH, HEIGHT, TILE_PX), True, True,
            want_bounds=1)
        res = nearest.hits_shaded(prep, cfg, torch.tensor(LIGHT),
                                  (torch.from_numpy(VIEW), FOCAL, WIDTH,
                                   HEIGHT, TILE_PX), cfg.cull_maxv)
        out[kind] = ([np.asarray(x) for x in jres], [x.numpy() for x in res])
    return out


@pytest.mark.parametrize("kind", ["textured", "smooth"])
def test_k1_mode_hits_match_jax(k1_results, kind):
    (jt, ji, *_), (t, idx, *_) = k1_results[kind]
    hj, ho = np.isfinite(jt), np.isfinite(t)
    assert hj.sum() > 4000 and (hj == ho).mean() > 0.999
    both = hj & ho
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)
    assert (idx == ji).mean() > 0.999
    assert (idx[~ho] == -1).all()


def test_k1_textured_mode_matches_jax(k1_results):
    (jt, ji, jo, jc, jb), (t, idx, obj, comp, b) = k1_results["textured"]
    assert comp.shape == (t.shape[0], 6)
    same = (idx == ji) & np.isfinite(t)
    assert same.sum() > 4000
    np.testing.assert_array_equal(obj[same], jo[same])
    np.testing.assert_array_equal(comp[same, 4], obj[same])
    np.testing.assert_array_equal(comp[same, 5], jc[same, 5])
    textured = same & (comp[:, 5] >= 0)
    assert textured.sum() > 1000                 # the checker ground
    np.testing.assert_allclose(comp[same, :2], jc[same, :2], rtol=2e-4,
                               atol=2e-6)
    texel_err = np.abs(comp[textured, 2:4] - jc[textured, 2:4]).max()
    assert texel_err <= 1e-2, texel_err
    miss = ~np.isfinite(t)
    np.testing.assert_array_equal(comp[miss], [[0, 0, 0, 0, -1, -1]] *
                                  int(miss.sum()))
    fin = np.isfinite(b)
    np.testing.assert_array_equal(fin, np.isfinite(jb))
    np.testing.assert_allclose(b[fin], jb[fin], rtol=1e-4, atol=1e-4)


def test_k1_smooth_mode_matches_jax(k1_results):
    (jt, ji, jo, jrgb, jb), (t, idx, obj, rgb, b) = k1_results["smooth"]
    assert rgb.shape == (t.shape[0], 3)
    same = (idx == ji) & np.isfinite(t)
    assert same.sum() > 4000
    np.testing.assert_array_equal(obj[same], jo[same])
    np.testing.assert_allclose(rgb[same], jrgb[same], rtol=1e-4, atol=1e-5)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(fin, np.isfinite(jb))
    np.testing.assert_allclose(b[fin], jb[fin], rtol=1e-4, atol=1e-4)


def test_smooth_mode_differs_from_flat(scenes):
    """The smooth mode shades with the interpolated normals: its rgb leaves
    the flat mode's on the sphere."""
    prep, _ = scenes["smooth"]
    cs = (torch.from_numpy(VIEW), FOCAL, WIDTH, HEIGHT, TILE_PX)
    out = {}
    for smooth in (False, True):
        cfg, _ = _shading(*configs(), smooth_normals=smooth)
        out[smooth] = nearest.hits_shaded(prep, cfg, torch.tensor(LIGHT), cs,
                                          cfg.cull_maxv)
    assert torch.equal(out[False][1], out[True][1])
    sphere = out[True][2] == 0
    d = (out[True][3] - out[False][3]).abs().amax(-1)[sphere]
    assert sphere.sum() > 1000 and (d > 1e-3).float().mean() > 0.5


# frames: (scene, shading fields, port and JAX KernelConfig fields, the
# port's branch, the steps of JAX tiled_t it runs)
FRAMES = {
    "textured": ("textured", {}, {}, "fused",
                 ("hits_shaded", "anyhit_from_t")),
    "textured_no_fused_shadow": ("textured", {}, dict(fused_shadow=False),
                                 "legacy", ("hits_shaded", "anyhit")),
    "textured_single_sided": ("textured", dict(double_sided_diffuse=False,
                                               specular_nl_factor=False), {},
                              "fused", ("hits_shaded", "anyhit_from_t")),
    "smooth": ("smooth", dict(smooth_normals=True), {}, "fused",
               ("hits_shaded", "anyhit_from_t")),
    "smooth_no_fused_shadow": ("smooth", dict(smooth_normals=True),
                               dict(fused_shadow=False), "legacy",
                               ("hits_shaded", "anyhit")),
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_frame_matches_jax(scenes, frame, monkeypatch):
    kind, shading, kc, branch, steps = FRAMES[frame]
    prep, jprep = scenes[kind]
    cfg, jcfg = _shading(*configs(), **shading)
    cfg = cfg.replace(kernel=sr.KernelConfig(**kc))
    jcfg = jcfg.replace(kernel=dataclasses.replace(jcfg.kernel, **kc))
    assert tiled.frame_branch(prep, cfg, TILE) == branch
    jimg = jax_frame(jprep, jcfg, VIEW, monkeypatch, spied=SPIED,
                     expect=steps)
    n0 = table.calls()
    img = render(prep, cfg, LIGHT, view_matrix=VIEW).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert table.calls() == n0
    diff = np.abs(img.astype(int) - jimg.astype(int))
    print(f"frame {frame}: {int((diff > 0).any(-1).sum())} pixels differ, "
          f"max {int(diff.max())}")
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    bg = (img == np.array(cfg.background, np.uint8)).all(-1)
    assert 0.2 < (~bg).mean() < 0.95


@pytest.mark.parametrize("textured, smooth", [(True, False), (False, True),
                                              (True, True)])
def test_frame_branch_of_one_sample_frames(textured, smooth):
    """Textured or smooth (not both) S = 1: fused, legacy with the fused
    shadow off or over 131,072 triangles (32-pixel tiles); both: gather.
    None raises."""
    build = P.textured_on_ground if textured else P.smooth_on_ground
    cfg, _ = configs()
    prep = prepare(build(sr.SceneManager(), 1).build(), cfg, device="cpu")
    assert prep.scene.has_textures == textured
    cfg = cfg.replace(shading=sr.ShadingConfig(smooth_normals=smooth))
    dense = dataclasses.replace(prep, block_min=torch.zeros((4200, 3)),
                                block_max=torch.zeros((4200, 3)))
    no_fs = cfg.replace(kernel=sr.KernelConfig(fused_shadow=False))
    got = (tiled.frame_branch(prep, cfg, TILE),
           tiled.frame_branch(prep, no_fs, TILE),
           tiled.frame_branch(dense, cfg, 32 * 32))
    want = ("gather",) * 3 if textured and smooth else \
        ("fused", "legacy", "legacy")
    assert got == want


def test_procedural_scenes():
    """smooth_on_ground: unit vertex normals, no texture;
    dense_textured_on_ground: a textured second sphere and ground."""
    sm = P.smooth_on_ground(sr.SceneManager(), 1).build()
    n = sm.vnormals
    assert not sm.has_textures
    torch.testing.assert_close(n.norm(dim=-1), torch.ones(n.shape[:2]))
    dense = P.dense_textured_on_ground(sr.SceneManager(), 2)
    uvs = dense.objects["sphere2"].mesh.uvs
    assert dense.objects["sphere2"].mesh.tri_tex.min() == 0
    assert 0.0 <= uvs.min() and uvs.max() <= 2.0 * P.CHECKER
    scene = dense.build()
    assert scene.has_textures and int((scene.tri_tex >= 0).sum()) == 320 + 12


TETRA = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.3, 0.3, 1]], float)


def _write_obj(path, verts, faces, uvs=None, mtl=None):
    """A small OBJ file (faces 1-based; with ``uvs`` per vertex and
    ``mtl`` = (library, material) a textured one)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [f"mtllib {mtl[0]}", f"usemtl {mtl[1]}"] if mtl else []
    lines += [f"v {x} {y} {z}" for x, y, z in verts]
    if uvs is not None:
        lines += [f"vt {u} {v}" for u, v in uvs]
        lines += ["f " + " ".join(f"{i}/{i}" for i in f) for f in faces]
    else:
        lines += ["f " + " ".join(str(i) for i in f) for f in faces]
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Stand-in assets under the layout ``complex_scene`` reads: a unit
    cube, a tetrahedron for the bunny, a textured tetrahedron tree (a
    checker PNG through an MTL), and no cat (the reference's soft
    failure)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("assets")
    cube = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                     for z in (-1, 1)], float)
    quads = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7),
             (1, 3, 7, 5), (2, 6, 8, 4)]
    _write_obj(root / "obj" / "cube.obj", cube,
               [f for a, b, c, d in quads for f in ((a, b, c), (a, c, d))])
    tet_faces = [(1, 3, 2), (1, 2, 4), (2, 3, 4), (3, 1, 4)]
    _write_obj(root / "obj" / "stanford-bunny.obj", TETRA * 0.2, tet_faces)
    tree = root / "obj" / "tree"
    _write_obj(tree / "tree.obj", TETRA * 400.0, tet_faces,
               uvs=[(0.1, 0.1), (0.9, 0.2), (0.2, 0.8), (0.7, 0.9)],
               mtl=("tree.mtl", "leaf"))
    (tree / "tree.mtl").write_text("newmtl leaf\nmap_Kd leaf.png\n")
    ij = np.arange(16) // 4
    img = np.where(((ij[:, None] + ij[None, :]) % 2 == 1)[..., None],
                   np.array([30, 140, 30]), np.array([200, 170, 90]))
    Image.fromarray(img.astype(np.uint8)).save(tree / "leaf.png")
    return str(root)


@pytest.mark.parametrize("bake_view", [False, True])
def test_complex_scene_matches_jax(assets, bake_view):
    """``catalog.complex_scene`` builds the same scene, view and light as
    JAX's on the same assets."""
    sm, view, light = catalog.complex_scene(assets, 30.0, bake_view)
    jsm, jview, jlight = jcatalog.complex_scene(assets, 30.0, bake_view)
    assert (view is None) == (jview is None) == bake_view
    if view is not None:
        np.testing.assert_array_equal(view, jview)
    np.testing.assert_array_equal(light, jlight)
    scene, jscene = sm.build(), jsm.build()
    assert scene.has_textures and jscene.has_textures
    for name in ("verts", "uvs", "tri_obj", "tri_tex", "tex_data",
                 "obj_color"):
        np.testing.assert_array_equal(getattr(scene, name).numpy(),
                                      np.asarray(getattr(jscene, name)))


def test_complex_frame_matches_jax(assets, monkeypatch):
    """The complex scene's one-sample frame on its turntable camera, world
    space: the port's fused frame in K1's textured mode against JAX's
    (``hits_shaded``, ``anyhit_from_t``), at JAX's image bars."""
    jsm, view, light = jcatalog.complex_scene(assets, 20.0, False)
    np.testing.assert_array_equal(light, LIGHT)
    cfg, jcfg = configs()
    jprep = jprepared.prepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep), has_textures=True,
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    assert tiled.frame_branch(prep, cfg, TILE) == "fused"
    jimg = jax_frame(jprep, jcfg, view, monkeypatch, spied=SPIED,
                     expect=("hits_shaded", "anyhit_from_t"))
    img = render(prep, cfg, LIGHT, view_matrix=view).numpy()
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    comp = nearest.hits_shaded(prep, cfg, torch.tensor(LIGHT),
                               (torch.from_numpy(view), FOCAL, WIDTH, HEIGHT,
                                TILE_PX), cfg.cull_maxv)[3]
    assert (comp[:, 5] >= 0).sum() > 200         # the textured tree is hit


@pytest.mark.parametrize("angle", [0.0, 10.0, 130.0, 350.0])
def test_orbit_view_matches_jax(angle):
    """The turntable camera of the complex scene (bench.py::run_complex)."""
    cfg, jcfg = sr.AnimationConfig(), jconfig.AnimationConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    args = (angle, cfg.orbit_radius, cfg.camera_y, cfg.pitch_deg,
            cfg.yaw_offset_deg)
    np.testing.assert_array_equal(catalog.orbit_view(*args),
                                  jcatalog.orbit_view(*args))
    assert set(catalog.CATALOG) == set(jcatalog.CATALOG)
