"""PyTorch port, the probes (``simple_raytracer_tpu_torch/probes``): the
plain versions of the Hopper counterparts of the JAX package's Pallas probes
under ``scripts/`` against JAX.

* fixed_probe_kernel's variants (probes/fixed.py) on a 256x128 frame of
  identity view in 64- and 32-pixel tiles, against the rows of JAX
  ``tiled_t._build_feats(ray_tile_od(o, d), "f32")`` for the rays of JAX
  ``primary_rays_tiled`` (the tile-major stream the port's tiles read),
  summed in the same order, and JAX ``untile_image`` for the image-order
  stores.  Exact: with the identity view the rebuilt rays are (i, j, focal)
  to the bit, as JAX's own tests/test_tiled_t.py pins for its iota path.
* The grid probes against ``fixed_probe3.py``'s row formula in numpy.
* attr_gather against ``scripts/attr_probe.py::attr_fetch`` (loaded by
  path, interpret mode on the CPU), exactly; attr_window against a numpy
  restatement of ``attr_fetch_probe.py``'s one-hot contraction (its kernel
  lives inside ``main()``), exactly.
* The ``win`` point: K1's plain version on each tile's first plan entry
  against JAX ``ops/intersect.py::moller_trumbore`` over that window's
  triangles, at the JAX package's bars (t rtol 1e-4 / atol 1e-6, idx equal
  on >= 99.9% of rays).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import nearest, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops.camera import tile_ray_dirs
from simple_raytracer_tpu_torch.probes import attr, fixed
from simple_raytracer_tpu_torch.scene import procedural as P

from simple_raytracer_tpu.kernels import tiled_t
from simple_raytracer_tpu.ops.camera import primary_rays_tiled as jrays
from simple_raytracer_tpu.ops.camera import untile_image as juntile
from simple_raytracer_tpu.ops.intersect import moller_trumbore

W, H, FOCAL = 256, 128, 400.0
TPXS = (64, 32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=TPXS)
def frame(request):
    """(tile_px, the port's probe inputs, the JAX rows F10 [n, 10, tile]
    of the tile-major stream, the JAX o x row of OD + 1 [n, tile])."""
    tpx = request.param
    tile = tpx * tpx
    o, d, _, _ = jrays(W, H, tpx, FOCAL)
    OD, n, _ = tiled_t.ray_tile_od(o.reshape(-1, 3), d.reshape(-1, 3), tile)
    rows = np.stack([np.asarray(tiled_t._build_feats(OD[i], "f32", 6,
                                                     tile))[:10]
                     for i in range(n)])
    inputs = fixed.frame_inputs(W, H, tpx, FOCAL)
    assert np.array_equal(inputs["o"].numpy().reshape(-1, 3), np.asarray(o))
    assert np.array_equal(inputs["d"].numpy().reshape(-1, 3), np.asarray(d))
    return tpx, inputs, rows, np.asarray(OD[:, 0] + 1.0)


def _summed(rows):
    t = np.zeros_like(rows[:, 0])
    for k in range(rows.shape[1]):
        t = t + rows[:, k]
    return t


def _image(flat, tpx):
    return np.asarray(juntile(jnp.asarray(flat.reshape(-1)), W, H, tpx,
                              -(-W // tpx), -(-H // tpx)))


def _probe(name, inputs):
    t, idx = table.run("fixed", fixed.PROBES[name][0], **inputs)
    return t.numpy(), None if idx is None else idx.numpy()


@pytest.mark.parametrize("name", ["io", "base", "feat", "feat3", "noin"])
def test_tile_major_probes_match_jax_rows(frame, name):
    tpx, inputs, rows, io = frame
    want = {"io": io, "base": io, "feat": _summed(rows),
            "feat3": _summed(rows[:, :3]), "noin": _summed(rows[:, 0::3])}
    t, idx = _probe(name, inputs)
    assert idx is None and t.shape == want[name].shape
    assert np.array_equal(t, want[name])


def test_acc_keeps_the_least_row_with_its_lowest_id(frame):
    """acc: K1's best-hit keep over the ten rows, against jnp min and the
    lowest-id argmin."""
    _, inputs, rows, _ = frame
    t, idx = _probe("acc", inputs)
    F = jnp.asarray(rows)
    m = jnp.min(F, axis=1)
    first = jnp.argmin(jnp.where(F == m[:, None], 0, 1), axis=1)
    assert np.array_equal(t, np.asarray(m))
    assert np.array_equal(idx, np.asarray(first))
    assert len(np.unique(idx)) > 1


@pytest.mark.parametrize("name", ["noout", "none", "none2", "feat_i"])
def test_image_order_probes_match_jax_untile(frame, name):
    tpx, inputs, rows, io = frame
    n, tile = rows.shape[0], tpx * tpx
    want = {"noout": io, "none": rows[:, 0] + rows[:, 9],
            "none2": rows[:, 0] + rows[:, 9], "feat_i": _summed(rows)}
    t, idx = _probe(name, inputs)
    assert t.shape == (H, W)
    assert np.array_equal(t, _image(want[name], tpx))
    if name in ("none2", "feat_i"):
        tiles = np.repeat(np.arange(n, dtype=np.int32), tile)
        assert np.array_equal(idx, _image(tiles, tpx))
    else:
        assert idx is None


@pytest.mark.parametrize("name", ["empty", "write", "grid1", "grid1f"])
def test_grid_probes_match_the_row_formula(frame, name):
    """``fixed_probe3.py``'s rows: row(i) = lane + a + i (only row 0 for
    empty); grid1f the sum of F10 of the rebuilt rays, restated in numpy
    f32 from the pixel (i, j, focal) with the origin 0."""
    tpx, inputs, rows, _ = frame
    n, tile = rows.shape[0], tpx * tpx
    a = np.float32(3e-6)
    t, idx = _probe(name, {**inputs, "a": float(a)})
    lane = np.arange(tile, dtype=np.float32)
    want = (lane[None, :] + a) + np.arange(n, dtype=np.float32)[:, None]
    if name == "grid1f":
        ti, li = np.divmod(np.arange(n * tile), tile)
        px = (ti % -(-W // tpx)) * tpx + li % tpx - W // 2
        py = (ti // -(-W // tpx)) * tpx + li // tpx - H // 2
        z = np.float32(0.0)
        F = [px.astype(np.float32), py.astype(np.float32),
             np.full(n * tile, FOCAL, np.float32)] + [z] * 6 + [
            np.float32(1.0)]
        want = np.zeros(n * tile, np.float32)
        for r in F:
            want = want + r
        want = want.reshape(n, tile)
        assert np.array_equal(want, _summed(rows))
    if name == "empty":
        want = want[:1]
    assert idx is None and np.array_equal(t, want)


def test_unknown_variant_raises():
    inputs = fixed.frame_inputs(64, 64, 32, FOCAL)
    with pytest.raises(ValueError, match="unknown probe variant"):
        table.run("fixed", "win", **inputs)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_attr_gather_matches_attr_probe():
    """attr_gather against the TPU probe itself in interpret mode, on the
    script's own draws for n = 4 (its main(): A, then bid)."""
    script = _script("attr_probe")
    n = 4
    rng = np.random.default_rng(0)
    A = rng.standard_normal((script.AF, script.T)).astype(np.float32)
    bid = rng.integers(-1, script.T, size=(n, script.TILE_R)).astype(np.int32)
    tbid, at = attr.gather_inputs(n)
    assert np.array_equal(tbid.numpy(), bid) and np.array_equal(at.numpy(),
                                                                A.T)
    bid[0, :8] = -1                      # misses, whatever the draws
    want = np.asarray(script.attr_fetch(jnp.asarray(bid), jnp.asarray(A)))
    got = table.run("attr_gather", torch.from_numpy(bid), at)
    assert got.shape == (n, script.TILE_R, script.AF)
    assert np.array_equal(got.numpy(), want)
    assert not got.numpy()[bid < 0].any() and got.numpy()[bid >= 0].any()


def test_attr_window_matches_the_one_hot_contraction():
    """attr_window against ``attr_fetch_probe.py:57-73`` restated in numpy:
    per window a [256, R] one-hot of (lane carries a triangle, and it is
    the ray's winner), contracted with the window's columns of A."""
    tiles, nw, R, nb = 4, 10, 256, 64
    starts, bid, at = attr.window_inputs(tiles, nw, R, nb)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((attr.AF, nb * attr.RPB)).astype(np.float32)
    assert np.array_equal(at.float().numpy().T,
                          torch.from_numpy(A).to(torch.bfloat16).float()
                          .numpy())
    Af = at.float().numpy().T                     # [16, nb * 128]
    lane = np.arange(attr.WL)[:, None]
    kind = (lane % attr.RPB) // attr.BS
    row = lane % attr.BS
    want = np.zeros((tiles, attr.AF, R), np.float32)
    for i in range(tiles):
        b = bid.numpy()[i][None, :]
        for k in range(nw):
            s = int(starts[i, k])
            tri0 = (s * attr.WB + lane // attr.RPB) * attr.BS + row
            oh = np.where((kind == 0) & (tri0 == b), 1.0, 0.0).astype(
                np.float32)
            want[i] = want[i] + Af[:, s * attr.WL:(s + 1) * attr.WL] @ oh
    got = table.run("attr_window", starts, bid, at)
    assert got.shape == (tiles, attr.AF, R)
    assert np.array_equal(got.numpy(), want)
    assert (np.abs(want).sum(axis=1) > 0).mean() > 0.1


@pytest.fixture(scope="module")
def k1_frame():
    """K1's arguments on a small flat frame in 32-pixel tiles (CPU)."""
    cfg = sr.default_config().replace(
        mode="tiled", tile_px=32, bvh=sr.BVHConfig(split="sah"),
        camera=sr.CameraConfig(width=W, height=H, focal=FOCAL))
    prep = prepare(P.sphere_on_ground(sr.SceneManager(), 2).build(), cfg,
                   device="cpu")
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    args = nearest.shaded_args(prep, cfg, torch.tensor(P.BENCH_LIGHT),
                               (None, FOCAL, W, H, 32), maxv)
    return args, fixed.k1_points(args)


@pytest.mark.parametrize("point", list(fixed.K1_POINTS))
def test_k1_points_match_jax_mt_over_the_first_window(k1_frame, point):
    """The win point (K1 on each tile's first entry) against JAX's
    Möller–Trumbore over that window's triangles; k1_empty misses every
    ray."""
    args, points = k1_frame
    plan, tri, wt = points[point][0], args[1].numpy(), args[6]
    t, idx, obj, _rgb, _b = nearest.tiled_nearest_shaded_plain(
        *points[point])
    n, tile = t.shape
    full = args[0]
    cnt = torch.where(full[:, 3] == 1, full[:, 2], full[:, 1])
    w = torch.where(full[:, 3] == 1, full[:, 8] & 0xFFFF, full[:, 0])
    w = torch.where(cnt > 0, w, 0)          # empty tiles: any window
    assert torch.equal(torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1]),
                       cnt.clamp(max=fixed.K1_POINTS[point]))
    want_t = np.full((n, tile), np.inf, np.float32)
    want_i = np.full((n, tile), -1, np.int64)
    if point == "win":
        dx, dy, dz = (x.numpy() for x in tile_ray_dirs(
            args[4], full[:, 4], full[:, 5], 32))
        d = np.stack([dx, dy, dz], -1)[:, :, None, :]          # [n, T, 1, 3]
        ids = (w.numpy()[:, None] * wt + np.arange(wt))         # [n, wt]
        g = tri[ids]
        v0, e1, e2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
        verts = np.stack([v0, v0 + e1, v0 + e2], -2)[:, None]  # [n,1,wt,3,3]
        tt = np.asarray(moller_trumbore(jnp.zeros(3), jnp.asarray(d),
                                        jnp.asarray(verts), 1e-12))
        tt = np.where((cnt.numpy() > 0)[:, None, None], tt, np.inf)
        arg = tt.argmin(-1)
        want_t = np.take_along_axis(tt, arg[..., None], -1)[..., 0]
        want_i = np.where(np.isfinite(want_t),
                          np.take_along_axis(ids[:, None, :].repeat(
                              tile, 1), arg[..., None], -1)[..., 0], -1)
        assert np.isfinite(want_t).mean() > 0.05
    t, idx = t.numpy(), idx.numpy()
    assert np.array_equal(np.isfinite(t), np.isfinite(want_t))
    both = np.isfinite(t)
    np.testing.assert_allclose(t[both], want_t[both], rtol=1e-4, atol=1e-6)
    assert (idx == want_i).mean() >= 0.999
    assert ((obj >= 0).numpy() == both).all()


@pytest.mark.parametrize("module", [fixed, attr])
def test_mains_refuse_a_host_without_a_card(module):
    """The probes time a card: their entry points raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main([])
