"""PyTorch port, kernel 1: the plain version of the nearest-hit kernel vs
the JAX package's fused nearest kernel (``tiled_t.hits_shaded`` with
bounds, its Pallas kernel in interpret mode).

Both packages get the same padded, BVH-ordered triangles
(``from_jax_prepared``), so triangle ids mean the same thing.  Tolerances
are the JAX package's own (tests/test_tiled.py:74-78): t rtol 1e-4 /
atol 1e-6, idx equal on >= 99.9% of rays; shading and bounds to float
rounding (the TPU kernel contracts a Gram matrix where the port runs the
cross-product Möller–Trumbore, so the hit points differ in the last bits).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import nearest, table

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled_t

from _torch_cases import two_windows
from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_prepared_arrays, managers)

VIEWS = {"identity": None, "moved": VIEW}


@pytest.fixture(scope="module")
def results():
    """JAX and port nearest passes for each view, computed once."""
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    out = {}
    for name, vm in VIEWS.items():
        jcs = (None if vm is None else jnp.asarray(vm), FOCAL, WIDTH, HEIGHT,
               TILE_PX)
        R = (WIDTH // TILE_PX) * (HEIGHT // TILE_PX) * TILE_PX * TILE_PX
        dummy = jnp.zeros((R, 3), jnp.float32)     # rays come from cam_spec
        jt, ji, jo, jrgb, jb = tiled_t.hits_shaded(
            jprep, dummy, dummy, TILE_PX * TILE_PX, cfg.mt_eps,
            jnp.asarray(LIGHT), jnp.asarray(cfg.light.color, jnp.float32),
            cfg.cull_maxv, jcs, True, True, want_bounds=1)
        cs = (None if vm is None else torch.from_numpy(vm), FOCAL, WIDTH,
              HEIGHT, TILE_PX)
        ours = nearest.hits_shaded(prep, cfg, torch.tensor(LIGHT), cs,
                                   cfg.cull_maxv)
        out[name] = ([np.asarray(x) for x in (jt, ji, jo, jrgb, jb)],
                     [x.numpy() for x in ours])
    return out


@pytest.mark.parametrize("view", list(VIEWS))
def test_nearest_hits_match_jax(results, view):
    (jt, ji, _, _, _), (t, idx, _, _, _) = results[view]
    hj, ho = np.isfinite(jt), np.isfinite(t)
    assert hj.sum() > 4000
    assert (hj == ho).mean() > 0.999
    both = hj & ho
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)
    assert (idx == ji).mean() > 0.999
    assert (idx[~ho] == -1).all()


@pytest.mark.parametrize("view", list(VIEWS))
def test_nearest_shading_matches_jax(results, view):
    (jt, ji, jo, jrgb, _), (t, idx, obj, rgb, _) = results[view]
    same = (idx == ji) & np.isfinite(t)
    assert same.sum() > 4000
    np.testing.assert_array_equal(obj[same], jo[same])
    np.testing.assert_allclose(rgb[same], jrgb[same], rtol=1e-4, atol=1e-5)
    assert set(np.unique(obj[same])) == {0, 1}       # sphere and ground
    assert (obj[~np.isfinite(t)] == -1).all()
    assert (rgb[~np.isfinite(t)] == 0).all()


@pytest.mark.parametrize("view", list(VIEWS))
def test_nearest_bounds_match_jax(results, view):
    (*_, jb), (*_, b) = results[view]
    assert b.shape == jb.shape == (4, 15)
    np.testing.assert_array_equal(np.isfinite(b), np.isfinite(jb))
    fin = np.isfinite(b)
    np.testing.assert_allclose(b[fin], jb[fin], rtol=1e-4, atol=1e-4)
    assert (b[:, 6] == 1.0).all()                    # every tile sees a hit


@pytest.mark.parametrize("bound", [0.0, 1.0])
def test_plain_walk_trusts_the_entry_bound(bound):
    """The front-to-back break: once every ray's best t (here 10/400) is
    below the next entry's bound, the walk stops.  A bound of 1.0 is a lie
    (window 1 holds a nearer hit at t = 5/400), so the walk keeps window 0's
    hit — proof that it stopped; a bound of 0 lets it find the nearer one."""
    tensors, rest = two_windows(bound)
    t, idx, obj, _, _ = table.run("nearest_shaded", *tensors, *rest)
    want = 0 if bound else 64
    assert (idx == want).all() and (obj == int(want > 0)).all()
    torch.testing.assert_close(t, torch.full_like(t, (10.0 if bound
                                                      else 5.0) / 400.0))
