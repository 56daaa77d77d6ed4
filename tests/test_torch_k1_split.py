"""PyTorch port, K1's work items: the plain models of its decomposition.

K1 walks each tile as work items (tile, ray slice, window span): slices
of ``nearest.K1_SLICE`` consecutive lanes, each breaking on its own rays,
range rows in spans of ``nearest.K1_RANGE_SPAN`` windows and lists in spans
of ``nearest.K1_LIST_SPAN`` entries, merged per ray by the minimum of a
64-bit key (t's bits over the id).  These tests hold the plain models of
that decomposition on the CPU:

* ``walk_plain(slices=S, list_span=L)`` (K1's and a finer cut) equals the
  whole walk bit for bit (t, idx and each lane's needed tests), and both
  match the JAX package's tiled walk
  (``tiled_t.hits_shaded``, its Pallas kernel in interpret mode) and its
  brute force (``renderer.brute_force_hits``) at the package's own bars
  (tests/test_tiled.py:74-94: t rtol 1e-4 / atol 1e-6, idx equal on >=
  99.9% of rays), on the flat, textured and smooth-normal parity scenes at
  64- and 32-pixel tiles; the fetch mode's rows are the winners' rows; a
  lying bound holds a slice as it holds the tile, but not across spans;
* the key helpers (``hit_keys``, ``merge_keys``, ``decode_keys``): a range
  row walked as spans and merged in random order equals the whole walk,
  ties go to the lowest id, -0.0 packs as +0.0, and infinite t and misses
  decode as misses;
* the schedule's plain version ``work_rows``: every (tile, span) once,
  longest walk first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import nearest
from simple_raytracer_tpu_torch.ops.camera import tile_ray_dirs
from simple_raytracer_tpu_torch.scene import procedural as P

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.accel import prepared as jprepared
from simple_raytracer_tpu.kernels import tiled_t
from simple_raytracer_tpu.ops.camera import primary_rays_tiled
from simple_raytracer_tpu.render.renderer import brute_force_hits

from _torch_cases import k1_stress, two_windows
from _torch_parity import (FOCAL, HEIGHT, LIGHT, VIEW, WIDTH, configs,
                           jax_prepared_arrays, managers)

SCENES = {"flat": (P.sphere_on_ground, False),
          "textured": (P.textured_on_ground, False),
          "smooth": (P.smooth_on_ground, True)}
TPX = (64, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain walks here are many small tensor ops; one intra-op thread
    keeps them fast when other test processes load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """For each scene and tile size: K1's port arguments (the parity view)
    and JAX's tiled walk and brute force on the same rays (t, idx, each
    [n, tile] in tile-major order)."""
    out = {}
    for kind, (build, smooth) in SCENES.items():
        _, jsm = managers(build=build)
        cfg, jcfg = configs()
        cfg = cfg.replace(shading=sr.ShadingConfig(smooth_normals=smooth))
        jcfg = jcfg.replace(shading=jconfig.ShadingConfig(
            smooth_normals=smooth))
        jprep = jprepared.prepare(jsm.build(), jcfg)
        prep = from_jax_prepared(jax_prepared_arrays(jprep),
                                 has_textures=kind == "textured",
                                 num_triangles=int(jprep.num_triangles),
                                 device="cpu")
        for tpx in TPX:
            cs = (torch.from_numpy(VIEW), FOCAL, WIDTH, HEIGHT, tpx)
            args = nearest.shaded_args(prep, cfg.replace(tile_px=tpx),
                                       torch.tensor(LIGHT), cs,
                                       cfg.cull_maxv)
            n, tile = args[0].shape[0], tpx * tpx
            jcs = (jnp.asarray(VIEW), FOCAL, WIDTH, HEIGHT, tpx)
            dummy = jnp.zeros((n * tile, 3), jnp.float32)
            jt, ji, *_ = tiled_t.hits_shaded(
                jprep, dummy, dummy, tile, cfg.mt_eps, jnp.asarray(LIGHT),
                jnp.asarray(cfg.light.color, jnp.float32), cfg.cull_maxv,
                jcs, True, True, want_bounds=1)
            o, d, _, _ = primary_rays_tiled(WIDTH, HEIGHT, tpx, FOCAL, False,
                                            view_matrix=jnp.asarray(VIEW))
            bt, bi = brute_force_hits(jprep.scene, o.reshape(-1, 3),
                                      d.reshape(-1, 3))
            out[kind, tpx] = (args, [np.asarray(x).reshape(n, tile)
                                     for x in (jt, ji, bt, bi)])
    return out


def _walk(args, slices: int, list_span: int = 0):
    plan, tri, cam, tpx, wt, eps = (args[0], args[1], args[4], args[5],
                                    args[6], args[7])
    d = tile_ray_dirs(cam, plan[:, 4], plan[:, 5], tpx)
    t, idx = nearest.walk_plain(plan, tri, (cam[9], cam[10], cam[11]), d,
                                wt, eps, slices=slices, list_span=list_span)
    return (t, idx, nearest.walk_plain.lane_pairs,
            nearest.walk_plain.staged)


@pytest.mark.parametrize("tpx", TPX)
@pytest.mark.parametrize("kind", list(SCENES))
def test_sliced_walk_equals_whole_walk_and_jax(frames, kind, tpx):
    args, (jt, ji, bt, bi) = frames[kind, tpx]
    tile = tpx * tpx
    assert nearest.k1_slices(tile) == tile // nearest.K1_SLICE
    t1, i1, lp1, st1 = _walk(args, 1)
    assert int(args[0][:, 2].max()) > 4              # lists of many spans
    ts, is_, lps, sts = _walk(args, tile // 32, 4)
    assert torch.equal(ts, t1) and torch.equal(is_, i1)
    # the bound's record is the whole walk's
    assert torch.equal(lps, lp1) and torch.equal(sts, st1)
    t, idx = t1.numpy(), i1.numpy()
    for rt, ri in ((jt, ji), (bt, bi)):
        h, hr = np.isfinite(t), np.isfinite(rt)
        assert h.sum() > 4000 and (h == hr).mean() > 0.999
        both = h & hr
        np.testing.assert_allclose(t[both], rt[both], rtol=1e-4, atol=1e-6)
        assert (idx == ri).mean() > 0.999
    # the plain version walks in K1's slices and list spans: the same hits
    # and record, and the fetch mode's rows are the winners' rows
    ft, fi, fa = nearest.tiled_nearest_attrs_plain(
        args[0], args[1], args[2], args[4], tpx, args[6], args[7])
    assert torch.equal(ft, t1) and torch.equal(fi, i1)
    assert torch.equal(nearest.walk_plain.lane_pairs, lp1)
    hit = i1.reshape(-1) >= 0
    assert torch.equal(fa[hit], args[2][i1.reshape(-1)[hit].long()])


@pytest.mark.parametrize("tpx", TPX)
def test_sliced_walk_of_every_row_kind(frames, tpx):
    """The flat frame's plan with a range row longer than a span, a deep
    list, empty rows and every hit tied with a copy (_torch_cases.
    k1_stress): the sliced walk equals the whole one, and ties keep the
    lower id."""
    args = frames["flat", tpx][0]
    plan, tri, _attr, _ = k1_stress(args[0], args[1], args[2], None,
                                    args[6])
    stress = (plan, tri) + tuple(args[2:])
    t1, i1, lp1, _ = _walk(stress, 1)
    for span in (nearest.K1_LIST_SPAN, 8):
        ts, is_, lps, _ = _walk(stress, nearest.k1_slices(tpx * tpx), span)
        assert torch.equal(ts, t1) and torch.equal(is_, i1)
        assert torch.equal(lps, lp1)
    hit = torch.isfinite(t1)
    assert hit[0::4].sum() > 100 and not bool(hit[2::4].any())
    assert bool((i1[hit] < tri.shape[0] // 2).all())


@pytest.mark.parametrize("slices, list_span, want",
                         [(1, 0, 0), (8, 0, 0), (8, nearest.K1_LIST_SPAN, 0),
                          (8, 1, 64)])
def test_sliced_walk_trusts_the_entry_bound(slices, list_span, want):
    """A lying bound stops every slice after the first window, as it stops
    the whole tile; a list split into spans of one entry walks the second
    window too, from its own start, and finds the nearer hit.  The kernel
    does the same (tests/test_torch_cuda.py)."""
    (plan, tri, _attr, _mat, cam), (tpx, wt, eps) = two_windows(1.0)
    d = tile_ray_dirs(cam, plan[:, 4], plan[:, 5], tpx)
    t, idx = nearest.walk_plain(plan, tri, (cam[9], cam[10], cam[11]), d,
                                wt, eps, slices=slices, list_span=list_span)
    assert (idx == want).all()


def test_keys_merge_spans_in_any_order(frames):
    """A range row over all of the flat frame's windows, walked as spans of
    K1_RANGE_SPAN windows whose keys merge in random orders, equals the
    walk of the whole range."""
    args = frames["flat", 64][0]
    plan, tri, cam, tpx, wt, eps = (args[0][:2].clone(), args[1], args[4],
                                    args[5], args[6], args[7])
    nw = tri.shape[0] // wt
    plan[:, 0], plan[:, 1], plan[:, 3] = 0, nw, 0
    d = tile_ray_dirs(cam, plan[:, 4], plan[:, 5], tpx)
    o = (cam[9], cam[10], cam[11])
    whole_t, whole_i = nearest.walk_plain(plan, tri, o, d, wt, eps)
    span = nearest.K1_RANGE_SPAN
    keys = []
    for k0 in range(0, nw, span):
        p = plan.clone()
        p[:, 0], p[:, 1] = k0, min(span, nw - k0)
        keys.append(nearest.hit_keys(*nearest.walk_plain(p, tri, o, d, wt,
                                                         eps)))
    assert len(keys) > 1
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        acc = torch.full_like(keys[0], nearest.MISS_KEY)
        for j in torch.randperm(len(keys), generator=gen).tolist():
            acc = nearest.merge_keys(acc, keys[j])
        t, idx = nearest.decode_keys(acc)
        assert torch.equal(t, whole_t) and torch.equal(idx, whole_i)
    assert bool(torch.isfinite(whole_t).any())


def test_keys_order_ties_signs_and_misses():
    t = torch.tensor([0.5, 0.5, -0.0, 0.0, float("inf"), 0.25, 2.0])
    idx = torch.tensor([7, 3, 9, 4, 1, -1, 2], dtype=torch.int32)
    k = nearest.hit_keys(t, idx)
    # ties in t go to the lower id; -0.0 packs as +0.0, below every t > 0
    assert int(nearest.merge_keys(k[0:1], k[1:2])) == int(k[1])
    assert int(k[2]) == 9 and int(k[3]) == 4
    assert int(nearest.merge_keys(k[2:3], k[3:4])) == int(k[3])
    assert bool((k[2:4] < k[0]).all())
    # a miss is the all-ones key and loses to every hit, inf t included
    assert int(k[5]) == nearest.MISS_KEY
    for j in (0, 4, 6):
        assert int(nearest.merge_keys(k[5:6], k[j:j + 1])) == int(k[j])
        assert int(nearest.merge_keys(k[j:j + 1], k[5:6])) == int(k[j])
    dt, di = nearest.decode_keys(k)
    assert dt.tolist()[:4] == [0.5, 0.5, 0.0, 0.0]
    assert di.tolist() == [7, 3, 9, 4, -1, -1, 2]
    assert torch.isinf(dt[4]) and torch.isinf(dt[5]) and dt[6] == 2.0
    assert str(dt[2].item()) == "0.0"                 # +0.0, not -0.0


@pytest.mark.parametrize("tpx", TPX)
def test_work_rows_each_once_longest_first(frames, tpx):
    """Every (tile, span) of the stressed plan appears once: a list row as
    its spans of entries, a range row as its spans of windows; the walk
    lengths never grow along the schedule; each row is k1_slices items."""
    args = frames["flat", tpx][0]
    plan, tri, *_ = k1_stress(args[0], args[1], args[2], None, args[6])
    nw = tri.shape[0] // args[6]
    for list_span in (nearest.K1_LIST_SPAN, 8):
        rows, length = nearest.work_rows(plan, nw, list_span=list_span)
        want = []
        for t in range(plan.shape[0]):
            lst = int(plan[t, 3]) == 1
            cnt = int(plan[t, 2]) if lst else min(
                int(plan[t, 1]), max(0, nw - int(plan[t, 0])))
            span = list_span if lst else nearest.K1_RANGE_SPAN
            want += [(t, s, min(span, cnt - s * span))
                     for s in range(-(-cnt // span))]
        got = [(int(a), int(b), int(c)) for (a, b), c in zip(rows, length)]
        assert sorted(got) == sorted(want) and len(got) == len(set(got))
        assert all(a[2] >= b[2] for a, b in zip(got, got[1:]))
        assert any(s > 0 and int(plan[t, 3]) == 0 for t, s, _ in got)
        long_lists = bool(((plan[:, 3] == 1) & (plan[:, 2] > list_span))
                          .any())
        assert any(s > 0 and int(plan[t, 3]) == 1 for t, s, _ in got) \
            == long_lists
        assert long_lists or list_span != 8
        items = rows.shape[0] * nearest.k1_slices(tpx * tpx)
        assert items == len(want) * max(1, tpx * tpx // nearest.K1_SLICE)
