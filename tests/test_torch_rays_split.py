"""PyTorch port, the walks over explicit rays as work items: the plain
models of their decomposition.

The nearest walk over explicit rays (K1's rays mode, K4, K6:
``nearest.tiled_nearest_rays``, ``tiled_nearest_grouped``,
``paged.tiled_nearest``) and the any-hit walk (K2′, K5, K7:
``anyhit.tiled_anyhit``, ``tiled_anyhit_grouped``, ``paged.tiled_anyhit``)
run on the card as work items (tile, ray slice, span): slices of
``nearest.slice_rays(M, groups)`` lanes inside one sub-group, range rows
in spans of windows and lists in spans of entries (``nearest.rays_spans``),
listed longest first by the schedule K1 shares (``nearest.work_rows``).
These tests hold the plain models of that decomposition on the CPU, on the
parity scene (tests/_torch_parity.py) with plans rewritten to reach every
kind of row (_torch_cases.k1_stress, grouped_stress: a range row longer
than a span, deep lists, empty rows, hits tied with copies):

* the split walks (``walk_plain(slice_rays=, list_span=)`` for the nearest
  walk, ``spans=`` for the any-hit walk, and the wrappers' plain versions)
  equal the whole walks bit for bit: t, idx or found, and each lane's
  needed tests; tiles of 4,096, 1,024, 256 and of 1,000 or 768 rays (a
  last slice cut short); found is the same in any order of the spans;
* the split walks match the JAX package at its own bars (t rtol 1e-4 /
  atol 1e-6, idx equal on >= 99.9%, tests/test_tiled.py:74-94; found
  equal on every lane, or >= 99.99% of the lanes for the paged walk as in
  tests/test_torch_paged.py): ``tiled_t.tiled_nearest_t`` and
  ``tiled_anyhit_t`` in interpret mode, ``tiled.tiled_hits`` and
  ``tiled.anyhit``;
* the schedule lists each (tile, span) once, longest first, with each row
  as many items as its tile has slices;
* a lying entry bound holds within a list span, not across spans.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import anyhit, nearest, paged
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.ops.intersect import xyz
from simple_raytracer_tpu_torch.render import integrator

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled as jtiled
from simple_raytracer_tpu.kernels import tiled_t

from _torch_cases import grouped_stress, k1_stress, two_pages
from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_prepared_arrays, managers)

G = 4
MAXV = 248
TILE = TILE_PX * TILE_PX
S4 = 4
# spans short enough to cut the parity scene's lists and ranges
SPANS = (3, 4)
TILES = 8               # tiles of a split-walk case: each stressed kind twice


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain walks here are many small tensor ops; one intra-op thread
    keeps them fast when other test processes load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    """The parity scene in both packages, the moved view's primary rays,
    their hit points and objects, and S4 light samples."""
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             page_tris=cfg.bvh.page_tris, device="cpu")
    o, d, _, _ = tcam.primary_rays_tiled(WIDTH, HEIGHT, TILE_PX, FOCAL,
                                         view_matrix=torch.from_numpy(VIEW))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t, idx = paged.hits(prep, cfg, o, d, TILE, MAXV, apex=True)
    hit = torch.isfinite(t)
    p = (o + torch.where(hit, t, 0.0)[:, None] * d)[hit]
    so = prep.scene.tri_obj[idx[hit].long()].to(torch.int32)
    lights = integrator.light_sample_positions(LIGHT, S4, 3.0)
    return {"prep": prep, "jprep": jprep, "cfg": cfg, "o": o, "d": d,
            "p": p, "so": so, "lights": lights}


def _shadow(b, m: int):
    """Shadow rays in TILES tiles of ``m`` from hit points spread over the
    image: folded soft shadows, S4 samples x m / S4 points per tile, for
    tiles of 768 or 1,024 rays; else one hard sample per point.  Returns
    (o, d, self_obj), [n, m, 3] and [n, m]."""
    S = S4 if m in (768, 1024) else 1
    ts = m // S
    step = b["p"].shape[0] // (TILES * ts)         # points across the image
    p = b["p"][::step][:TILES * ts].reshape(TILES, 1, ts, 3)
    so = b["so"][::step][:TILES * ts].reshape(TILES, 1, ts)
    nt = TILES
    so = so.expand(nt, S, ts)
    L = (b["lights"] if S > 1 else torch.tensor([LIGHT]))[None, :, None]
    o = p.expand(nt, S, ts, 3)
    return (o.reshape(nt, m, 3).contiguous(),
            (L - o).reshape(nt, m, 3).contiguous(),
            so.reshape(nt, m).contiguous())


def _primary(b, m: int):
    """The primary rays in tiles of ``m`` (padded by repeating the last)."""
    o, d, _ = pl.pad_rays(b["o"], b["d"], m)
    n = o.shape[0] // m
    return o.reshape(n, m, 3), d.reshape(n, m, 3)


def _stress(plan, tri, wt: int, groups: int = 1):
    if groups > 1:
        return grouped_stress(plan, tri, wt, groups)
    p, t, _, _ = k1_stress(plan, tri, tri[:, :4], None, wt)
    return p, t


def _nearest_plan(b, kind: str, m: int):
    """(plan, window triangles, groups) of K1's rays mode ("rays"), K4
    ("grouped") or K6 ("pages") over the primary rays in tiles of m."""
    prep = b["prep"]
    if kind == "pages":
        return (paged.cull(prep, b["cfg"], b["o"], b["d"], m, MAXV,
                           apex=True), prep.page_tris, 1)
    groups = G if kind == "grouped" else 1
    return (pl.cull_rays(prep, b["o"], b["d"], m, MAXV, 2, groups=groups,
                         apex=True), 2 * prep.block_size, groups)


def _anyhit_plan(b, kind: str, o, d, m: int):
    """(plan, window triangles, groups) of K2′ ("rays"), K5 ("grouped") or
    K7 ("pages") over shadow rays o, d in tiles of m."""
    prep = b["prep"]
    o2, d2 = o.reshape(-1, 3), d.reshape(-1, 3)
    if kind == "pages":
        return (paged.cull_occl(prep, b["cfg"], o2, d2, m, MAXV,
                                hourglass=False), prep.page_tris, 1)
    groups = G if kind == "grouped" else 1
    return (pl.cull_occl(prep, o2, d2, m, MAXV, 4, None, hourglass=False,
                         groups=groups), 4 * prep.block_size, groups)


def _whole_nearest(plan, tri, o, d, wt, eps, groups):
    """The whole walk: every tile (sub-group) in one piece, no spans."""
    n, m = o.shape[:2]
    if groups > 1:
        sub, mask = nearest.group_walk_masks(plan, groups)
        t, idx = nearest.walk_plain(
            sub, tri, xyz(o.reshape(n * groups, m // groups, 3)),
            xyz(d.reshape(n * groups, m // groups, 3)), wt, eps,
            walk_mask=mask)
        lp = nearest.walk_plain.lane_pairs.reshape(n, m)
        return t.reshape(n, m), idx.reshape(n, m), lp
    t, idx = nearest.walk_plain(plan, tri, xyz(o), xyz(d), wt, eps)
    return t, idx, nearest.walk_plain.lane_pairs


def _split_nearest(plan, tri, o, d, wt, eps, groups, list_span):
    n, m = o.shape[:2]
    sr = nearest.slice_rays(m, groups)
    if groups > 1:
        sub, mask = nearest.group_walk_masks(plan, groups)
        t, idx = nearest.walk_plain(
            sub, tri, xyz(o.reshape(n * groups, m // groups, 3)),
            xyz(d.reshape(n * groups, m // groups, 3)), wt, eps,
            walk_mask=mask, slice_rays=sr, list_span=list_span)
        lp = nearest.walk_plain.lane_pairs.reshape(n, m)
        return t.reshape(n, m), idx.reshape(n, m), lp
    t, idx = nearest.walk_plain(plan, tri, xyz(o), xyz(d), wt, eps,
                                slice_rays=sr, list_span=list_span)
    return t, idx, nearest.walk_plain.lane_pairs


def _nearest_plain(kind: str):
    return {"rays": nearest.tiled_nearest_rays_plain,
            "pages": paged.tiled_nearest_plain}.get(kind)


@pytest.mark.parametrize("kind, m", [("rays", TILE), ("rays", 1000),
                                     ("grouped", TILE), ("grouped", 768),
                                     ("pages", TILE), ("pages", 1024)])
def test_split_nearest_walk_equals_whole(base, kind, m):
    """K1's rays mode, K4 and K6 on the stressed plans: the walk in the
    kernel's slices with lists in spans of 4 entries, and the wrapper's
    plain version (its own spans), equal the whole walk bit for bit, t,
    idx and the record; ties keep the lower id; empty rows miss."""
    prep, eps = base["prep"], base["cfg"].mt_eps
    o, d = _primary(base, m)
    plan, wt, groups = _nearest_plan(base, kind, m)
    plan, tri = _stress(plan, prep.tri, wt, groups)
    plan, o, d = plan[:TILES], o[:TILES], d[:TILES]
    assert nearest.rays_slices(m, groups) * nearest.slice_rays(m, groups) \
        >= m
    t1, i1, lp1 = _whole_nearest(plan, tri, o, d, wt, eps, groups)
    ts, is_, lps = _split_nearest(plan, tri, o, d, wt, eps, groups,
                                  SPANS[1])
    assert torch.equal(ts, t1) and torch.equal(is_, i1)
    assert torch.equal(lps, lp1)
    if groups > 1:
        pt, pi = nearest.tiled_nearest_grouped_plain(plan, tri, o, d, wt,
                                                     eps, groups)
    else:
        pt, pi = _nearest_plain(kind)(plan, tri, o, d, wt, eps)
    assert torch.equal(pt, t1) and torch.equal(pi, i1)
    assert torch.equal(nearest.walk_plain.lane_pairs, lp1)
    hit = torch.isfinite(t1)
    assert hit[0::4].sum() > 100 and not bool(hit[2::4].any())
    nw = tri.shape[0] // wt
    assert bool((i1[hit] < nw // 2 * wt).all())          # ties: lower id
    # the stress reaches a range row of several spans and lists of several
    cnt = torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1])
    assert int(cnt[0]) > nearest.rays_spans(wt)[0]
    assert int(plan[plan[:, 3] == 1, 2].max()) > SPANS[1]


def _whole_found(plan, tri, bobj, o, d, so, wt, bs, eps, groups,
                 **split):
    """found of the plain any-hit walk, whole or (``split``) in the
    kernel's slices and spans, with its record."""
    n, m = so.shape
    if groups > 1:
        sub, mask = nearest.group_walk_masks(plan, groups)
        gr = m // groups
        f = torch.zeros((n * groups, gr), dtype=torch.bool)
        f = anyhit.walk_plain(sub, tri, bobj, xyz(o.reshape(-1, gr, 3)),
                              xyz(d.reshape(-1, gr, 3)), so.reshape(-1, gr),
                              f, wt, bs, eps, True, walk_mask=mask, **split)
        rec = anyhit.walk_plain.lane_pairs.reshape(n, m)
        return f.reshape(n, m), rec, anyhit.walk_plain.staged
    f = anyhit.walk_plain(plan, tri, bobj, xyz(o), xyz(d), so,
                          torch.zeros((n, m), dtype=torch.bool), wt, bs, eps,
                          True, **split)
    return f, anyhit.walk_plain.lane_pairs, anyhit.walk_plain.staged


@pytest.mark.parametrize("kind, m", [("rays", 1024), ("rays", 256),
                                     ("rays", 1000), ("grouped", 1024),
                                     ("grouped", 768), ("pages", 1024),
                                     ("pages", 256)])
def test_split_anyhit_walk_equals_whole(base, kind, m):
    """K2′, K5 and K7 on the stressed plans: the walk in the kernel's
    slices and in spans of 3 windows / 4 entries equals the whole walk bit
    for bit (found, the record, the windows staged); so does the wrapper's
    plain version; and the spans walked each from nothing, in any order,
    OR to the same found."""
    prep, eps, bs = base["prep"], base["cfg"].mt_eps, base["prep"].block_size
    o, d, so = _shadow(base, m)
    plan, wt, groups = _anyhit_plan(base, kind, o, d, m)
    plan, tri = _stress(plan, prep.tri, wt, groups)
    bobj = torch.cat([prep.block_obj, prep.block_obj])
    assert bobj.shape[0] * bs == tri.shape[0]
    f1, lp1, st1 = _whole_found(plan, tri, bobj, o, d, so, wt, bs, eps,
                                groups)
    fs, lps, sts = _whole_found(
        plan, tri, bobj, o, d, so, wt, bs, eps, groups,
        slice_rays=nearest.slice_rays(m, groups), spans=SPANS)
    assert torch.equal(fs, f1) and torch.equal(lps, lp1)
    assert torch.equal(sts, st1)
    args = (tri, bobj, o, d, so, wt, bs, eps, True)
    pf = (anyhit.tiled_anyhit_grouped_plain(plan, *args, groups)
          if groups > 1 else anyhit.tiled_anyhit_plain(plan, *args))
    assert torch.equal(pf, f1)
    assert 50 < int(f1.sum()) < f1.numel()
    # order-free: each span from nothing, ORed in reverse order
    flat, mask = (nearest.group_walk_masks(plan, groups) if groups > 1
                  else (plan, None))
    gr = m // groups
    acc = torch.zeros((flat.shape[0], gr), dtype=torch.bool)
    lst = plan[:, 3] == 1
    spans = 1 + max(int(plan[~lst, 1].max()) // SPANS[0],
                    int(plan[lst, 2].max()) // SPANS[1])
    for s in reversed(range(spans)):
        sub, smask = nearest.span_plan(flat, s, *SPANS, walk_mask=mask)
        acc |= anyhit.walk_plain(
            sub, tri, bobj, xyz(o.reshape(-1, gr, 3)),
            xyz(d.reshape(-1, gr, 3)), so.reshape(-1, gr),
            torch.zeros_like(acc), wt, bs, eps, True, walk_mask=smask)
    assert torch.equal(acc.reshape(f1.shape), f1)


def test_split_nearest_walks_match_jax(base):
    """K1's rays mode and K4 split (slices, lists in spans of 4) on the
    parity frame's plans vs JAX's Pallas ``tiled_nearest_t`` (interpret
    mode) on the ungrouped plan; K6 split vs JAX ``tiled.tiled_hits``."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    o, d = base["o"], base["d"]
    o3, d3 = _primary(base, TILE)
    Ft, _, _ = tiled_t.ray_tile_features_t(_j(o), _j(d), TILE)
    flat = pl.cull_rays(prep, o, d, TILE, MAXV, 2)
    jt, ji = (np.asarray(x) for x in tiled_t.tiled_nearest_t(
        Ft, _j(flat), jprep.gram_t, TILE, prep.block_size, 2, cfg.mt_eps,
        prec="highest"))
    grouped = pl.cull_rays(prep, o, d, TILE, MAXV, 2, groups=G)
    pjt, pji = jtiled.tiled_hits(jprep, _j(o), _j(d), TILE, cfg.mt_eps,
                                 MAXV, apex=True)
    pages = paged.cull(prep, cfg, o, d, TILE, MAXV, apex=True)
    ours = {
        "rays": _split_nearest(flat, prep.tri, o3, d3, 64, cfg.mt_eps, 1,
                               SPANS[1])[:2],
        "grouped": _split_nearest(grouped, prep.tri, o3, d3, 64, cfg.mt_eps,
                                  G, SPANS[1])[:2],
        "pages": _split_nearest(pages, prep.tri, o3, d3, prep.page_tris,
                                cfg.mt_eps, 1, SPANS[1])[:2]}
    for kind, (t, idx) in ours.items():
        rt, ri = ((np.asarray(pjt), np.asarray(pji)) if kind == "pages"
                  else (jt, ji))
        t, idx = t.numpy().reshape(-1), idx.numpy().reshape(-1)
        rt, ri = rt.reshape(-1), ri.reshape(-1)
        h, hr = np.isfinite(t), np.isfinite(rt)
        assert h.sum() > 4000 and (h == hr).mean() > 0.999, kind
        both = h & hr
        np.testing.assert_allclose(t[both], rt[both], rtol=1e-4, atol=1e-6)
        print(f"{kind}: idx differs on {int((idx != ri).sum())} of "
              f"{idx.size}")
        assert (idx == ri).mean() >= 0.999, kind
    assert int(flat[:, 2].max()) > SPANS[1]


def test_split_anyhit_walks_match_jax(base):
    """K2′ and K5 split (slices, spans of 3 windows / 4 entries) on the
    folded soft-shadow tiles (M = 1,024) vs JAX's Pallas ``tiled_anyhit_t``
    (interpret mode) on the ungrouped plan, every lane; K7 split on the
    hard shadow's 256-ray tiles vs JAX ``tiled.anyhit``."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    bs, M = prep.block_size, 1024
    o, d, so = _shadow(base, M)
    n = so.shape[0]
    grouped = pl.cull_occl(prep, o.reshape(-1, 3), d.reshape(-1, 3), M,
                           MAXV, 4, None, hourglass=False, groups=G)
    mv = (grouped.shape[1] - pl.PLAN_AUX) * 8 // 9
    flat = grouped[:, :pl.PLAN_AUX + mv].contiguous()
    split = dict(slice_rays=nearest.slice_rays(M, G), spans=SPANS)
    fg = _whole_found(grouped, prep.tri, prep.block_obj, o, d, so, 128, bs,
                      cfg.mt_eps, G, **split)[0]
    split["slice_rays"] = nearest.slice_rays(M)
    ff = _whole_found(flat, prep.tri, prep.block_obj, o, d, so, 128, bs,
                      cfg.mt_eps, 1, **split)[0]
    Ft, _, _ = tiled_t.ray_tile_features_t(_j(o.reshape(-1, 3)),
                                           _j(d.reshape(-1, 3)), M)
    npad = jprep.gram_t.shape[1] // (4 * bs) - jprep.block_obj.shape[0]
    bobj = jnp.concatenate([jprep.block_obj,
                            jnp.full((npad,), -1, jnp.int32)])
    sj = jnp.asarray(so.numpy(), jnp.float32).reshape(n, 1, M)
    jf = np.asarray(tiled_t.tiled_anyhit_t(
        Ft, sj, _j(flat), jprep.gram_t, bobj, M, bs, 4, cfg.mt_eps, True,
        prec="highest"))
    np.testing.assert_array_equal(ff.numpy(), jf)
    np.testing.assert_array_equal(fg.numpy(), jf)
    assert 50 < ff.sum() < ff.numel()

    # K7: the hard shadow's page plan
    ho, hd, hso = _shadow(base, 256)
    nh = hso.shape[0]
    pplan = paged.cull_occl(prep, cfg, ho.reshape(-1, 3), hd.reshape(-1, 3),
                            256, MAXV, apex_rev=True, hourglass=False)
    fp = _whole_found(pplan, prep.tri, prep.block_obj, ho, hd, hso,
                      prep.page_tris, bs, cfg.mt_eps, 1,
                      slice_rays=nearest.slice_rays(256), spans=SPANS)[0]
    jfp = np.asarray(jtiled.anyhit(
        jprep, _j(ho.reshape(-1, 3)), _j(hd.reshape(-1, 3)),
        jnp.asarray(hso.numpy(), jnp.float32), _j(pplan), 256, cfg.mt_eps,
        True)).reshape(nh, 256)
    print(f"K7: found differs on {int((fp.numpy() != jfp).sum())} of "
          f"{jfp.size}")
    assert (fp.numpy() == jfp).mean() >= 0.9999 and fp.sum() > 50


@pytest.mark.parametrize("kind, m", [("grouped", TILE), ("pages", TILE),
                                     ("rays", 1000)])
def test_rays_schedule_each_once_longest_first(base, kind, m):
    """The schedule of a stressed plan at the walk's own spans and at
    SPANS: every (tile, span) once (a range row as its spans of windows, a
    list as its spans of entries), walk lengths never growing, each row
    ``rays_slices`` items."""
    prep = base["prep"]
    plan, wt, groups = _nearest_plan(base, kind, m)
    plan, tri = _stress(plan, prep.tri, wt, groups)
    nw = tri.shape[0] // wt
    for rs, ls in (nearest.rays_spans(wt), SPANS):
        rows, length = nearest.work_rows(plan, nw, rs, ls)
        want = []
        for t in range(plan.shape[0]):
            lst = int(plan[t, 3]) == 1
            cnt = int(plan[t, 2]) if lst else min(
                int(plan[t, 1]), max(0, nw - int(plan[t, 0])))
            span = ls if lst else rs
            want += [(t, s, min(span, cnt - s * span))
                     for s in range(-(-cnt // span))]
        got = [(int(a), int(b), int(c)) for (a, b), c in zip(rows, length)]
        assert sorted(got) == sorted(want) and len(got) == len(set(got))
        assert all(a[2] >= b[2] for a, b in zip(got, got[1:]))
        assert any(s > 0 and int(plan[t, 3]) == 0 for t, s, _ in got)
        assert rows.shape[0] <= nearest.rows_max(plan, nw, rs, ls, groups)
    assert nearest.rays_slices(m, groups) == {TILE: 8, 1000: 2}[m]


@pytest.mark.parametrize("m, groups, rays, slices",
                         [(4096, 1, 512, 8), (4096, 4, 512, 8),
                          (1024, 1, 512, 2), (1024, 4, 256, 4),
                          (256, 1, 256, 1), (1000, 1, 512, 2),
                          (768, 4, 192, 4), (100, 1, 128, 1)])
def test_slices_of_a_tile(m, groups, rays, slices):
    """Slices of at most 512 lanes, whole warps, inside one sub-group."""
    assert nearest.slice_rays(m, groups) == rays
    assert nearest.rays_slices(m, groups) == slices


@pytest.mark.parametrize("slice_rays, list_span, want",
                         [(0, 0, 0), (512, 0, 0),
                          (512, nearest.rays_spans(128)[1], 0),
                          (512, 1, 128)])
def test_split_walk_trusts_the_entry_bound(slice_rays, list_span, want):
    """A lying bound stops every slice after the first page, as it stops
    the whole tile; a list split into spans of one entry walks the second
    page too, from its own start, and finds the nearer hit.  K6's plain
    version walks in its own spans (the first case's); the kernel does the
    same (tests/test_torch_cuda.py)."""
    (plan, tri, o, d), (wt, eps) = two_pages(1.0)
    t, idx = nearest.walk_plain(plan, tri, xyz(o), xyz(d), wt, eps,
                                slice_rays=slice_rays, list_span=list_span)
    assert (idx == want).all() and torch.isfinite(t).all()
    _, pidx = paged.tiled_nearest_plain(plan, tri, o, d, wt, eps)
    assert (pidx == 0).all()
