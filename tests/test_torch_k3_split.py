"""PyTorch port, K3 (the bf16 classification walk) as work items: the
plain model of its decomposition.

K3 runs on the card as work items (tile, ray slice, span)
(csrc/prepass.cu): slices of ``nearest.slice_rays(M)`` lanes, range rows in
spans of windows and lists in spans of entries
(``prepass.PREPASS_RANGE_SPAN``, ``PREPASS_LIST_SPAN``), each span walked
from best_hi = +inf with the slice's own alpha and break, listed longest
first by the walks' shared schedule with no rows for a range row longer
than the plan's entries (``prepass.work_rows``).  Its plain version
``prepass.tiled_prepass_plain`` models the items.  These tests hold that
model on the CPU, on the parity scene (tests/_torch_parity.py) with plans
rewritten to reach every kind of row (``_torch_cases.k3_stress``: a range
row longer than a span, one longer than the plan's entries, deep lists,
empty rows, hits tied with copies):

* the refined nearest walk over the model's flags equals the unrefined
  walk bit for bit (t, idx), at tiles of 4,096, 1,000 and 768 rays (a last
  slice cut short) and several span pairs;
* at one slice a tile and spans longer than every row, the model equals a
  frozen copy of the whole-tile walk K3 ran before its work items;
* the items walked one by one in reverse order OR to the same flags;
* per-slice alpha majorizes twice the bf16 error of each slice's rays;
* the FMA form of the ten-term sum equals the separate form bit for bit;
* the schedule lists each walked row once, longest first, and none for the
  long range row.
"""

import numpy as np
import pytest
import torch

from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import nearest, prepass, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.ops.intersect import ray_features

from simple_raytracer_tpu.accel.prepared import prepare as jprepare

from _torch_cases import k3_stress
from _torch_parity import (FOCAL, HEIGHT, TILE_PX, VIEW, WIDTH, configs,
                           jax_prepared_arrays, managers)

MAXV = 248
WT = 64                 # window_blocks (2) x block_size (32)
TILES = 8               # tiles of a case: each stressed kind twice
BIG = 1 << 20           # a span longer than every row
# span pairs (range windows, list entries): short enough to cut the parity
# scene's ranges and lists, and the kernel's own
SPANS = ((3, 4), (5, 2), (prepass.PREPASS_RANGE_SPAN,
                          prepass.PREPASS_LIST_SPAN))


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
    """The parity scene (port side) and the moved view's primary rays."""
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    o, d, _, _ = tcam.primary_rays_tiled(WIDTH, HEIGHT, TILE_PX, FOCAL,
                                         view_matrix=torch.from_numpy(VIEW))
    return {"prep": prep, "eps": cfg.mt_eps, "o": o.reshape(-1, 3),
            "d": d.reshape(-1, 3)}


_CASES = {}


def _case(b, m: int):
    """The stressed K3 operands over the primary rays in tiles of ``m``
    (padded by repeating the last ray), cut to TILES tiles: (plan, tri,
    gram, o, d), and the unrefined walk's (t, idx)."""
    if m not in _CASES:
        prep = b["prep"]
        plan = pl.cull_rays(prep, b["o"], b["d"], m, MAXV, 2, apex=True)
        plan, tri, gram = k3_stress(plan, prep.tri, prep.gram, WT)
        o, d, _ = pl.pad_rays(b["o"], b["d"], m)
        n = o.shape[0] // m
        o, d = o.reshape(n, m, 3)[:TILES], d.reshape(n, m, 3)[:TILES]
        plan = plan[:TILES]
        short = _short(plan)
        unrefined = table.run("nearest_rays", plan[short], tri, o[short],
                              d[short], WT, b["eps"])
        _CASES[m] = (plan, tri, gram, o, d), unrefined
    return _CASES[m]


def _flags(b, m: int, spans):
    """The item model's flags on case ``m`` at ``spans``, computed once
    for all the tests of this file."""
    key = (m, spans)
    if key not in _CASES:
        plan, _, gram, o, d = _case(b, m)[0]
        _CASES[key] = prepass.tiled_prepass_plain(
            plan, gram, o, d, WT, b["eps"], range_span=spans[0],
            list_span=spans[1])
    return _CASES[key]


def _short(plan):
    """The rows K3 may refine: all but the range rows longer than the
    plan's entries, which refine_plan keeps as they are (so their walks
    are the unrefined ones by construction, and are not rerun here)."""
    return torch.nonzero(_cnt(prepass.walked_plan(plan)) == _cnt(plan)) \
        .flatten()


def _frozen_whole_tile_walk(plan, gram, o, d, window_tris: int, eps: float):
    """K3's plain walk before its work items, verbatim: every tile walks its
    whole row over all its rays (alpha the tile's, best_hi carried over the
    row, the break on every ray), range rows longer than the plan's entries
    not at all."""
    n, m = o.shape[:2]
    dev = plan.device
    wt = window_tris
    f = ray_features(o, d)                                      # [n, M, 10]
    alpha = f.abs().amax(dim=1)                                 # [n, 10]
    fb = prepass._bf16(f)
    g = gram.reshape(-1, 10, 4)
    gb = prepass._bf16(g)
    ga = g.abs()
    mv = plan.shape[1] - pl.PLAN_AUX
    use_list = plan[:, 3] == 1
    cnt = torch.where(use_list, plan[:, 2], plan[:, 1])
    cnt = torch.where(~use_list & (cnt > mv), 0, cnt)     # kept by refine_plan
    flags = torch.zeros(plan.shape, dtype=torch.bool, device=dev)
    bh = torch.full((n, m), float("inf"), device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    jt = torch.arange(wt, dtype=torch.int32, device=dev)
    chunk = max(1, prepass.PLAIN_ELEMS // max(1, m * wt))
    for k in range(int(cnt.max()) if n else 0):
        live = torch.nonzero((k < cnt) & ~done).flatten()
        for ids in live.split(chunk):
            e = plan[ids, pl.PLAN_AUX + min(k, mv - 1)]
            w = torch.where(use_list[ids], e & 0xFFFF, plan[ids, 0] + k)
            tid = (w[:, None] * wt + jt[None, :]).long()        # [c, wt]
            G, Ga = gb[tid], ga[tid]                            # [c, wt, 10, 4]
            al = alpha[ids]
            s = Ga[:, :, 0, :] * al[:, None, 0, None]
            for kk in range(1, 10):
                s = s + Ga[:, :, kk, :] * al[:, None, kk, None]
            err = (prepass.PREPASS_M * s)[:, None]              # [c, 1, wt, 4]
            F = fb[ids]
            q = G[:, None, :, 0, :] * F[:, :, None, 0, None]    # [c, M, wt, 4]
            for kk in range(1, 10):
                q = q + G[:, None, :, kk, :] * F[:, :, None, kk, None]
            sgn = torch.where(q[..., 0] >= 0.0, 1.0, -1.0)
            adet, un, vn, tn = (q[..., c] * sgn for c in range(4))
            eD, eU, eV, eT = (err[..., c] for c in range(4))
            uL, uH, vL, vH = un - eU, un + eU, vn - eV, vn + eV
            tL, tH = tn - eT, tn + eT
            aL, aH = adet - eD, adet + eD
            mn = torch.minimum
            conf = mn(mn(uL, vL), mn(aL - (uH + vH), mn(tL, aL - eps))) >= 0.0
            t_hi = tH / aL.clamp_min(1e-30)
            mb = mn(mn(uH, vH), mn(aH - (uL + vL), mn(tH, aH - eps))) >= 0.0
            b0 = bh[ids][..., None]                             # [c, M, 1]
            cand = (mb & (tL.clamp_min(0.0) <= b0 * aH)) | \
                (~(adet > eD) & (aH >= eps))
            flags[ids, k] = cand.flatten(1).any(dim=1)
            best = torch.where(conf, t_hi, float("inf")).amin(dim=-1)
            bh[ids] = torch.minimum(bh[ids], best)
        # front-to-back break on the rays' upper bounds (logical shift)
        nb16 = plan[live, pl.PLAN_AUX + min(k + 1, mv - 1)] >> 16
        worst = ((bh[live].view(torch.int32) >> 16) & 0xFFFF).amax(dim=1)
        done[live] = use_list[live] & (k + 1 < cnt[live]) & (worst < nb16)
    return flags


def _cnt(p):
    return torch.where(p[:, 3] == 1, p[:, 2], p[:, 1])


@pytest.mark.parametrize("m, spans", [(TILE_PX * TILE_PX, SPANS[0]),
                                      (TILE_PX * TILE_PX, SPANS[2]),
                                      (1000, SPANS[1]), (1000, SPANS[2]),
                                      (768, SPANS[0])])
def test_refined_walk_over_the_items_equals_unrefined(base, m, spans):
    """The nearest walk over the plan refined by the item model's flags
    gives the unrefined walk's (t, idx) bit for bit, at short spans and at
    the kernel's own;
    the long range row is kept whole, and the stress reaches a range row
    of several spans and lists of several."""
    (plan, tri, gram, o, d), (t0, i0) = _case(base, m)
    eps = base["eps"]
    mv = plan.shape[1] - pl.PLAN_AUX
    short = _short(plan)
    assert int(plan[2, 1]) > mv and int(plan[2, 3]) == 0
    assert 2 not in short.tolist() and short.numel() == plan.shape[0] - 1
    assert int(_cnt(plan)[0]) > SPANS[0][0] and int(plan[1, 2]) > SPANS[0][1]
    assert torch.isfinite(t0).sum() > 1000
    flags = _flags(base, m, spans)
    assert not bool(flags[2].any()) and bool(flags.any())
    ref = prepass.refine_plan(plan, flags)
    assert torch.equal(ref[2], plan[2])
    assert bool((_cnt(ref) <= _cnt(plan)).all())
    t1, i1 = table.run("nearest_rays", ref[short], tri, o[short], d[short],
                       WT, eps)
    assert torch.equal(t1, t0) and torch.equal(i1, i0)
    print(f"m {m} spans {spans}: windows {_cnt(plan).tolist()} -> "
          f"{_cnt(ref).tolist()}")


def test_one_slice_whole_spans_is_the_whole_tile_walk(base):
    """At one slice a tile and spans longer than every row, the item model
    is the whole-tile walk K3 ran before its work items, flag for flag;
    the wrapper's own slices and spans flag no position past a row's
    walk."""
    m = TILE_PX * TILE_PX
    (plan, tri, gram, o, d), _ = _case(base, m)
    eps = base["eps"]
    want = _frozen_whole_tile_walk(plan, gram, o, d, WT, eps)
    got = prepass.tiled_prepass_plain(plan, gram, o, d, WT, eps,
                                      slice_rays=m, range_span=BIG,
                                      list_span=BIG)
    assert torch.equal(got, want) and bool(want.any())
    assert prepass.tiled_prepass_plain.lane_pairs.shape == (plan.shape[0], m)
    items = _flags(base, m, SPANS[2])
    pos = torch.arange(plan.shape[1])[None]
    assert not bool((items & (pos >= _cnt(prepass.walked_plan(plan))[:, None]))
                    .any())


def test_items_in_reverse_order_or_to_the_same_flags(base):
    """Each item (row of the schedule, slice) walked alone from nothing, in
    the reverse of the schedule's order, ORs to the model's flags: the
    kernel's items may run in any order."""
    m = 1000
    (plan, tri, gram, o, d), _ = _case(base, m)
    eps, (rs, ls) = base["eps"], SPANS[1]
    want = _flags(base, m, SPANS[1])
    rows, _ = prepass.work_rows(plan, gram.shape[0] // WT, rs, ls)
    sr = nearest.slice_rays(m)
    ns, src = nearest.slice_lanes(m, sr, "cpu")
    f = ray_features(o, d)[:, src].reshape(-1, ns, sr, 10)
    flags = torch.zeros_like(want)
    for tile, s in reversed(rows.tolist()):
        sub, _ = nearest.span_plan(plan[tile:tile + 1], s, rs, ls)
        k0 = s * (ls if int(plan[tile, 3]) == 1 else rs)
        for sl in reversed(range(ns)):
            fl = prepass.walk_plain(sub, gram, f[tile, sl:sl + 1], WT, eps)
            j = torch.nonzero(fl[0]).flatten()
            flags[tile, k0 + j] = True
    assert torch.equal(flags, want) and bool(want.any())
    assert rows.shape[0] > plan.shape[0]


def test_per_slice_alpha_majorizes_the_bf16_error(base):
    """PREPASS_M * sum_k |G_k| alpha_k, alpha each slice's own largest
    |F_k|, covers twice the error of the bf16 quad (bf16 operands, exact
    products, f32 sums in K3's order) of every ray of the slice against
    the parity scene's triangles: the twin of
    tests/test_torch_prepass.py::test_margin_majorizes_bf16_error."""
    prep = base["prep"]
    G = prep.gram[:prep.num_triangles].reshape(-1, 10, 4)
    o, d, _ = pl.pad_rays(base["o"], base["d"], TILE_PX * TILE_PX)
    sr = nearest.slice_rays(TILE_PX * TILE_PX)
    F = ray_features(o, d).reshape(-1, sr, 10)                  # [slices, sr]
    alpha = F.abs().amax(dim=1)                                 # [slices, 10]
    rng = np.random.default_rng(0)
    worst = 0.0
    for s in range(F.shape[0]):
        Gs = G[torch.from_numpy(rng.integers(0, G.shape[0], 64))]
        Fs = F[s, torch.from_numpy(rng.integers(0, sr, 128))]   # [128, 10]
        exact = torch.einsum("tfg,rf->rtg", Gs.double(), Fs.double())
        Gb, Fb = prepass._bf16(Gs), prepass._bf16(Fs)
        q = Gb[None, :, 0, :] * Fb[:, None, 0, None]
        for k in range(1, 10):
            q = q + Gb[None, :, k, :] * Fb[:, None, k, None]
        err = (q.double() - exact).abs()
        bound = prepass.PREPASS_M * torch.einsum(
            "tfg,f->tg", Gs.abs().double(), alpha[s].double())[None]
        worst = max(worst, float((err / bound.clamp_min(1e-30)).max()))
        assert (err * 2.0 <= bound + 1e-30).all(), (s, worst)
    # slices are tighter than tiles somewhere
    tile_alpha = F.reshape(-1, TILE_PX * TILE_PX // sr, sr, 10).abs().amax(
        dim=(1, 2))
    assert bool((alpha.reshape(tile_alpha.shape[0], -1, 10)
                 < tile_alpha[:, None]).any())
    print(f"bf16 quad error / per-slice margin: max {worst:.4f}")


def test_fma_ten_term_sum_equals_separate_form():
    """acc = G_0 F_0, then acc = fma(G_k, F_k, acc) for k = 1..9 (one
    rounding of the exact G_k F_k + acc, emulated in float64) equals acc =
    acc + G_k F_k (the product rounded, then the sum) bit for bit on bf16
    operands: each product of two bf16 values is exact in f32.  So does
    the plain walk's ``addcmul_``."""
    rng = np.random.default_rng(1)
    n = 1 << 16

    def draw():          # sign x [0.5, 1) x 2^-4..2^4, rounded to bf16
        x = (rng.choice([-1.0, 1.0], (n, 10)) * rng.uniform(0.5, 1.0, (n, 10))
             * 2.0 ** rng.integers(-4, 5, (n, 10)))
        return prepass._bf16(torch.from_numpy(x).float())
    G, F = draw(), draw()
    sep = G[:, 0] * F[:, 0]
    fma = sep.clone()
    acm = sep.clone()
    for k in range(1, 10):
        p32 = G[:, k] * F[:, k]
        p64 = G[:, k].double() * F[:, k].double()
        assert torch.equal(p32.double(), p64)          # the product is exact
        s64 = p64 + fma.double()
        b = s64 - p64                                  # TwoSum: s64 is exact
        assert bool(((p64 - (s64 - b)) + (fma.double() - b) == 0).all())
        fma = s64.float()                              # one rounding
        sep = sep + p32
        acm.addcmul_(G[:, k], F[:, k])
    assert torch.equal(sep.view(torch.int32), fma.view(torch.int32))
    assert torch.equal(sep.view(torch.int32), acm.view(torch.int32))


@pytest.mark.parametrize("m", [TILE_PX * TILE_PX, 768])
def test_k3_schedule_each_walked_row_once_longest_first(base, m):
    """K3's schedule of a stressed plan at the kernel's spans and at short
    ones: every (tile, span) of a walked row once (a range row as its spans
    of windows, a list as its spans of entries), walk lengths never
    growing, none for the range row longer than the plan's entries; the
    scratch holds them."""
    (plan, tri, gram, o, d), _ = _case(base, m)
    nw = gram.shape[0] // WT
    mv = plan.shape[1] - pl.PLAN_AUX
    for rs, ls in SPANS:
        rows, length = prepass.work_rows(plan, nw, rs, ls)
        want = []
        for t in range(plan.shape[0]):
            lst = int(plan[t, 3]) == 1
            cnt = int(plan[t, 2]) if lst else min(
                int(plan[t, 1]), max(0, nw - int(plan[t, 0])))
            if not lst and int(plan[t, 1]) > mv:
                continue
            span = ls if lst else rs
            want += [(t, s, min(span, cnt - s * span))
                     for s in range(-(-cnt // span))]
        got = [(int(a), int(b), int(c)) for (a, b), c in zip(rows, length)]
        assert sorted(got) == sorted(want) and len(got) == len(set(got))
        assert all(a[2] >= b[2] for a, b in zip(got, got[1:]))
        assert not any(t == 2 for t, _, _ in got)
        assert any(s > 0 and int(plan[t, 3]) == 0 for t, s, _ in got)
        assert rows.shape[0] <= nearest.rows_max(plan, nw, rs, ls)
