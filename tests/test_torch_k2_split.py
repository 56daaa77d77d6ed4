"""PyTorch port, K2 as work items: the plain model of its decomposition.

K2, the hard-shadow walk of the fused frame
(``anyhit.tiled_anyhit_from_t``), runs on the card as two launches on the
walks' shared schedule: ``anyhit_schedule_kernel`` starts found at the
miss lanes and lists the (tile, span) rows longest first, and
``anyhit_items_kernel`` walks (tile, ray slice, span) items, each
rebuilding its shadow rays from t.  found is the OR of one predicate over
the plan's windows, so the items give the whole-tile walk's found in any
order.  These tests hold the plain model of the items
(``tiled_anyhit_from_t_plain(slice_rays=, spans=)``) on the CPU, on the
parity scene (tests/_torch_parity.py) at its moved view, where the
sphere's shadow is in view, with shadow plans rewritten to reach every
kind of row (_torch_cases.k2_stress: a range row longer than one span,
lists twice as deep, empty plans, all-miss tiles):

* the model equals the whole-tile walk on every lane, and so does its
  record, at several slice sizes (whole tiles among them) and spans, at
  tiles of 4,096, 1,024 and 256 rays; spans walked in any order give the
  same found;
* both equal JAX's Pallas ``tiled_t.tiled_anyhit_from_t`` (interpret
  mode) on the same t, obj, plan and camera;
* tiles with an empty plan read !hit, miss lanes read 1, and a range row
  over every window gives the tile's found from its list;
* the port's fused frame at 32-pixel tiles equals JAX's tiled frame at
  JAX's own bars (tests/test_tiled.py:74-94).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import anyhit, nearest, table, tiled
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.render.renderer import render

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled_t

from _torch_cases import k2_stress
from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_frame, jax_prepared_arrays, managers)

# (tile pixels, rays per slice, (range span, list span)): K2's own slices
# and spans (None), short and single spans, slices cut short (1,000 rays)
# and whole tiles
SPLITS = [(64, 512, None), (64, 1000, (1, 1)), (64, 4096, (2, 3)),
          (32, 512, (3, 4)), (32, 1024, None), (16, 256, (2, 3))]


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
    """The parity scene in both packages, and K2's arguments on the port's
    fused frame at the moved view for each tile size, as the frame gives
    them and stressed, with the whole-tile walk's found and record on
    each."""
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    out = {"prep": prep, "jprep": jprep, "cfg": cfg, "jcfg": jcfg}
    for tpx in (64, 32, 16):
        k2 = list(_frame_k2(prep, cfg.replace(tile_px=tpx), tpx))
        out[tpx] = tuple(k2)
        k2[:4] = k2_stress(*k2[:4], k2[7])
        out[tpx, "stressed"] = tuple(k2)
    for key in (64, (64, "stressed"), (32, "stressed"), (16, "stressed")):
        f = anyhit.tiled_anyhit_from_t_plain(*out[key])
        out[key, "whole"] = (f, anyhit.walk_plain.lane_pairs,
                             anyhit.walk_plain.staged)
    return out


def _frame_k2(prep, cfg, tpx: int):
    """The arguments the port's fused frame at the moved view hands K2."""
    caught = []
    with table.using({**table.plain(),
                      "anyhit_from_t": table.spy("anyhit_from_t", caught)}):
        tiled.render_flat_tiled(
            prep, cfg, torch.tensor(LIGHT),
            (torch.from_numpy(VIEW), FOCAL, WIDTH, HEIGHT, tpx))
    assert len(caught) == 1 and caught[0][6] == tpx
    return caught[0]


def _split(k2, slice_rays: int, spans):
    """found of the plain model of K2's items, with its record."""
    f = anyhit.tiled_anyhit_from_t_plain(
        *k2, slice_rays=slice_rays, spans=spans or anyhit.rays_spans(k2[7]))
    return f, anyhit.walk_plain.lane_pairs, anyhit.walk_plain.staged


def _counts(plan):
    return torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1])


@pytest.mark.parametrize("tpx, slice_rays, spans", SPLITS)
def test_k2_split_walk_equals_whole(base, tpx, slice_rays, spans):
    """K2's items on the stressed plans: the model in slices of
    ``slice_rays`` and in ``spans`` equals the whole-tile walk bit for bit,
    found, each lane's tests and the windows staged; the shadow stays in
    view; empty plans read !hit and miss lanes 1 in both."""
    k2 = base[tpx, "stressed"]
    whole, rec, staged = base[(tpx, "stressed"), "whole"]
    f, frec, fstaged = _split(k2, slice_rays, spans)
    assert torch.equal(f, whole)
    assert torch.equal(frec, rec) and torch.equal(fstaged, staged)
    plan, t = k2[0], k2[3]
    hit = torch.isfinite(t)
    empty = _counts(plan) == 0
    assert int((whole & hit).sum()) > 500
    assert bool(whole[~hit].all())
    assert bool((empty[:, None] & hit).any())
    assert torch.equal(whole[empty], ~hit[empty])
    sp = spans or anyhit.rays_spans(k2[7])
    assert int(_counts(plan)[plan[:, 3] != 1].max()) > sp[0]
    assert int(plan[plan[:, 3] == 1, 2].max()) > sp[1]


def test_k2_spans_in_any_order(base):
    """Each span of each row walked alone from the miss lanes' start, in
    reverse order, ORs to the whole-tile walk's found."""
    k2 = base[32, "stressed"]
    plan, wt = k2[0], k2[7]
    whole = base[(32, "stressed"), "whole"][0]
    rs, ls = 3, 4
    lst = plan[:, 3] == 1
    spans = 1 + max(int(plan[~lst, 1].max()) // rs,
                    int(plan[lst, 2].max()) // ls)
    acc = ~torch.isfinite(k2[3])
    for s in reversed(range(spans)):
        sub, _ = nearest.span_plan(plan, s, rs, ls)
        acc |= anyhit.tiled_anyhit_from_t_plain(sub, *k2[1:])
    assert spans > 2 and torch.equal(acc, whole)
    assert int(whole.sum()) > int((~torch.isfinite(k2[3])).sum())
    # the schedule of the same spans: every (tile, span) row once, the
    # range row as its spans, longest first
    rows, length = nearest.work_rows(plan, k2[1].shape[0] // wt, rs, ls)
    key = rows[:, 0].long() * 4096 + rows[:, 1].long()
    assert key.unique().numel() == rows.shape[0]
    assert bool((length[1:] <= length[:-1]).all()) and bool((length > 0).all())
    want = sum(-(-int(c) // (ls if bool(u) else rs))
               for c, u in zip(_counts(plan), lst))
    assert rows.shape[0] == want


def test_k2_range_row_gives_the_list_found(base):
    """A tile's list row replaced by a range row over every window (longer
    than one span) gives the same found: the cull keeps every window that
    can occlude, and the walk skips the tile's own blocks ray by ray."""
    k2 = base[64]
    plan, tri, wt = k2[0], k2[1], k2[7]
    nw = tri.shape[0] // wt
    rng = plan.clone()
    lst = (rng[:, 3] == 1) & (_counts(rng) > 0)
    rng[lst, 0], rng[lst, 1], rng[lst, 3] = 0, nw, 0
    assert bool(lst.any()) and nw > anyhit.rays_spans(wt)[0]
    g = _split((rng,) + k2[1:], 512, None)[0]
    assert torch.equal(g, base[64, "whole"][0])


class _Caught(Exception):
    """Stops JAX's anyhit_from_t once its walk's operands are caught."""


def _jax_walk(base, tpx: int, plans):
    """JAX's ``tiled_anyhit_from_t`` (interpret mode) on each of ``plans``,
    with the operands JAX's own ``anyhit_from_t`` gives it on the port's t,
    obj and bounds rows of the frame at ``tpx``-pixel tiles (the camera
    and light rows, the geometry, the t/obj rows)."""
    prep, jprep, cfg = base["prep"], base["jprep"], base["cfg"]
    k2 = base[tpx]
    tile = tpx * tpx
    c = cfg.replace(tile_px=tpx)
    maxv = pl.effective_cull_maxv(c, prep.num_blocks,
                                  c.kernel.window_blocks)
    cam_spec = (torch.from_numpy(VIEW), FOCAL, WIDTH, HEIGHT, tpx)
    _t, _i, obj, _rgb, bounds = nearest.hits_shaded(
        prep, c, torch.tensor(LIGHT), cam_spec, maxv)
    assert torch.equal(obj.reshape(k2[4].shape), k2[4])
    calls = []

    def catch(*a, **k):
        calls.append((a, k))
        raise _Caught
    orig = tiled_t.tiled_anyhit_from_t
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tiled_t, "tiled_anyhit_from_t", catch)
        with pytest.raises(_Caught):
            tiled_t.anyhit_from_t(
                jprep, jnp.asarray(k2[3].reshape(-1).numpy()),
                jnp.asarray(obj.numpy()), jnp.asarray(bounds.numpy()), tile,
                cfg.mt_eps, True, jnp.asarray(LIGHT),
                (jnp.asarray(VIEW, jnp.float32), FOCAL, WIDTH, HEIGHT, tpx),
                maxv)
    finally:
        mp.undo()
    (a, kw), = calls
    return [np.asarray(orig(a[0], jnp.asarray(p.numpy()), *a[2:], **kw))
            for p in plans]


def test_k2_items_match_jax(base):
    """The whole-tile walk and the items' model equal JAX's Pallas walk on
    every lane, on the frame's plan and on the plan with each list row a
    range row over every window; the shadow is in view."""
    k2 = base[64]
    plan, tri, wt = k2[0], k2[1], k2[7]
    rng = plan.clone()
    lst = (rng[:, 3] == 1) & (_counts(rng) > 0)
    rng[lst, 0], rng[lst, 1], rng[lst, 3] = 0, tri.shape[0] // wt, 0
    jf = _jax_walk(base, 64, (plan, rng))
    hit = torch.isfinite(k2[3]).numpy()
    whole = base[64, "whole"][0].numpy()
    assert (whole & hit).sum() > 500 and whole[~hit].all()
    np.testing.assert_array_equal(whole, jf[0])
    for p, want in zip((plan, rng), jf):
        model = _split((p,) + k2[1:], 512, None)[0].numpy()
        np.testing.assert_array_equal(model, want)


def test_k2_fused_frame_matches_jax(base):
    """The port's fused frame at 32-pixel tiles (K2 over tiles of 1,024
    rays, two slices) equals JAX's tiled frame there at JAX's own bars:
    within 1 on >= 99.9% of pixels, equal on >= 98%; the sphere's shadow
    dims the frame."""
    prep, jprep, cfg, jcfg = (base[k] for k in ("prep", "jprep", "cfg",
                                                "jcfg"))
    c, jc = cfg.replace(tile_px=32), jcfg.replace(tile_px=32)
    assert tiled.frame_branch(prep, c, 32 * 32) == "fused"
    mp = pytest.MonkeyPatch()
    try:
        jimg = jax_frame(jprep, jc, VIEW, mp, tile_px=32)
    finally:
        mp.undo()
    img = render(prep, c, LIGHT, view_matrix=VIEW).numpy()
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert img.shape == (HEIGHT, WIDTH, 3)
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    off = render(prep, c.replace(light=type(c.light)(enable_shadows=False)),
                 LIGHT, view_matrix=VIEW).numpy().astype(int)
    assert ((off - img.astype(int)).max(axis=-1) > 0).sum() > 200
    assert TILE_PX != 32       # not the parity frame of test_torch_render
