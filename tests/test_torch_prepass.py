"""PyTorch port, kernel 3: the bf16 classification walk of the exact
two-pass nearest walk (``KernelConfig.prepass``), through its plain version.

Both packages get the same padded, BVH-ordered parity scene
(``from_jax_prepared``) and the same primary rays.  The JAX side runs its
prepass ``tiled_t.hits`` under ``SRT_TILED_PREPASS=1`` in interpret mode,
where its classification is plain f32: its flags are no reference for the
port's bf16 ones, so the tests compare what the flags produce — the refined
walk's (t, idx) — never the flags themselves.  Bars: the Gram table equal
to JAX's; the bf16 margin at least twice the port's own bf16 quad error;
the refined walk equal to the unrefined walk bit for bit, and to JAX's
prepass hits at the nearest kernel's bars (t rtol 1e-4 / atol 1e-6, idx
equal on >= 99.9%: the JAX kernel forms its numerators as a Gram
contraction where the port runs the cross-product Möller–Trumbore).
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.kernels import nearest, prepass, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.ops.intersect import ray_features

from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.kernels import tiled_t
from simple_raytracer_tpu.ops.intersect import pack_mt_gram_np

from _torch_parity import (FOCAL, HEIGHT, TILE_PX, VIEW, WIDTH, configs,
                           jax_prepared_arrays, managers)

MAXV = 248
TILE = TILE_PX * TILE_PX
WT = 64                     # window_blocks (2) x block_size (32)
VIEWS = {"identity": None, "moved": VIEW}


@pytest.fixture(scope="module")
def base():
    """The parity scene in both packages."""
    _, jsm = managers()
    cfg, jcfg = configs()
    jprep = jprepare(jsm.build(), jcfg)
    prep = from_jax_prepared(jax_prepared_arrays(jprep),
                             num_triangles=int(jprep.num_triangles),
                             device="cpu")
    return prep, jprep, cfg


def _rays(view, tile=TILE):
    """The parity frame's primary rays, tile-major: (o, d) [R, 3] and
    (o3, d3) [n, tile, 3]."""
    vm = None if view is None else torch.from_numpy(view)
    o, d, _, _ = tcam.primary_rays_tiled(WIDTH, HEIGHT, TILE_PX, FOCAL,
                                         view_matrix=vm)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    return (o, d), (o.reshape(-1, tile, 3), d.reshape(-1, tile, 3))


@pytest.fixture(scope="module")
def walks(base):
    """Per view: the plan of the primary rays, K3's flags, the refined plan,
    the unrefined and refined walks, and the port's prepass ``hits``."""
    prep, _, cfg = base
    out = {}
    for name, vm in VIEWS.items():
        (o, d), (o3, d3) = _rays(vm)
        plan = pl.cull_rays(prep, o, d, TILE, MAXV, 2)
        flags = table.run("prepass", plan, prep.gram, o3, d3, WT,
                          cfg.mt_eps)
        ref = prepass.refine_plan(plan, flags)
        t0, i0 = table.run("nearest_rays", plan, prep.tri, o3, d3, WT,
                           cfg.mt_eps)
        t1, i1 = table.run("nearest_rays", ref, prep.tri, o3, d3, WT,
                           cfg.mt_eps)
        pcfg = cfg.replace(kernel=sr.KernelConfig(prepass=True))
        th, ih = nearest.hits(prep, pcfg, o, d, TILE, MAXV, apex=True)
        out[name] = dict(o=o, d=d, plan=plan, flags=flags, ref=ref,
                         unrefined=(t0, i0), refined=(t1, i1), hits=(th, ih))
    return out


def test_gram_matches_jax(base):
    """``gram`` [Tp, 40] holds JAX ``pack_mt_gram_np`` of the w-divided
    vertices, in the order of ``tri``."""
    prep, jprep, _ = base
    v = np.asarray(jprep.scene.verts)
    want = pack_mt_gram_np(v[..., :3] / v[..., 3:4]).reshape(-1, 40)
    assert prep.gram.shape == (prep.tri.shape[0], 40)
    np.testing.assert_array_equal(prep.gram.numpy(), want)


def test_margin_majorizes_bf16_error(base):
    """PREPASS_M * sum_k |G_k| alpha_k covers twice the error of the port's
    bf16 quad (bf16 operands, exact products, f32 sums in K3's order) on
    the parity scene's Gram factors and camera rays: the port's twin of
    tests/test_tiled_prepass.py::test_prepass_margin_majorizes_bf16_error."""
    prep = base[0]
    G = prep.gram[:prep.num_triangles].reshape(-1, 10, 4)
    (o, d), _ = _rays(VIEW)
    F = ray_features(o, d)
    rng = np.random.default_rng(0)
    n = 8192
    Gs = G[torch.from_numpy(rng.integers(0, G.shape[0], n))]    # [n, 10, 4]
    Fs = F[torch.from_numpy(rng.integers(0, F.shape[0], n))]    # [n, 10]
    exact = torch.einsum("nfg,nf->ng", Gs.double(), Fs.double())
    Gb, Fb = prepass._bf16(Gs), prepass._bf16(Fs)
    q = Gb[:, 0, :] * Fb[:, 0, None]
    for k in range(1, 10):
        q = q + Gb[:, k, :] * Fb[:, k, None]
    err = (q.double() - exact).abs()
    alpha = Fs.abs().amax(dim=0)
    bound = prepass.PREPASS_M * torch.einsum("nfg,f->ng", Gs.abs().double(),
                                             alpha.double())
    ratio = float((err / bound.clamp_min(1e-30)).max())
    print(f"bf16 quad error / margin: max {ratio:.4f}")
    assert (err * 2.0 <= bound + 1e-30).all(), ratio


@pytest.mark.parametrize("view", list(VIEWS))
def test_refined_walk_equals_unrefined_walk(walks, view):
    """The walk over the refined plan, and ``hits`` with ``prepass``, give
    the unrefined walk's (t, idx) bit for bit; the refine keeps no window
    the plan lacked."""
    w = walks[view]
    t0, i0 = w["unrefined"]
    for t, i in (w["refined"], w["hits"]):
        assert torch.equal(t.reshape(t0.shape), t0)
        assert torch.equal(i.reshape(i0.shape), i0)
    assert torch.isfinite(t0).sum() > 4000

    def cnt(p):
        return torch.where(p[:, 3] == 1, p[:, 2], p[:, 1])
    before, after = cnt(w["plan"]), cnt(w["ref"])
    print(f"{view}: windows per tile {before.tolist()} -> {after.tolist()}")
    assert (after <= before).all()


@pytest.mark.parametrize("view", list(VIEWS))
def test_refined_plan_is_a_sound_subset(walks, view):
    """Each refined row is a subset of its plan row in front-to-back bound
    order, list mode, and holds the window of each of its rays' winners."""
    w = walks[view]
    plan, ref = w["plan"].numpy(), w["ref"].numpy()
    _t, idx = w["unrefined"]
    idx = idx.numpy()
    assert ref.shape == plan.shape and (ref[:, 3] == 1).all()
    a = pl.PLAN_AUX
    for r in range(plan.shape[0]):
        cnt = plan[r, 2] if plan[r, 3] == 1 else plan[r, 1]
        orig = (plan[r, a:a + cnt] & 0xFFFF).tolist() if plan[r, 3] == 1 \
            else list(range(plan[r, 0], plan[r, 0] + cnt))
        got = ref[r, a:a + ref[r, 2]]
        assert set((got & 0xFFFF).tolist()) <= set(orig)
        b16 = (got.astype(np.int64) >> 16).tolist()
        assert b16 == sorted(b16)
        winners = set((idx[r][idx[r] >= 0] // WT).tolist())
        assert winners <= set((got & 0xFFFF).tolist())


def test_refine_plan_matches_jax(walks):
    """``refine_plan`` equals JAX ``_refine_plan`` on the same flags, with
    a range row among them (synthesized entries of bound 0)."""
    w = walks["moved"]
    plan = w["plan"].clone()
    # one row in range mode: its covering windows [lo, lo + 12)
    plan[0, 1], plan[0, 3] = 12, 0
    flags = w["flags"].clone()
    flags[0, :12] = torch.arange(12) % 3 == 0
    ours = prepass.refine_plan(plan, flags).numpy()
    theirs = np.asarray(tiled_t._refine_plan(
        jnp.asarray(plan.numpy()), jnp.asarray(flags.numpy(), jnp.float32)))
    np.testing.assert_array_equal(ours, theirs)
    a = pl.PLAN_AUX
    assert ours[0, 2] == 4 and (ours[0, a:a + 4] >> 16 == 0).all()


@pytest.mark.parametrize("view", list(VIEWS))
def test_prepass_hits_match_jax(base, walks, view, monkeypatch):
    """The port's prepass ``hits`` vs JAX ``tiled_t.hits`` under
    ``SRT_TILED_PREPASS=1`` (its K3 in interpret mode, then its K1 over
    the refined plan), and JAX's own refined walk equals its unrefined one
    bit for bit as the port's does."""
    prep, jprep, cfg = base
    w = walks[view]
    o, d = jnp.asarray(w["o"].numpy()), jnp.asarray(w["d"].numpy())
    out = {}
    for on in ("1", "0"):
        monkeypatch.setenv("SRT_TILED_PREPASS", on)
        out[on] = [np.asarray(x) for x in jax.jit(
            lambda p, o, d: tiled_t.hits(p, o, d, TILE, cfg.mt_eps, MAXV,
                                         apex=True))(jprep, o, d)]
    jt, ji = out["1"]
    np.testing.assert_array_equal(jt, out["0"][0])
    np.testing.assert_array_equal(ji, out["0"][1])
    t, idx = (x.numpy() for x in w["hits"])
    hj, ho = np.isfinite(jt), np.isfinite(t)
    assert hj.sum() > 4000 and (hj == ho).mean() > 0.999
    both = hj & ho
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-6)
    print(f"{view}: t equal on {(t[both] == jt[both]).mean():.6f} of hits, "
          f"idx differs on {int((idx != ji).sum())} of {idx.size}")
    assert (idx == ji).mean() >= 0.999
    assert (idx[~ho] == -1).all()


def test_prepass_wins_over_groups(base, walks):
    """With both ``prepass`` and ``groups`` set, ``hits`` takes the prepass
    walk over the ungrouped plan, as JAX ``tiled_t.hits`` does: K3 and the
    refined walk run, K4 does not, and (t, idx) are the prepass walk's."""
    prep, _, cfg = base
    w = walks["moved"]
    called = []

    def record(role):
        def run(*a):
            called.append(role)
            return table.pick(role, *a)(*a)
        return run

    roles = ("prepass", "nearest_rays", "nearest_grouped", "nearest_attrs")
    kcfg = cfg.replace(kernel=sr.KernelConfig(prepass=True, groups=4))
    with table.using({r: record(r) for r in roles}):
        t, idx = nearest.hits(prep, kcfg, w["o"], w["d"], TILE, MAXV,
                              apex=True)
    assert called == ["prepass", "nearest_rays"]
    assert torch.equal(t, w["hits"][0]) and torch.equal(idx, w["hits"][1])


def test_prepass_plain_records_its_work(walks, base):
    """The plain walk's work record (for chip_smoke.py's bound): every ray
    tests WT triangles per walked window, and the staged windows are the
    plan's."""
    prep, _, cfg = base
    w = walks["moved"]
    _, (o3, d3) = _rays(VIEW)
    flags = prepass.tiled_prepass_plain(w["plan"], prep.gram, o3, d3, WT,
                                        cfg.mt_eps)
    assert torch.equal(flags, w["flags"])
    lp = prepass.tiled_prepass_plain.lane_pairs
    assert lp.shape == (o3.shape[0], TILE) and (lp % WT == 0).all()
    assert (lp > 0).any() and prepass.tiled_prepass_plain.staged.any()
