"""PyTorch port: the planner's route (kernels/plan.py::cull, the ``plan``
role of kernels/table.py) and the model of csrc/plan.cu's entry order, on
the CPU.

The CUDA planner runs only on the card (tests/test_torch_plan_cuda.py holds
it to the plain planner there).  Here: which planner ``cull`` takes for each
flag, the wiring and counters, a plain model of the kernel's
partition (distinct bound16 values ascending, window order within each)
against ``cull_lists``' sort, and the plain planner's written-out dot
products against the matmul they replace.
"""

import types

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import nearest, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.scene import transforms as T
from simple_raytracer_tpu_torch.utils import metrics

SIZE, FOCAL, TPX = 128, 160.0, 32
INT32_MAX = np.iinfo(np.int32).max
VIEWS = {"identity": None,
         "moved": T.view_matrix((-2.0, -1.5, 6.0), (0.35, -0.2, 0.0))}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                             focal=FOCAL),
        bvh=sr.BVHConfig(split="sah"))
    prep = prepare(P.sphere_on_ground(sr.SceneManager(), 2).build(), cfg,
                   device="cpu")
    return prep, cfg


def _plans(twin: bool = False) -> int:
    """The plans csrc/plan.cu (``twin``: the plain planner) built so far."""
    return table.calls(twin)["plan"]


def _cam_spec(view):
    v = None if view is None else torch.from_numpy(view)
    return (v, FOCAL, SIZE, SIZE, TPX)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_by_flags(device):
    """The kernels take CUDA tensors and list plans, of the interval test
    or the hourglass test; every other combination goes plain."""
    for maxv, windows, listed in ((248, 1282, True), (0, 1282, False),
                                  (248, 70000, False),
                                  (1000, 65536, True)):
        for hourglass in (False, True):
            want = (pl.cull_cuda if device == "cuda" and listed
                    else pl.cull_plain)
            prep = types.SimpleNamespace(device=torch.device(device),
                                         num_blocks=windows)
            got = table.pick("plan", prep, maxv, 1, None, None, False,
                             False, hourglass)
            assert got is want, (device, maxv, windows, hourglass)


def test_both_apex_tests_are_refused(scene):
    """A plan takes the primary-apex test or the light-apex test: both at
    once is refused on either route, before any plan is built."""
    prep, cfg = scene
    plains = _plans(twin=True)
    cs = _cam_spec(None)
    ab = pl.tile_bounds_plain(pl.camera_plain(prep, cs), cs,
                              (SIZE // TPX) ** 2)
    with pytest.raises(ValueError, match="not both"):
        pl.cull(prep, cfg.cull_maxv, 2, ab, apex=True, apex_rev=True)
    assert _plans(twin=True) == plains


@pytest.mark.parametrize("groups", [1, 2])
def test_cuda_route_wiring(scene, groups):
    """``cull`` hands the ``plan`` role its arguments, the rays of a
    grouped plan's mask words included, and returns its plan; a stand-in
    kernel (the plain plan, a stand-in counted as nothing) shows the
    wiring.  The kernel's own counters move only on the
    card (tests/test_torch_plan_cuda.py)."""
    prep, cfg = scene
    o, d, _, _ = primary_rays_tiled(SIZE, SIZE, TPX, FOCAL)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    tile = TPX * TPX
    ab = pl.ray_tile_bounds(o, d, tile, apex="primary")
    want = pl.cull_plain(prep, cfg.cull_maxv, 2, ab, apex=True,
                         groups=groups, rays=(o, d, tile))
    calls = []

    def fake(prep_, maxv, wb, ab_, excl, apex, apex_rev, hourglass, widen,
             groups_, rays, live, origins):
        calls.append((wb, maxv, apex, apex_rev, hourglass, widen, groups_,
                      rays[2], live, origins))
        return pl.cull_plain(prep_, maxv, wb, ab_, excl, apex, apex_rev,
                             hourglass, widen, groups_, rays, live, origins)

    plans, plains = _plans(), _plans(twin=True)
    with table.using({"plan": fake}):
        got = pl.cull(prep, cfg.cull_maxv, 2, ab, apex=True, groups=groups,
                      rays=(o, d, tile))
    assert (_plans(), _plans(twin=True)) == (plans, plains)
    assert calls == [(2, cfg.cull_maxv, True, False, False, True, groups,
                      tile, None, None)]
    assert torch.equal(got, want)


def test_plain_route_counts_on_cpu(scene):
    """CPU tensors take the plain planner: a fused frame builds its two
    plans there and launches none."""
    prep, cfg = scene
    light = torch.tensor(P.BENCH_LIGHT)
    counts = _plans(), metrics.counts().get("plan.cull_cuda.launches", 0)
    plains = _plans(twin=True)
    cs = _cam_spec(None)
    ab = pl.tile_bounds_plain(pl.camera_plain(prep, cs), cs,
                              (SIZE // TPX) ** 2)
    pl.cull(prep, cfg.cull_maxv, 2, ab, apex=True)
    assert _plans(twin=True) == plains + 1
    sr.render(prep, cfg, light)
    assert _plans(twin=True) == plains + 3
    assert (_plans(),
            metrics.counts().get("plan.cull_cuda.launches", 0)) == counts


def partition_model(visible_b, tlo_b, wb: int, maxv: int, plan_w: int):
    """csrc/plan.cu's row build in numpy: each window's least bound, the
    row's columns, the buckets' floors and their ranks among the distinct
    bound16 values, a count and offset per rank, then each visible window's
    place = its rank's offset + the visible windows of its rank before it."""
    vis_b, tlo_b = visible_b.numpy(), tlo_b.numpy().astype(np.float32)
    n, nb = vis_b.shape
    npw = nb // wb
    mv_cap = plan_w - pl.PLAN_AUX
    maxv = min(maxv, mv_cap)
    k_emit = min(mv_cap, npw)
    out = np.zeros((n, plan_w), np.int32)
    f32 = np.float32
    for i in range(n):
        tw = np.where(vis_b[i], tlo_b[i], np.inf).astype(f32)
        tw = tw.reshape(npw, wb).min(axis=1)
        vis = np.nonzero(tw < np.inf)[0]
        cnt = len(vis)
        first, last = (vis[0], vis[-1]) if cnt else (npw, -1)
        rc = max(last - first + 1, 0)
        out[i, :pl.PLAN_AUX] = [first if rc else 0, rc, min(cnt, maxv),
                                cnt <= maxv, 0, 0, 0, 0]
        tmin = tw[vis].min() if cnt else f32(0.0)
        tmax = tw[vis].max() if cnt else f32(-np.inf)
        qscale = f32(max(f32(tmax - tmin), f32(1e-20)) / f32(pl.T_BUCKETS))
        b16, rank = [], []
        for q in range(pl.T_BUCKETS):
            floor = max(f32(tmin + f32(f32(q) * qscale)), f32(0.0))
            b16.append(int(np.array(floor, f32).view(np.int32)) >> 16)
            rank.append(rank[-1] + (b16[-1] != b16[-2]) if q else 0)
        qb = np.clip(((tw[vis] - tmin) / qscale).astype(np.int32), 0,
                     pl.T_BUCKETS - 1)
        counts = np.bincount([rank[q] for q in qb],
                             minlength=pl.T_BUCKETS)
        off = np.concatenate([[0], np.cumsum(counts)[:-1]])
        run = np.zeros(pl.T_BUCKETS, np.int64)
        row = out[i, pl.PLAN_AUX:]
        row[cnt:k_emit] = INT32_MAX
        for w, q in zip(vis, qb):
            pos = off[rank[q]] + run[rank[q]]
            run[rank[q]] += 1
            if pos < k_emit:
                row[pos] = (b16[q] << 16) | w
    return out


def _random_tables(seed: int, n: int, nb: int):
    """Block visibility and bounds with ties, empty tiles, every block of a
    tile at one bound (tmax == tmin), bounds one ulp apart, and tiles past
    the list capacity."""
    rng = np.random.default_rng(seed)
    vis = rng.random((n, nb)) < rng.uniform(0.05, 0.9, (n, 1))
    vis[0] = False                                        # empty tile
    vis[1] = True                                         # every window
    levels = np.float32([0.0, 0.5, 1.0, 1.0, 3.25, 40.0, 1e-30, 2.5e4])
    tlo = rng.choice(levels, (n, nb)).astype(np.float32)
    tlo[2] = 7.0                                          # tmax == tmin
    tlo[3] = np.float32(1000.0) + rng.integers(0, 4, nb).astype(np.float32) \
        * np.float32(6.1e-5)                              # bound16 ties
    tlo[4] = rng.uniform(0, 1e3, nb).astype(np.float32)
    return torch.from_numpy(vis), torch.from_numpy(tlo)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("wb,plan_w,maxv", [(2, 24, 8), (2, 48, 248),
                                            (4, 16, 4), (1, 72, 30)])
def test_partition_model_equals_sort(seed, wb, plan_w, maxv):
    vis, tlo = _random_tables(seed, 12, 60)
    want = pl.cull_lists(vis, tlo, wb, maxv, plan_w).numpy()
    got = partition_model(vis, tlo, wb, maxv, plan_w)
    np.testing.assert_array_equal(got, want)
    assert (want[3, pl.PLAN_AUX:pl.PLAN_AUX + 4] >> 16 ==
            want[3, pl.PLAN_AUX] >> 16).all()              # ties present


def _matmul_dot(c, u):
    return c @ u


@pytest.mark.parametrize("view", list(VIEWS))
def test_written_out_dots_keep_the_plans(scene, monkeypatch, view):
    """The plain planner's projective tests sum c.w, c.s and c.v left to
    right (csrc/plan.cu's order); the plans equal the matmul's: the primary
    plan, the hard-shadow plan from the bounds rows, and the ray plans."""
    prep, cfg = scene
    light = torch.tensor(P.BENCH_LIGHT)
    cs = _cam_spec(VIEWS[view])
    n = (SIZE // TPX) ** 2
    t, idx, obj, _rgb, bounds = nearest.hits_shaded(prep, cfg, light, cs,
                                                    cfg.cull_maxv)
    frame = pl.shadow_frame(prep.block_min, prep.block_max, light)
    sab = pl.analytic_shadow_bounds_exact(bounds, light, frame)
    excl = torch.where(bounds[:, 7] == bounds[:, 8],
                       torch.round(bounds[:, 7]).to(torch.int32), -2)
    o, d, _, _ = primary_rays_tiled(SIZE, SIZE, TPX, FOCAL,
                                            view_matrix=cs[0])
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    hit = torch.isfinite(t)
    p = o + torch.where(hit, t, 0.0)[:, None] * d
    plans = {
        "primary": lambda: pl.cull(prep, cfg.cull_maxv, 2,
                                   pl.tile_bounds_plain(
                                       pl.camera_plain(prep, cs), cs, n),
                                   apex=True),
        "shadow": lambda: pl.cull(prep, cfg.cull_maxv, 4, sab, excl=excl,
                                  apex_rev=True),
        "rays": lambda: pl.cull_rays(prep, o, d, TPX * TPX, cfg.cull_maxv,
                                     2),
        "occl": lambda: pl.cull_occl(prep, p, light - p, TPX * TPX,
                                     cfg.cull_maxv, 4, excl, apex_rev=True),
    }
    ours = {k: f() for k, f in plans.items()}
    monkeypatch.setattr(pl, "_dot", _matmul_dot)
    for k, f in plans.items():
        assert torch.equal(ours[k], f()), k
    assert (ours["primary"][:, 2] > 0).any()
    assert (ours["shadow"][:, 2] > 0).any()

