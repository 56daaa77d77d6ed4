"""PyTorch port on the GPU: the CUDA planner (csrc/plan.cu) against the plain
planner (kernels/plan.py::cull_plain), bit for bit.

Every test here needs a CUDA device and nvcc, and skips without them.  The
file imports neither JAX nor the JAX package; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_plan_cuda.py

Cases: the plans of the benchmark's three frames (the analytic primary plan
with the apex test, the hard-shadow plan with ``excl`` and the light-apex
test, the soft frame's folded interval plan with ``excl``), page plans,
the base of a grouped plan, a dense scene past 1,500 windows, synthetic
tables with the edge rows (no visible window, more than ``maxv``, bound16
ties, one bound for a whole tile, past the shared-memory windows), the
frames against the planner as it was (matmul dot products, every plan
plain), the launch counters, and no host read.
"""

import math
import types

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import paged, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics

pytestmark = pytest.mark.cuda

LIGHT = (500.0, -300.0, -200.0)
PIVOT = (0.3, 0.2, 60.0)
# the benchmark's frames: scene, width, height, focal, light samples, arc
CELLS = {"shadow1080": ("sphere", 1920, 1080, 1080.0, 1, 25.0),
         "bench1080": ("sphere", 1920, 1080, 6000.0, 1, 12.0),
         "soft600": ("textured", 600, 400, 400.0, 16, 25.0)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _cuda():
    _need_cuda()


def yaw_about(pivot, degrees: float) -> np.ndarray:
    """The origin camera turned by ``degrees`` about the vertical axis
    through ``pivot`` (the benchmark's views)."""
    c = np.asarray(pivot, np.float64)
    a = math.radians(degrees)
    R = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                  [-math.sin(a), 0.0, math.cos(a)]])
    V = np.eye(4)
    V[:3, :3] = R
    V[:3, 3] = c - R @ c
    return V.astype(np.float32)


def cell_cfg(name: str):
    scene, w, h, focal, samples, _ = CELLS[name]
    return sr.default_config().replace(
        mode="tiled", bvh=sr.BVHConfig(split="sah"),
        camera=sr.CameraConfig(width=w, height=h, focal=focal),
        light=sr.LightConfig(position=LIGHT, num_samples=samples),
        shading=sr.ShadingConfig(smooth_normals=scene == "textured"))


@pytest.fixture(scope="module")
def scenes():
    _need_cuda()
    out = {}
    for name, build in (("sphere", P.sphere_on_ground),
                        ("textured", P.textured_on_ground)):
        cfg = cell_cfg("soft600" if name == "textured" else "bench1080")
        out[name] = prepare(build(sr.SceneManager(), 6).build(), cfg,
                            device="cuda")
    return out


def _plain_planner():
    """Every plan plain (kernels/table.py's ``plan`` role)."""
    return table.using({"plan": pl.cull_plain})


def _both(fn, monkeypatch):
    """fn() on the CUDA route, then on the plain route."""
    got = fn()
    with _plain_planner():
        want = fn()
    return got, want


def _render(prep, name: str, deg: float):
    light = torch.tensor(LIGHT, device="cuda")
    return sr.render(prep, cell_cfg(name), light,
                     view_matrix=yaw_about(PIVOT, deg))


def _frame_culls(prep, name: str, deg: float, monkeypatch):
    """The arguments of every ``cull`` of one frame of the cell."""
    calls = []
    real = pl.cull

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    with monkeypatch.context() as m:
        m.setattr(pl, "cull", spy)
        _render(prep, name, deg)
    return calls


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_plans_equal_plain(scenes, monkeypatch, name):
    """Each plan of the cell's frame, at the arc's two ends and its middle:
    the kernel's equals the plain planner's on every word, and builds
    without a host read.  Printed: the words in which the plain planner
    with the matmul dot products it had before (cuBLAS's order on the
    card) differs from the written-out sums, by plan."""
    prep = scenes[CELLS[name][0]]
    amp = CELLS[name][5]
    listed = 0
    matmul_words = {}
    for deg in (-amp, 0.0, amp):
        calls = _frame_culls(prep, name, deg, monkeypatch)
        assert len(calls) == 2
        for a, k in calls:
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = pl.cull(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = pl.cull_plain(*a, **k)
            assert got.shape == want.shape
            assert torch.equal(got, want), (name, deg, k)
            listed += int((want[:, 2] > 0).sum())
            with monkeypatch.context() as m:
                m.setattr(pl, "_dot", lambda c, u: c @ u)
                old = pl.cull_plain(*a, **k)
            what = ("primary" if k.get("apex") else "shadow"
                    if k.get("apex_rev") else "fold")
            key = f"{what} {deg:+g}"
            matmul_words[key] = (int((old != want).sum()), want.numel())
    print(f"matmul planner vs written-out sums ({name}): "
          f"{matmul_words} (words differing, words)")
    assert listed > 0


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_frames_equal_parent_planner(scenes, monkeypatch, name):
    """The frames on every pixel equal those of the planner as it was, and
    each frame builds its two plans on the card, in two launches a plan
    with an apex test and one without, and none plain."""
    prep = scenes[CELLS[name][0]]
    amp = CELLS[name][5]
    launches = 3 if name == "soft600" else 4
    for deg in (-amp, amp):
        metrics.reset_counts("plan.")
        img = _render(prep, name, deg)
        plans = table.calls()["plan"], table.calls(twin=True)["plan"]
        assert (plans[0], metrics.counts().get("plan.cull_cuda.launches"),
                plans[1]) == (2, launches, 0)
        # the planner as it was: every plan plain, dot products by matmul
        with monkeypatch.context() as m, _plain_planner():
            m.setattr(pl, "_dot", lambda c, u: c @ u)
            ref = _render(prep, name, deg)
        assert torch.equal(img, ref), (name, deg)


def _primary_rays(width, height, tpx, focal, deg=10.0):
    vm = torch.tensor(yaw_about(PIVOT, deg), device="cuda")
    o, d, _, _ = primary_rays_tiled(width, height, tpx, focal,
                                    view_matrix=vm, device="cuda")
    return o.reshape(-1, 3), d.reshape(-1, 3)


def test_page_plans_equal_plain(scenes, monkeypatch):
    """Page plans (``widen=False``): the primary plan with the apex test,
    the hard-shadow plan with ``excl`` and the light-apex test."""
    prep = scenes["sphere"]
    cfg = cell_cfg("shadow1080")
    tile = 64 * 64
    o, d = _primary_rays(1920, 1080, 64, 1080.0)
    got, want = _both(lambda: paged.cull(prep, cfg, o, d, tile,
                                         cfg.cull_maxv, apex=True),
                      monkeypatch)
    assert torch.equal(got, want) and (want[:, 2] > 0).any()
    p = o + 60.0 * d / d[:, 2:3]
    light = torch.tensor(LIGHT, device="cuda")
    n = o.shape[0] // tile
    excl = torch.arange(n, device="cuda", dtype=torch.int32) % 3 - 1
    got, want = _both(lambda: paged.cull_occl(prep, cfg, p, light - p, tile,
                                              cfg.cull_maxv, excl,
                                              apex_rev=True), monkeypatch)
    assert torch.equal(got, want) and (want[:, 2] > 0).any()


def test_grouped_base_plan_equals_plain(scenes, monkeypatch):
    """The base of a grouped plan, with its mask words after it."""
    prep = scenes["sphere"]
    cfg = cell_cfg("shadow1080")
    o, d = _primary_rays(1920, 1080, 64, 1080.0)
    for groups in (2, 4):
        got, want = _both(lambda: pl.cull_rays(prep, o, d, 64 * 64,
                                               cfg.cull_maxv, 2,
                                               groups=groups), monkeypatch)
        assert torch.equal(got, want), groups
        assert (want[:, 2] > 0).any()


def test_dense_scene_plans_equal_plain(monkeypatch):
    """A scene past 1,500 windows: the wide plan (PLAN_W_BIG) and its wide
    list capacity, the primary and the hard-shadow plans."""
    cfg = cell_cfg("shadow1080").replace(
        camera=sr.CameraConfig(width=600, height=400, focal=400.0))
    prep = prepare(P.dense_on_ground(sr.SceneManager()).build(), cfg,
                   device="cuda")
    wb = cfg.kernel.window_blocks
    assert prep.num_blocks // wb > 1500
    tpx = pl.effective_tile_px(cfg, prep.num_triangles)
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks, wb)
    n = -(-600 // tpx) * -(-400 // tpx)
    cs = (None, 400.0, 600, 400, tpx)
    ab = pl.tile_bounds_plain(pl.camera_plain(prep, cs), cs, n)
    got, want = _both(lambda: pl.cull(prep, maxv, wb, ab, apex=True),
                      monkeypatch)
    assert want.shape[1] >= pl.PLAN_W_BIG
    assert torch.equal(got, want) and (want[:, 2] > 0).any()
    o, d = _primary_rays(600, 400, tpx, 400.0, 0.0)
    p = o + 60.0 * d / d[:, 2:3]
    light = torch.tensor(LIGHT, device="cuda")
    got, want = _both(lambda: pl.cull_occl(prep, p, light - p, tpx * tpx,
                                           maxv, cfg.kernel.window_blocks_ah,
                                           apex_rev=True), monkeypatch)
    assert torch.equal(got, want)


def _synthetic(seed: int, nb: int, n: int = 48, tile: int = 64):
    """Block tables off the z axis, with a far cluster and a wall at one
    depth beside it, blocks behind the apex and empty (inverted) blocks;
    tile rays of three kinds: primary cones, shadow rays to one light, and
    free rays with zero direction components.  With an apex test tile 0
    sees nothing, tile 1 the cluster alone (bound16 ties across buckets),
    tile 2 the wall alone (one bound for the tile); the others cones of the
    random blocks.  (The interval test alone lets an axis of zero direction
    span every block: there tile 0 sees most of them.)"""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)
    side = torch.where(u(nb) < 0.5, -1.0, 1.0)
    ctr = torch.stack([side * u(nb, lo=2, hi=14), u(nb, lo=-8, hi=8),
                       u(nb, lo=4, hi=60)], 1)
    half = u(nb, 3, lo=0.05, hi=1.0)
    k = nb // 8
    ctr[:k] = torch.tensor([0.5, 0.5, 1000.0]) + u(k, 3, hi=0.01)  # cluster
    half[:k] = torch.tensor([0.02, 0.02, 0.001])
    ctr[k:2 * k] = torch.stack([u(k, lo=-0.5, hi=0.5),              # wall
                                torch.full((k,), 3.5),
                                30.0 + half[k:2 * k, 2]], 1)
    ctr[2 * k:2 * k + 8, 2] = -5.0                                    # behind
    bmin, bmax = ctr - half, ctr + half
    bmin[-4:], bmax[-4:] = bmax[-4:].clone(), bmin[-4:].clone()       # empty
    prep = types.SimpleNamespace(
        device=torch.device("cuda"), num_blocks=nb, block_min=bmin.cuda(),
        block_max=bmax.cuda(),
        block_obj=(torch.arange(nb) // max(nb // 4, 1)).to(torch.int32)
        .cuda())
    aim = torch.stack([u(n, lo=-0.3, hi=0.3), u(n, lo=-0.2, hi=0.2),
                       torch.ones(n)], 1)
    aim[0] = torch.tensor([0.0, 1.0, 0.0])                           # none
    aim[1] = torch.tensor([0.0005, 0.0005, 1.0])                     # cluster
    aim[2] = torch.tensor([0.0, 3.5 / 30.0, 1.0])                    # wall
    spread = u(n, 1, 1, lo=0.0, hi=0.05)
    spread[:3] = 0.0
    d = aim[:, None, :] + spread * u(n, tile, 3, lo=-1.0, hi=1.0)
    d[3:6, :, 0] = 0.0                                 # zero-width intervals
    d[6:9, :, 1] = torch.where(torch.arange(tile) % 2 == 0, 0.0, 0.2)
    d = d.reshape(-1, 3)
    p = torch.stack([u(n * tile, lo=-10, hi=10), u(n * tile, lo=-6, hi=6),
                     u(n * tile, lo=5, hi=50)], 1)
    p[:tile] = torch.tensor([0.0, 0.0, 2.0])
    p[tile:3 * tile] = 0.0
    rays = {"primary": (torch.zeros(n * tile, 3), d),
            "light": (p, torch.tensor(LIGHT) - p),
            None: (p, d * u(n * tile, 1, lo=0.5, hi=2.0))}
    return prep, {k: (o.cuda(), dd.cuda()) for k, (o, dd) in rays.items()}


@pytest.mark.parametrize("nb,wb,maxv", [(600, 2, 248), (600, 4, 6),
                                        (4000, 2, 1000),
                                        (24000, 2, 1000)])
@pytest.mark.parametrize("apex", ["primary", "light", None])
@pytest.mark.parametrize("excl", [False, True])
def test_synthetic_plans_equal_plain(monkeypatch, nb, wb, maxv, apex, excl):
    """Edge rows on synthetic tables: tiles with no visible window, more
    than ``maxv`` (range mode), bound16 ties across buckets and one bound
    for the whole tile; past 1,500 windows the wide plan, past the
    shared-memory windows (plan.SMEM_WINDOWS) the scratch rows."""
    prep, rays = _synthetic(nb + wb, nb)
    o, d = rays[apex]
    tile = 64
    ab = pl.ray_tile_bounds(o, d, tile, apex=apex)
    n = ab["dmin"].shape[0]
    i = torch.arange(n, dtype=torch.int32, device=o.device)
    ex = torch.where(i < 3, -1, i % 5 - 1) if excl else None   # -1: no drop
    got, want = _both(lambda: pl.cull(
        prep, maxv, wb, ab, excl=ex, apex=apex == "primary",
        apex_rev=apex == "light"), monkeypatch)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    rows = want.cpu()
    if apex is not None:
        assert (rows[0, :4] == torch.tensor([0, 0, 0, 1])).all()  # none seen
    if apex == "primary" and rows[1, 3] == 1:
        b16 = rows[1, pl.PLAN_AUX:pl.PLAN_AUX + int(rows[1, 2])] >> 16
        assert rows[1, 2] >= pl.T_BUCKETS and b16.unique().numel() <= 2
    if apex == "primary" and rows[2, 3] == 1:
        b16 = rows[2, pl.PLAN_AUX:pl.PLAN_AUX + int(rows[2, 2])] >> 16
        assert rows[2, 2] >= 2 and (b16 == b16[0]).all()   # one bound
    if maxv < 50:
        assert (rows[:, 3] == 0).any()                     # range rows
    if nb // wb > pl.SMEM_WINDOWS:
        assert want.shape[1] == pl.PLAN_W_BIG


def test_launch_counts_and_no_host_read(scenes):
    """Each kernel plan counts one plan; the apex plan launches two kernels
    and the interval plan one, with no synchronising host read."""
    prep = scenes["sphere"]
    cfg = cell_cfg("bench1080")
    cs = (None, 6000.0, 1920, 1080, 64)
    ab = pl.tile_bounds_plain(pl.camera_plain(prep, cs), cs, 510)
    metrics.reset_counts("plan.")
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = pl.cull(prep, cfg.cull_maxv, 2, ab, apex=True)
        occl = pl.cull(prep, cfg.cull_maxv, 4, ab)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (table.calls()["plan"],
            metrics.counts()["plan.cull_cuda.launches"]) == (2, 3)
    assert plan.shape == (510, pl.PLAN_W) and occl.shape == (510, pl.PLAN_W)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pl.cull(prep, cfg.cull_maxv, 2, ab, apex=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("plan_blocks_kernel" in x for x in names) == 1
    assert sum("plan_tiles_kernel" in x for x in names) == 1
