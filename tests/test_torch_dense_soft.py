"""PyTorch port: the dense soft-shadow frame and the hourglass planner.

Scenes over 131,072 triangles plan their many-point shadow folds (S > 1,
no shared light) with the hourglass test (kernels/plan.py::
visibility_hourglass); on the card csrc/plan.cu's ``plan_hourglass_kernel``
builds those plans.  On the CPU: the route, the operand words the kernel
reads (the endpoint box), the wiring of the flag, and a small
``dense_textured_on_ground`` at 16 light samples in the dense regime
(``plan.DENSE_TRIS`` lowered) through ``render``, equal to the benchmark's
plain reference (rtbench/reference/render.py).  On the card (marked
``cuda``, skipped here): every plan of the full-size frame's views and of
seeded random bounds, the kernel's against ``cull_plain``'s on every word.
Imports neither JAX nor the JAX package; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_dense_soft.py
"""

import math
import types

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import plan as pl, table
from simple_raytracer_tpu_torch.utils import metrics
from rtbench import traffic as tr
from rtbench.reference.render import Frame, Reference
from rtbench.scenes import port
from rtbench.scenes.dense_textured_on_ground import dense_textured_on_ground

LIGHT = (500.0, -300.0, -200.0)
PIVOT = (0.3, 0.2, 60.0)
S = 16
# the benchmark's dense soft frame (dense6.soft600) and the arc's two ends
FULL = (600, 400, 400.0)
YAWS = (-25.0, 0.0, 25.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_cfg(width: int, height: int, focal: float):
    """The cell's program configuration: the tiled mode, the default
    median BVH, flat shading, 16 light samples."""
    return sr.default_config().replace(
        mode="tiled", bvh=sr.BVHConfig(split="median"),
        camera=sr.CameraConfig(width=width, height=height, focal=focal),
        light=sr.LightConfig(position=LIGHT, num_samples=S))


def _counts(key: str) -> int:
    return metrics.counts().get(key, 0)


def _plans(twin: bool = False) -> int:
    """The plans csrc/plan.cu (``twin``: the plain planner) built so far."""
    return table.calls(twin)["plan"]


def spy_culls(monkeypatch):
    """Record the arguments of every ``plan.cull``."""
    calls = []
    real = pl.cull

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    monkeypatch.setattr(pl, "cull", spy)
    return calls


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_sends_hourglass_list_plans_to_the_kernel(device):
    """Hourglass list plans on a CUDA device take the kernel, as interval
    ones do; CPU tensors, range-only plans (past 65,536 windows) and plans
    without list capacity stay plain (kernels/table.py's ``plan`` role)."""
    for maxv, windows, listed in ((248, 1282, True), (1000, 2561, True),
                                  (1000, 65536, True), (0, 1282, False),
                                  (-1, 1282, False), (248, 65537, False)):
        for hourglass in (False, True):
            want = (pl.cull_cuda if device == "cuda" and listed
                    else pl.cull_plain)
            prep = types.SimpleNamespace(device=torch.device(device),
                                         num_blocks=windows)
            got = table.pick("plan", prep, maxv, 1, None, None, False,
                             False, hourglass)
            assert got is want, (device, maxv, windows, hourglass)


def _words(words, name):
    i = 3 * pl.CUDA_OPERANDS.index(name)
    return words[i:i + 3]


@pytest.mark.parametrize("hourglass", [False, True])
def test_operand_words_carry_the_endpoint_box(hourglass):
    """The kernel reads the origin box and, for the hourglass test, the
    endpoint box q = o + d (for the interval test the direction box) in
    place: pointer and element strides, a stride of 0 for an expanded
    view; the other box reads as zeros."""
    g = torch.Generator().manual_seed(3)
    o, d = torch.rand(256, 3, generator=g), torch.rand(256, 3, generator=g)
    ab = pl.ray_tile_bounds(o, d, 64, hourglass=hourglass)
    ab["omin"] = ab["omin"][:1].expand(4, 3)
    excl = torch.tensor([0, -2, 1, -2], dtype=torch.int32)
    words = pl.cuda_operands(ab, 4, torch.device("cpu"), excl,
                             hourglass=hourglass)
    assert len(words) == 3 * len(pl.CUDA_OPERANDS)
    assert _words(words, "omin") == [ab["omin"].data_ptr(), 0, 1]
    assert _words(words, "omax") == [ab["omax"].data_ptr(), 3, 1]
    used, unused = ((("qmin", "qmax"), ("dmin", "dmax")) if hourglass
                    else (("dmin", "dmax"), ("qmin", "qmax")))
    for name in used:
        assert _words(words, name) == [ab[name].data_ptr(), 3, 1]
    for name in unused + ("ru_lo", "s", "apex", "tile_bad"):
        assert _words(words, name) == [0, 0, 0]
    assert _words(words, "excl")[1:] == [1, 1]
    if hourglass:
        assert torch.equal(ab["qmin"], (o + d).reshape(4, 64, 3).amin(1))
        bad = dict(ab, qmax=ab["qmax"][:3])
        with pytest.raises(ValueError, match="qmax"):
            pl.cuda_operands(bad, 4, torch.device("cpu"), hourglass=True)


def _small_dense(monkeypatch, width=120, height=80, focal=80.0):
    """dense_textured_on_ground(2) (652 triangles) in the dense regime:
    ``plan.DENSE_TRIS`` lowered under its triangle count."""
    monkeypatch.setattr(pl, "DENSE_TRIS", 512)
    scene = dense_textured_on_ground(2)
    cfg = frame_cfg(width, height, focal)
    return scene, cfg, prepare(port.to_port(scene), cfg, device="cpu")


def test_the_hourglass_flag_reaches_the_kernel(monkeypatch):
    """On the CUDA route the fold's plan goes to ``cull_cuda`` with the
    hourglass flag and the endpoint box; a stand-in kernel (the plain
    plan) shows the wiring on the CPU, and the frame is unchanged."""
    scene, cfg, prep = _small_dense(monkeypatch)
    view = tr.yaw_about(PIVOT, 10.0)
    want = sr.render(prep, cfg, LIGHT, view_matrix=view)
    seen = []

    def fake(prep_, maxv, wb, ab, excl, apex, apex_rev, hourglass, *rest):
        seen.append((hourglass, apex, apex_rev, excl is not None,
                     "qmin" in ab))
        return pl.cull_plain(prep_, maxv, wb, ab, excl, apex, apex_rev,
                             hourglass, *rest)
    with table.using({"plan": fake}):
        got = sr.render(prep, cfg, LIGHT, view_matrix=view)
    assert torch.equal(got, want)
    assert sorted(seen) == [(False, True, False, False, False),
                            (True, False, False, True, True)]


@pytest.mark.parametrize("yaw", [-21.0, 0.0, 17.0])
def test_dense_soft_frame_equals_the_reference(monkeypatch, yaw):
    """The small dense scene at 16 light samples through ``render`` (32-
    pixel tiles, the fold planned by the hourglass test, plain on the
    CPU) equals the plain reference within one level on every pixel, and
    its soft shadows are in view."""
    scene, cfg, prep = _small_dense(monkeypatch)
    assert pl.hourglass_for(prep)
    assert pl.effective_tile_px(cfg, prep.scene.num_triangles) == 32
    calls = spy_culls(monkeypatch)
    plains = _plans(twin=True)
    cards = _plans(), _counts("plan.cull_cuda.hourglass_plans")
    view = tr.yaw_about(PIVOT, yaw)
    img = sr.render(prep, cfg, LIGHT, view_matrix=view).numpy()
    W, H, f = cfg.camera.width, cfg.camera.height, cfg.camera.focal
    px = np.arange(W * H)
    ref = Reference(scene)
    want = ref.pixels(Frame(W, H, f, view, LIGHT, S), px)
    diff = np.abs(img.reshape(-1, 3).astype(int) - want.astype(int))
    assert diff.max() <= 1, int(diff.max())
    lit = ref.pixels(Frame(W, H, f, view, LIGHT, S, shadows=False), px)
    assert (lit != want).any(-1).sum() > 50
    assert [k.get("hourglass", False) for _, k in calls] == [False, True]
    assert _plans(twin=True) == plains + 2
    assert (_plans(), _counts("plan.cull_cuda.hourglass_plans")) == cards


# -- on the card ------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def dense_full():
    _need_cuda()
    cfg = frame_cfg(*FULL)
    return cfg, prepare(port.to_port(dense_textured_on_ground(6)), cfg,
                        device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("yaw", YAWS)
def test_dense_frame_plans_equal_plain(dense_full, monkeypatch, yaw):
    """Each plan of the full-size dense soft frame, at the arc's two ends
    and its middle: the kernel's equals the plain planner's on every word,
    built with no host read; the frame builds its two plans on the card,
    one of them by the hourglass kernel, and none plain."""
    cfg, prep = dense_full
    light = torch.tensor(LIGHT, device="cuda")
    view = tr.yaw_about(PIVOT, yaw)
    with monkeypatch.context() as m:
        calls = spy_culls(m)
        sr.render(prep, cfg, light, view_matrix=view)
    assert [k.get("hourglass", False) for _, k in calls] == [False, True]
    for a, k in calls:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = pl.cull(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = pl.cull_plain(*a, **k)
        assert got.shape == want.shape
        assert torch.equal(got, want), (yaw, k)
        assert (want[:, 2] > 0).any()
    metrics.reset_counts("plan.")
    img = sr.render(prep, cfg, light, view_matrix=view)
    assert (_plans(), _counts("plan.cull_cuda.hourglass_plans"),
            _counts("plan.cull_cuda.launches"), _plans(twin=True)) == \
        (2, 1, 3, 0)
    with table.using({"plan": pl.cull_plain}):
        ref = sr.render(prep, cfg, light, view_matrix=view)
    assert torch.equal(img, ref), yaw


def _random_hourglass_bounds(seed: int, n: int, nb: int):
    """Block tables and hourglass tile bounds on a grid of quarter units,
    so that thresholds fall on ties: blocks with faces on the tiles' box
    faces, thin and empty (inverted) blocks, blocks past the endpoint box
    (t >= 1, as occluders beyond the light) and between the two boxes
    (t in [0, 1]); tiles with a point box
    (degenerate), with the endpoint box equal to the origin box on an axis
    (slope 0: the parallel test) and with either box on one plane."""
    g = np.random.default_rng(seed)
    q = lambda *shape: np.round(g.uniform(-16, 16, shape) * 4) / 4
    lo = q(nb, 3)
    hi = lo + np.round(g.uniform(0, 3, (nb, 3)) * 4) / 4
    hi[: nb // 16, 0] = lo[: nb // 16, 0]                     # thin
    lo[-4:], hi[-4:] = hi[-4:] + 1.0, lo[-4:]                  # empty
    omin = q(n, 3)
    omax = omin + np.round(g.uniform(0, 2, (n, 3)) * 4) / 4
    qmin = q(n, 3)
    qmax = qmin + np.round(g.uniform(0, 2, (n, 3)) * 4) / 4
    omax[0] = omin[0]                                         # a point
    qmin[1:5, 1], qmax[1:5, 1] = omin[1:5, 1], omax[1:5, 1]   # slope 0
    qmin[5:8] = omin[5:8]                                     # all axes
    qmax[5:8] = omax[5:8]
    qmin[8:10, 2] = qmax[8:10, 2] = omin[8:10, 2]              # one plane
    k = nb // 8                           # faces on tile 10's box faces
    lo[:k, 0], hi[k:2 * k, 1] = omax[10, 0], omin[10, 1]
    lo[2 * k:3 * k] = qmax[11] + 0.25 * g.integers(0, 8, (k, 3))  # past q
    hi[2 * k:3 * k] = lo[2 * k:3 * k] + 0.5
    t = np.round(g.uniform(0, 1, (k, 1)) * 8) / 8        # between the boxes
    lo[3 * k:4 * k] = (1 - t) * omin[12] + t * qmin[12] - 0.25
    hi[3 * k:4 * k] = lo[3 * k:4 * k] + 0.5
    f = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")
    ab = {"omin": f(omin), "omax": f(omax), "qmin": f(qmin), "qmax": f(qmax)}
    return f(lo), f(hi), ab


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nb,wb,maxv", [(600, 2, 248), (600, 4, 6),
                                        (5124, 4, 1000), (24000, 2, 1000)])
@pytest.mark.parametrize("excl", [False, True])
def test_random_hourglass_plans_equal_plain(monkeypatch, seed, nb, wb, maxv,
                                            excl):
    """Seeded random bounds (see :func:`_random_hourglass_bounds`): the
    kernel's hourglass plans equal ``cull_plain``'s on every word, with and
    without ``excl``, in lists and range rows, past 1,500 windows the wide
    plan and past the shared-memory windows (plan.SMEM_WINDOWS) the
    scratch rows."""
    _need_cuda()
    n = 48
    lo, hi, ab = _random_hourglass_bounds(seed, n, nb)
    prep = types.SimpleNamespace(
        device=torch.device("cuda"), num_blocks=nb, block_min=lo,
        block_max=hi,
        block_obj=(torch.arange(nb, device="cuda") // max(nb // 4, 1))
        .to(torch.int32))
    i = torch.arange(n, dtype=torch.int32, device="cuda")
    ex = torch.where(i < 3, -2, i % 5 - 1) if excl else None
    metrics.reset_counts("plan.")
    got = pl.cull(prep, maxv, wb, ab, excl=ex, hourglass=True)
    assert _counts("plan.cull_cuda.hourglass_plans") == 1
    with table.using({"plan": pl.cull_plain}):
        want = pl.cull(prep, maxv, wb, ab, excl=ex, hourglass=True)
    assert got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())
    rows = want.cpu()
    assert (rows[:, 2] > 0).any() and (rows[:, 1] < nb // wb).any()
    if maxv < 50:
        assert (rows[:, 3] == 0).any()                   # range rows
    if nb // wb > pl.SMEM_WINDOWS:
        assert want.shape[1] == pl.PLAN_W_BIG


@pytest.mark.cuda
@pytest.mark.parametrize("apex", [None, "light"])
def test_ray_hourglass_plans_equal_plain(monkeypatch, apex):
    """Hourglass plans of shadow rays from points to 16 light samples (the
    fold's rays, points on both sides of the light's plane) with the
    light-apex test or none, through ``cull_occl``."""
    _need_cuda()
    g = torch.Generator().manual_seed(7)
    nb = 4096
    ctr = torch.rand(nb, 3, generator=g) * 40.0 - 20.0
    half = torch.rand(nb, 3, generator=g) * 0.6
    prep = types.SimpleNamespace(
        device=torch.device("cuda"), num_blocks=nb,
        block_min=(ctr - half).cuda(),
        block_max=(ctr + half).cuda(),
        block_obj=(torch.arange(nb) // 1024).to(torch.int32).cuda())
    p = (torch.rand(64 * 1024, 3, generator=g) * 30.0 - 15.0).cuda()
    light = torch.tensor([2.0, -3.0, 1.0], device="cuda")
    d = light + 3.0 * torch.randint(0, 3, (p.shape[0], 1), generator=g
                                    ).cuda() - p
    excl = (torch.arange(64, device="cuda") % 5 - 1).to(torch.int32)
    got = pl.cull_occl(prep, p, d, 1024, 1000, 4, excl,
                       apex_rev=apex == "light", hourglass=True)
    with table.using({"plan": pl.cull_plain}):
        want = pl.cull_occl(prep, p, d, 1024, 1000, 4, excl,
                            apex_rev=apex == "light", hourglass=True)
    assert torch.equal(got, want), int((got != want).sum())
    assert (want[:, 2] > 0).any()


@pytest.mark.cuda
def test_hourglass_launch_count_and_kernel_name(dense_full):
    """An hourglass plan is one launch of ``plan_hourglass_kernel`` and
    counts one hourglass plan."""
    cfg, prep = dense_full
    g = torch.Generator().manual_seed(5)
    o = (torch.rand(3750 * 64, 3, generator=g) * 20.0 + 40.0).cuda()
    d = torch.tensor(LIGHT, device="cuda") - o
    ab = pl.ray_tile_bounds(o, d, 1024, hourglass=True)
    metrics.reset_counts("plan.")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pl.cull(prep, 1000, 4, ab, hourglass=True)
        torch.cuda.synchronize()
    assert (_plans(), _counts("plan.cull_cuda.hourglass_plans"),
            _counts("plan.cull_cuda.launches")) == (1, 1, 1)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("plan_hourglass_kernel" in x for x in names) == 1
    assert not any("plan_tiles_kernel" in x for x in names)
    assert math.isfinite(float(ab["qmin"].sum()))
