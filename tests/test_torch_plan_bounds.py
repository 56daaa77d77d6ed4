"""PyTorch port: the planners' bounds (kernels/plan.py::camera, tile_bounds,
shadow_bounds; csrc/plan.cu's camera_kernel, tile_bounds_kernel and
shadow_bounds_kernel).

On the CPU: the plain twins against the JAX package's make_cam,
analytic_tile_bounds, shadow_frame and analytic_shadow_bounds_exact at the
bars of tests/test_torch_plan.py, the primary and hard-shadow plans built
from them equal to JAX's word for word, the halvings of ``sum_rows``, and
the routes of the three roles of kernels/table.py.

Marked ``cuda`` (they skip without a card): on the four benchmark cells'
frames and a 1080p frame of 32-pixel tiles, the kernels' bounds and camera
rows equal to the twins' bit for bit (yaw views and lights; tiles with
``tile_bad``; hitless, pure and mixed shadow tiles), every plan built from
them equal to ``cull_plain``'s, the frames equal on every pixel to those of
the planner as it was (bounds in PyTorch, the corner sum by ``x.sum(0)``,
dot products by matmul), and the launches and registry counts of a frame
with no host read.  The JAX package is imported only inside the CPU tests,
so the card runs this file with

    python -m pytest --noconftest -m cuda tests/test_torch_plan_bounds.py
"""

import math
import types

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import anyhit, nearest, table
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.ops.intersect import cross
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics

BOUNDS_ROLES = ("camera", "tile_bounds", "shadow_bounds")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- on the CPU: the twins against the JAX package ------------------------

@pytest.fixture(scope="module")
def parity():
    """The parity scene in both packages, its views and the JAX modules."""
    import jax.numpy as jnp
    from simple_raytracer_tpu.accel.prepared import prepare as jprepare
    from simple_raytracer_tpu.kernels import tiled_t

    import _torch_parity as tp
    sm, jsm = tp.managers()
    cfg, jcfg = tp.configs()
    return types.SimpleNamespace(
        prep=prepare(sm.build(), cfg, device="cpu"),
        jprep=jprepare(jsm.build(), jcfg), cfg=cfg, jnp=jnp,
        tiled_t=tiled_t, tp=tp,
        views={"identity": None, "moved": tp.VIEW})


# (view, tile_px, focal): the parity frame, its moved view, 32-pixel tiles,
# and a field of view so wide that corners leave the frame's cone
CPU_CASES = [("identity", 64, None), ("moved", 64, None),
             ("moved", 32, None), ("identity", 32, 3.0)]


def _specs(p, view, tpx, focal):
    vm = p.views[view]
    focal = focal or p.tp.FOCAL
    w, h = p.tp.WIDTH, p.tp.HEIGHT
    cs = (None if vm is None else torch.from_numpy(vm), focal, w, h, tpx)
    jcs = (None if vm is None else p.jnp.asarray(vm), focal, w, h, tpx)
    return cs, jcs, -(-w // tpx) * -(-h // tpx)


@pytest.mark.parametrize("view,tpx,focal", CPU_CASES)
def test_tile_bounds_match_jax(parity, view, tpx, focal):
    """The twin's bounds (corner sum by halvings, written-out dot products)
    at test_torch_plan.py's bars; ``tile_bad`` equal."""
    cs, jcs, n = _specs(parity, view, tpx, focal)
    cam = pl.camera(parity.prep, cs)
    ours = pl.tile_bounds(cam, cs, n)
    theirs = parity.tiled_t.analytic_tile_bounds(jcs, n)
    for k in ("omin", "omax", "dmin", "dmax", "s", "v", "w", "apex",
              "ru_lo", "ru_hi", "rv_lo", "rv_hi", "dw_hi"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.array_equal(ours["tile_bad"].numpy(),
                          np.asarray(theirs["tile_bad"]))
    assert bool(ours["tile_bad"].any()) == (focal is not None)


@pytest.mark.parametrize("view,tpx,focal", CPU_CASES)
def test_primary_plan_matches_jax(parity, view, tpx, focal):
    """The frame's primary plan (nearest.primary_plan: the twin's bounds,
    the origins in columns 4/5) equals JAX's on every word."""
    cs, jcs, n = _specs(parity, view, tpx, focal)
    cfg = parity.cfg
    ours = nearest.primary_plan(parity.prep, cfg, cs, cfg.cull_maxv,
                                cam=pl.camera(parity.prep, cs))
    tt = parity.tiled_t
    theirs = tt.cull(parity.jprep, None, None, tpx * tpx, cfg.cull_maxv,
                     apex=True, ab=tt.analytic_tile_bounds(jcs, n))
    _, txy = tt.make_cam(jcs[0], jcs[1], jcs[2], jcs[3], tpx, n,
                         -(-jcs[2] // tpx), tpx * tpx)
    theirs = theirs.at[:, 4].set(txy[:, 0]).at[:, 5].set(txy[:, 1])
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert (ours[:, 2] > 0).any()


@pytest.mark.parametrize("light", [None, "bench", (-40.0, -90.0, 30.0)])
def test_camera_matches_jax(parity, light):
    """The camera row: make_cam's, and the shadow frame of JAX's
    shadow_frame at test_torch_plan.py's bar (zeros without a light)."""
    L = None if light is None else (parity.tp.LIGHT if light == "bench"
                                    else light)
    vm = parity.views["moved"]
    cs = (torch.from_numpy(vm), 400.0, 128, 128, 64)
    cam = pl.camera(parity.prep, cs, L)
    want = pl.make_cam(cs[0], 400.0, (0.0, 0.0, 0.0) if L is None else L,
                       None)
    assert torch.equal(cam[:15], want[:15])
    if L is None:
        assert torch.equal(cam[15:], torch.zeros(9))
        return
    theirs = parity.tiled_t.shadow_frame(parity.jprep, parity.jnp.asarray(L))
    for i, b in enumerate(theirs):
        np.testing.assert_allclose(cam[15 + 3 * i:18 + 3 * i].numpy(),
                                   np.asarray(b), rtol=1e-6, atol=1e-7)
    s, v, w = (cam[15:18], cam[18:21], cam[21:24])
    gram = torch.stack([s, v, w]) @ torch.stack([s, v, w]).T
    assert torch.allclose(gram, torch.eye(3), atol=1e-6)


def test_shadow_bounds_match_jax(parity):
    """The hard-shadow bounds of random rows (hitless, pure, mixed and
    not sign-definite tiles) against JAX's, with ``live`` and ``excl``."""
    p = parity
    L = p.tp.LIGHT
    cam = pl.camera(p.prep, (None, 400.0, 128, 128, 64), L)
    rng = np.random.default_rng(5)
    b = rng.normal(size=(8, 15)).astype(np.float32)
    b[:, 6] = [1, 1, 0, 1, 1, 0, 1, 1]
    b[:, 7] = [0, 1, 2, 1, 0, 1, 2, 0]
    b[:, 8] = [0, 2, 2, 1, 1, 1, 2, 0]
    b[:, 13] = [0.5, -2.0, 1.0, -0.5, 3.0, 1.0, 0.0, 1e-13]
    b[:, 14] = b[:, 13] + 1.0
    ours = pl.shadow_bounds(torch.from_numpy(b), cam)
    frame = tuple(p.jnp.asarray(cam[i:i + 3].numpy()) for i in (15, 18, 21))
    theirs = p.tiled_t.analytic_shadow_bounds_exact(p.jnp.asarray(b),
                                                    p.jnp.asarray(L), frame)
    for k in ("omin", "omax", "dmin", "dmax", "s", "v", "w", "apex",
              "ru_lo", "ru_hi", "rv_lo", "rv_hi"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6, err_msg=k)
    assert ours["live"].tolist() == [True, True, False, True, True, False,
                                     True, True]
    assert ours["excl"].tolist() == [0, -2, -2, 1, -2, -2, 2, 0]


@pytest.mark.parametrize("view", ["identity", "moved"])
def test_shadow_plan_matches_jax(parity, view):
    """The hard-shadow plan K2 walks (anyhit_from_t: the bounds of K1's
    rows, zero rows for hitless tiles, the origins) equals the plan JAX's
    anyhit_from_t builds from the same rows, on every word."""
    p = parity
    cfg = p.cfg
    cs, jcs, n = _specs(p, view, 64, None)
    light = torch.tensor(p.tp.LIGHT)
    cam = pl.camera(p.prep, cs, light)
    t, _i, obj, _rgb, bounds = nearest.hits_shaded(p.prep, cfg, light, cs,
                                                   cfg.cull_maxv, cam=cam)
    caught = []
    with table.using({"anyhit_from_t": table.spy("anyhit_from_t", caught)}):
        anyhit.anyhit_from_t(p.prep, cfg, t, obj, bounds, cam, cs,
                             cfg.cull_maxv)
    ours = caught[0][0]
    tt, jnp = p.tiled_t, p.jnp
    jb = jnp.asarray(bounds.numpy())
    ah = jb[:, 6] > 0.0
    pure = ah & (jb[:, 7] == jb[:, 8])
    excl = jnp.where(pure, jnp.round(jb[:, 7]).astype(jnp.int32), -2)
    jl = jnp.asarray(p.tp.LIGHT)
    ab = tt.analytic_shadow_bounds_exact(jb, jl, tt.shadow_frame(p.jprep, jl))
    tile = 64 * 64
    theirs = tt.cull(p.jprep, None, None, tile, cfg.cull_maxv, excl,
                     wb=cfg.kernel.window_blocks_ah, apex_rev=True, ab=ab)
    theirs = jnp.where(ah[:, None], theirs, 0)
    _, txy = tt.make_cam(jcs[0], jcs[1], jcs[2], jcs[3], 64, n, 2, tile)
    theirs = theirs.at[:, 4].set(txy[:, 0]).at[:, 5].set(txy[:, 1])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert (ours[:, 2] > 0).any()


@pytest.mark.parametrize("rows", [1, 2, 3, 7, 8, 1000, 4099])
def test_sum_rows_halvings(rows):
    """sum_rows adds the second half of the rows to the first, an odd last
    row carried, until one row is left (csrc/plan.cu's order)."""
    g = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, 3, generator=g)

    def halvings(y):
        while y.shape[0] > 1:
            h = y.shape[0] // 2
            top = [y[i] + y[h + i] for i in range(h)]
            y = torch.stack(top + ([y[2 * h]] if y.shape[0] % 2 else []))
        return y[0]
    got = pl.sum_rows(x)
    assert torch.equal(got, halvings(x))
    assert torch.allclose(got.double(), x.double().sum(0), atol=1e-3)


def test_bounds_roles_route_by_device(parity):
    """The three roles take the twin for CPU tensors (counted under
    ``plan.<twin>.calls``), the kernel for CUDA tensors."""
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    for role in BOUNDS_ROLES:
        e = table.roles()[role]
        assert table.pick(role, torch.zeros(1)) is e.plain
        assert table.pick(role, on_card) is e.cuda
    metrics.reset_counts("plan.")
    cs = (None, 400.0, 128, 128, 64)
    cam = pl.camera(parity.prep, cs, parity.tp.LIGHT)
    pl.tile_bounds(cam, cs, 4)
    pl.shadow_bounds(torch.zeros(4, 15), cam)
    now = metrics.counts()
    assert [now.get(f"plan.{r}_plain.calls") for r in BOUNDS_ROLES] == \
        [1, 1, 1]
    assert not any(k.startswith(tuple(f"plan.{r}_cuda" for r in BOUNDS_ROLES))
                   for k in now)


# ---- on the card: the kernels against the twins --------------------------

LIGHT = (500.0, -300.0, -200.0)
PIVOT = (0.3, 0.2, 60.0)
# the benchmark's frames: scene, width, height, focal, light samples, arc,
# tile_px (0: the scene's own)
CELLS = {"shadow1080": ("sphere", 1920, 1080, 1080.0, 1, 25.0, 0),
         "bench1080": ("sphere", 1920, 1080, 6000.0, 1, 12.0, 0),
         "soft600": ("textured", 600, 400, 400.0, 16, 25.0, 0),
         "dense6.soft600": ("dense", 600, 400, 400.0, 16, 25.0, 0),
         "shadow1080.tile32": ("sphere", 1920, 1080, 1080.0, 1, 25.0, 32)}
# a second light for each frame
LIGHTS = (LIGHT, (-400.0, -500.0, 150.0))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


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


def cell_cfg(name: str, light=LIGHT):
    scene, w, h, focal, samples, _, tpx = CELLS[name]
    return sr.default_config().replace(
        mode="tiled", bvh=sr.BVHConfig(split="sah" if scene != "dense"
                                       else "median"),
        camera=sr.CameraConfig(width=w, height=h, focal=focal),
        light=sr.LightConfig(position=light, num_samples=samples),
        shading=sr.ShadingConfig(smooth_normals=scene == "textured"),
        tile_px=tpx)


@pytest.fixture(scope="module")
def scenes():
    _need_cuda()
    builds = {"sphere": (P.sphere_on_ground, "bench1080"),
              "textured": (P.textured_on_ground, "soft600"),
              "dense": (lambda m, _s: P.dense_textured_on_ground(m),
                        "dense6.soft600")}
    return {name: prepare(build(sr.SceneManager(), 6).build(),
                          cell_cfg(cell), device="cuda")
            for name, (build, cell) in builds.items()}


def _render(prep, name: str, deg: float, light=LIGHT):
    return sr.render(prep, cell_cfg(name, light),
                     torch.tensor(light, device="cuda"),
                     view_matrix=yaw_about(PIVOT, deg))


def _spied(prep, name: str, deg: float, light=LIGHT) -> dict:
    """The arguments of every call of the bounds roles and of ``plan`` in
    one frame of the cell, by role."""
    stores = {r: [] for r in BOUNDS_ROLES + ("plan",)}
    calls = []
    real = pl.cull

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    with table.using({r: table.spy(r, stores[r]) for r in BOUNDS_ROLES}), \
            pytest.MonkeyPatch.context() as m:
        m.setattr(pl, "cull", spy)
        _render(prep, name, deg, light)
    stores["plan"] = calls
    return stores


def _equal(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            assert torch.equal(got[k], want[k]), (what, k)
    else:
        assert torch.equal(got, want), what


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_bounds_equal_twin(scenes, name):
    """On the cell's frame at the arc's ends and middle, under two lights:
    the camera rows, the primary bounds and the hard-shadow bounds of the
    kernels equal the twins' bit for bit; the shadow frames of
    ``shadow1080`` hold hitless, pure and mixed tiles (``bench1080``'s
    view holds the mesh alone: no mixed tile)."""
    prep = scenes[CELLS[name][0]]
    amp = CELLS[name][5]
    kinds = {"hitless": 0, "pure": 0, "mixed": 0}
    for light in LIGHTS:
        for deg in (-amp, 0.0, amp):
            st = _spied(prep, name, deg, light)
            assert len(st["camera"]) == 1 and len(st["tile_bounds"]) == 1
            for role in BOUNDS_ROLES:
                e = table.roles()[role]
                for a in st[role]:
                    _equal(e.cuda(*a), e.plain(*a), (name, deg, role))
            for rows, _cam in st["shadow_bounds"]:
                live = rows[:, 6] > 0
                pure = live & (rows[:, 7] == rows[:, 8])
                kinds["hitless"] += int((~live).sum())
                kinds["pure"] += int(pure.sum())
                kinds["mixed"] += int((live & ~pure).sum())
    if name.startswith("shadow1080"):
        assert all(kinds.values()), kinds
    elif name == "bench1080":
        assert kinds["hitless"] and kinds["pure"], kinds


@pytest.mark.cuda
@pytest.mark.parametrize("tpx", [64, 32])
def test_tile_bad_bounds_equal_twin(scenes, tpx):
    """A field of view so wide that some tiles' corners leave the cone
    (``tile_bad``), at 1080p: the kernel's bounds equal the twin's, at 32-
    pixel tiles past the shared-memory rows of the corner sum."""
    prep = scenes["sphere"]
    for deg, focal in ((0.0, 3.0), (20.0, 1.5), (-35.0, 1080.0)):
        cs = (torch.tensor(yaw_about(PIVOT, deg), device="cuda"), focal,
              1920, 1080, tpx)
        n = -(-1920 // tpx) * -(-1080 // tpx)
        cam = pl.camera_cuda(prep, cs, LIGHT)
        _equal(cam, pl.camera_plain(prep, cs, LIGHT), (deg, "camera"))
        got, want = pl.tile_bounds_cuda(cam, cs, n), pl.tile_bounds_plain(
            cam, cs, n)
        _equal(got, want, (deg, focal, tpx))
        assert bool(want["tile_bad"].any()) == (focal < 10.0)
        assert (4 * n > pl.SUM_SMEM_ROWS) == (tpx == 32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_cell_plans_equal_plain(scenes, name):
    """Every plan of the cell's frame, built from the kernels' bounds,
    equals ``cull_plain``'s on every word; the bounds and the plans are
    built with no host read."""
    prep = scenes[CELLS[name][0]]
    amp = CELLS[name][5]
    for deg in (-amp, amp):
        st = _spied(prep, name, deg)
        assert len(st["plan"]) == 2
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = {r: [table.roles()[r].cuda(*a) for a in st[r]]
                    for r in BOUNDS_ROLES}
            got = [pl.cull(*a, **k) for a, k in st["plan"]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(len(outs[r]) == len(st[r]) for r in BOUNDS_ROLES)
        for g, (a, k) in zip(got, st["plan"]):
            want = pl.cull_plain(*a, **k)
            assert torch.equal(g, want), (name, deg, k.get("apex"))


def _old_frame_of(w):
    """plan.frame_of as the planner had it: (w*w).sum(), the constant
    copied to the card."""
    nw = torch.sqrt((w * w).sum())
    w = torch.where(nw > 1e-20, w / nw.clamp_min(1e-20),
                    torch.tensor([0.0, 0.0, 1.0], dtype=w.dtype,
                                 device=w.device))
    e = (torch.arange(3, device=w.device) == torch.argmin(w.abs())).to(w.dtype)
    s = torch.stack(cross((w[0], w[1], w[2]), (e[0], e[1], e[2])))
    s = s / torch.sqrt((s * s).sum())
    v = torch.stack(cross((w[0], w[1], w[2]), (s[0], s[1], s[2])))
    return s, v, w


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_cell_frames_equal_parent_planner(scenes, monkeypatch, name):
    """The frames on every pixel equal those of the planner as it was:
    the bounds and the plans in PyTorch, the corner directions summed by
    x.sum(0), dot products by matmul."""
    prep = scenes[CELLS[name][0]]
    amp = CELLS[name][5]
    plains = {r: table.roles()[r].plain for r in BOUNDS_ROLES + ("plan",)}
    for deg in (-amp, amp):
        img = _render(prep, name, deg)
        with monkeypatch.context() as m, table.using(plains):
            m.setattr(pl, "_dot", lambda c, u: c @ u)
            m.setattr(pl, "sum_rows", lambda x: x.sum(0))
            m.setattr(pl, "frame_of", _old_frame_of)
            ref = _render(prep, name, deg)
        assert torch.equal(img, ref), (name, deg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_frame_counts(scenes, name):
    """A frame's registry: the camera row and the primary bounds on the
    card once each, the hard-shadow bounds once in the 1080p cells and
    never in the soft ones, no twin; a launch each, and the planner's own
    launches as before (2 a plan with an apex test, 1 without)."""
    prep = scenes[CELLS[name][0]]
    hard = CELLS[name][4] == 1
    _render(prep, name, 0.0)
    metrics.reset_counts("plan.")
    _render(prep, name, CELLS[name][5])
    now = metrics.counts()
    want = {"camera": 1, "tile_bounds": 1, "shadow_bounds": int(hard)}
    for role, k in want.items():
        assert now.get(f"plan.{role}_cuda.calls", 0) == k, (role, now)
        assert now.get(f"plan.{role}_cuda.launches", 0) == k, (role, now)
        assert now.get(f"plan.{role}_plain.calls", 0) == 0, (role, now)
    assert (now["plan.cull_cuda.plans"], now["plan.cull_cuda.launches"],
            now.get("plan.cull_plain.plans", 0)) == (2, 4 if hard else 3, 0)
    assert table.launches()["tile_bounds"] >= 1
