"""PyTorch port on the GPU: each CUDA kernel vs its plain PyTorch version.

Every test here needs a CUDA device and nvcc, and skips without them.  The
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed; there, run it without the JAX-loading conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import (anyhit, build, nearest, paged,
                                                prepass, table)
from simple_raytracer_tpu_torch.kernels import plan as pl
from simple_raytracer_tpu_torch.kernels.tiled import render_flat_tiled
from simple_raytracer_tpu_torch.ops.camera import (primary_rays_tiled,
                                                   tile_ray_dirs)
from simple_raytracer_tpu_torch.probes import attr, fixed
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.scene import transforms as T
from simple_raytracer_tpu_torch.utils import metrics

from _torch_cases import (SELF_SKIP, coincident_pages, grouped_stress,
                          k1_stress, k2_stress, k3_stress, masked_occluder,
                          masked_windows, ragged_rays, self_skip, two_pages,
                          two_windows)

pytestmark = pytest.mark.cuda

SIZE, FOCAL, TPX = 128, 400.0, 64
# the walks' roles of kernels/table.py (the frames' kernels but the
# planner's and the shading's)
WALKS = ("nearest_shaded", "nearest_attrs", "nearest_rays",
         "nearest_rays_attrs", "nearest_grouped", "prepass", "anyhit_from_t",
         "anyhit", "anyhit_grouped", "nearest_pages", "anyhit_pages")
VIEWS = {"identity": None,
         "moved": T.view_matrix((-8.0, -6.0, 15.0),
                                (math.radians(12.0), math.radians(-6.0), 0.0))}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _cuda():
    _need_cuda()


@pytest.fixture(scope="module")
def scene():
    _need_cuda()
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                             focal=FOCAL),
        bvh=sr.BVHConfig(split="sah"))
    prep = prepare(P.sphere_on_ground(sr.SceneManager(), 3).build(), cfg,
                   device="cuda")
    return prep, cfg


def _launches(role: str) -> int:
    """The launches ``role``'s CUDA wrapper has counted so far."""
    return table.launches()[role]


def _mode_launches() -> dict:
    """K1's launches counted so far by attribute mode."""
    now = metrics.counts("nearest.tiled_nearest_shaded.mode_launches.")
    return {m: now.get(f"nearest.tiled_nearest_shaded.mode_launches.{m}", 0)
            for m in nearest.MODES}


def _walk_launches() -> dict:
    """The launches each walk's CUDA wrapper has counted so far, by role."""
    return {r: n for r, n in table.launches().items() if r in WALKS}


def _frame_args(prep, cfg, view, tpx=TPX):
    """The arguments the frame hands each kernel, by role
    (kernels/table.py)."""
    stores = {k: [] for k in WALKS}
    vm = None if view is None else torch.tensor(view, device="cuda")
    light = torch.tensor(P.BENCH_LIGHT, device="cuda")
    o, d, _, _ = primary_rays_tiled(SIZE, SIZE, tpx, FOCAL, view_matrix=vm,
                                    device="cuda")
    with table.using({k: table.spy(k, stores[k]) for k in WALKS}):
        render_flat_tiled(prep, cfg, light, (vm, FOCAL, SIZE, SIZE, tpx),
                          rays=(o.reshape(-1, 3), d.reshape(-1, 3)))
    return {k: s[0] for k, s in stores.items() if s}


def _kernel_args(prep, cfg, view):
    args = _frame_args(prep, cfg, view)
    return args["nearest_shaded"], args["anyhit_from_t"]


def test_kernels_build():
    info = build.build()
    assert len(info["paths"]) == len(build.SOURCES)
    assert all(p.endswith(".so") for p in info["paths"])
    lib = build.library()
    for name in ("srt_nearest_k1", "srt_k1_shape", "srt_nearest_rays",
                 "srt_nearest_rays_shape", "srt_anyhit_from_t",
                 "srt_anyhit_from_t_shape", "srt_anyhit_rays",
                 "srt_anyhit_rays_shape", "srt_prepass",
                 "srt_prepass_shape",
                 "srt_fixed_probe", "srt_attr_gather", "srt_attr_window"):
        assert hasattr(lib, name)


@pytest.mark.parametrize("view", list(VIEWS))
def test_nearest_kernel_matches_plain(scene, view):
    prep, cfg = scene
    k1, _ = _kernel_args(prep, cfg, VIEWS[view])
    n0 = _launches("nearest_shaded")
    kt, ki, ko, krgb, kb = table.run("nearest_shaded", *k1)
    assert _launches("nearest_shaded") == n0 + 1
    pt, pi, po, prgb, pb = nearest.tiled_nearest_shaded_plain(*k1)
    hit = torch.isfinite(pt)
    assert hit.sum() > 4000
    assert torch.equal(torch.isfinite(kt), hit)
    torch.testing.assert_close(kt[hit], pt[hit], rtol=1e-5, atol=1e-6)
    same = ki == pi
    assert same.float().mean() >= 0.9999
    assert torch.equal(ko[same], po[same])
    flat = same.reshape(-1)
    torch.testing.assert_close(krgb[flat], prgb[flat], rtol=0, atol=1e-4)
    fin = torch.isfinite(pb)
    assert torch.equal(torch.isfinite(kb), fin)
    torch.testing.assert_close(kb[fin], pb[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("view", list(VIEWS))
def test_anyhit_kernel_matches_plain(scene, view):
    prep, cfg = scene
    _, k2 = _kernel_args(prep, cfg, VIEWS[view])
    n0 = _launches("anyhit_from_t")
    kf = table.run("anyhit_from_t", *k2)
    assert _launches("anyhit_from_t") == n0 + 1
    pf = anyhit.tiled_anyhit_from_t_plain(*k2)
    hit = torch.isfinite(k2[3])
    assert (kf[hit] == pf[hit]).float().mean() >= 0.9999
    assert (kf & hit).sum() > 50
    assert kf[~hit].all()


@pytest.mark.parametrize("bound", [0.0, 1.0])
def test_nearest_kernel_trusts_the_entry_bound(bound):
    """Two windows covering the tile, the nearer one second: a lying bound
    (1.0 > t of the first hit) stops the walk after window 0."""
    tensors, rest = two_windows(bound)
    t, idx, obj, _, _ = nearest.tiled_nearest_shaded(
        *[x.cuda() for x in tensors], *rest)
    want = 0 if bound else 64
    assert (idx == want).all() and (obj == int(want > 0)).all()


@pytest.mark.parametrize("window, obj, want", SELF_SKIP)
def test_anyhit_kernel_self_object_skip(window, obj, want):
    tensors, rest = self_skip(window, obj)
    found = anyhit.tiled_anyhit_from_t(*[x.cuda() for x in tensors], *rest)
    assert found[0, :16].all()
    assert (found[0, 16:] == want).all()


def test_render_launches_both_kernels(scene):
    prep, cfg = scene
    n0 = _launches("nearest_shaded")
    a0 = _launches("anyhit_from_t")
    img = sr.render(prep, cfg, P.BENCH_LIGHT)
    assert img.is_cuda and img.shape == (SIZE, SIZE, 3)
    assert _launches("nearest_shaded") == n0 + 1
    assert _launches("anyhit_from_t") == a0 + 1
    cpu = sr.render(prep.to("cpu"), cfg, P.BENCH_LIGHT)
    diff = (img.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean() >= 0.999


@pytest.mark.parametrize("view", list(VIEWS))
def test_nearest_attrs_kernel_matches_plain(scene, view):
    """K1's fetch mode, on the soft-shadow frame's arguments."""
    prep, cfg = scene
    soft = cfg.replace(light=sr.LightConfig(num_samples=4))
    args = _frame_args(prep, soft, VIEWS[view])["nearest_attrs"]
    n0 = _launches("nearest_attrs")
    kt, ki, ka = table.run("nearest_attrs", *args)
    assert _launches("nearest_attrs") == n0 + 1
    pt, pi, pa = nearest.tiled_nearest_attrs_plain(*args)
    hit = torch.isfinite(pt)
    assert hit.sum() > 4000 and torch.equal(torch.isfinite(kt), hit)
    torch.testing.assert_close(kt[hit], pt[hit], rtol=1e-5, atol=1e-6)
    same = (ki == pi).reshape(-1)
    assert same.float().mean() >= 0.9999
    torch.testing.assert_close(ka[same], pa[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("frame", ["soft", "legacy"])
def test_anyhit_rays_kernel_matches_plain(scene, frame):
    """K2′ on the arguments of the soft (S = 4, M = 1024) and the legacy
    (256-ray shadow tiles) frames."""
    prep, cfg = scene
    if frame == "soft":
        cfg, tpx = cfg.replace(light=sr.LightConfig(num_samples=4)), TPX
    else:
        cfg, tpx = cfg.replace(tile_px=32, shadow_tile=256), 32
    args = _frame_args(prep, cfg, VIEWS["moved"], tpx)["anyhit"]
    n0 = _launches("anyhit")
    kf = table.run("anyhit", *args)
    assert _launches("anyhit") == n0 + 1
    pf = anyhit.tiled_anyhit_plain(*args)
    assert (kf == pf).float().mean() >= 0.9999
    assert kf.sum() > 50


def test_anyhit_rays_kernel_ragged_tile():
    """M = 1023 rays per tile: the kernel masks its tail lanes."""
    tensors, rest, want = ragged_rays()
    for no_max_t in (True, False):
        found = anyhit.tiled_anyhit(*[x.cuda() for x in tensors], *rest,
                                    no_max_t)
        assert torch.equal(found.cpu(), want[no_max_t])
        assert torch.equal(found, anyhit.tiled_anyhit_plain(
            *[x.cuda() for x in tensors], *rest, no_max_t))


def test_wrappers_reject_bad_inputs(scene):
    prep, cfg = scene
    k1, k2 = _kernel_args(prep, cfg, None)
    with pytest.raises(ValueError):
        nearest.tiled_nearest_shaded(k1[0].float(), *k1[1:])
    with pytest.raises(ValueError):
        anyhit.tiled_anyhit_from_t(k2[0], k2[1].cpu(), *k2[2:])
    tensors, rest, _ = ragged_rays()
    tensors = [x.cuda() for x in tensors]
    with pytest.raises(ValueError):              # o as [n * M, 3]
        anyhit.tiled_anyhit(*tensors[:3], tensors[3].reshape(-1, 3),
                            *tensors[4:], *rest)


@pytest.mark.parametrize("view", list(VIEWS))
def test_nearest_rays_kernel_matches_plain(scene, view):
    """K6 on the arguments of the paged frame (64x64 tiles of explicit
    rays, the primary page plan)."""
    prep, cfg = scene
    args = _frame_args(prep, cfg.replace(tiled_impl="paged"),
                       VIEWS[view])["nearest_pages"]
    n0 = _launches("nearest_pages")
    kt, ki = table.run("nearest_pages", *args)
    assert _launches("nearest_pages") == n0 + 1
    pt, pi = paged.tiled_nearest_plain(*args)
    hit = torch.isfinite(pt)
    assert hit.sum() > 4000 and torch.equal(torch.isfinite(kt), hit)
    torch.testing.assert_close(kt[hit], pt[hit], rtol=1e-5, atol=1e-6)
    assert (ki == pi).float().mean() >= 0.9999
    assert (ki[~hit] == -1).all()


@pytest.mark.parametrize("bound", [0.0, 1.0])
def test_nearest_rays_kernel_trusts_the_entry_bound(bound):
    """Two pages, the nearer one second: a lying bound stops K6 after
    page 0."""
    tensors, rest = two_pages(bound)
    t, idx = paged.tiled_nearest(*[x.cuda() for x in tensors], *rest)
    assert (idx == (0 if bound else 128)).all() and torch.isfinite(t).all()


def test_nearest_rays_kernel_ties_to_the_lowest_id():
    """Two coincident triangles in two pages, the higher id walked first:
    K6 keeps the lower id."""
    tensors, rest = coincident_pages()
    t, idx = paged.tiled_nearest(*[x.cuda() for x in tensors], *rest)
    assert (idx == 5).all()
    pt, _ = paged.tiled_nearest_plain(*[x.cuda() for x in tensors], *rest)
    assert torch.equal(t, pt)


@pytest.mark.parametrize("samples", [1, 4])
def test_anyhit_pages_kernel_matches_plain(scene, samples):
    """K7 on the paged frame's shadow: 4,096-ray tiles (8 rays a thread)
    for the hard shadow, 1,024 folded rays for S = 4."""
    prep, cfg = scene
    cfg = cfg.replace(tiled_impl="paged",
                      light=sr.LightConfig(num_samples=samples))
    args = _frame_args(prep, cfg, VIEWS["moved"])["anyhit_pages"]
    assert args[3].shape[1] == (4096 if samples == 1 else 1024)
    n0 = _launches("anyhit_pages")
    kf = table.run("anyhit_pages", *args)
    assert _launches("anyhit_pages") == n0 + 1
    pf = paged.tiled_anyhit_plain(*args)
    assert (kf == pf).float().mean() >= 0.9999
    assert kf.sum() > 50


def test_render_defaults_to_the_card():
    """A raw Scene given to ``render`` with no device is prepared on the
    card, and the paged frame launches K6 and K7 there."""
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                             focal=FOCAL),
        bvh=sr.BVHConfig(split="sah"), tiled_impl="paged")
    n0, a0 = _launches("nearest_pages"), _launches("anyhit_pages")
    img = sr.render(P.sphere_on_ground(sr.SceneManager(), 3).build(), cfg,
                    P.BENCH_LIGHT)
    assert img.is_cuda and img.shape == (SIZE, SIZE, 3)
    assert _launches("nearest_pages") == n0 + 1
    assert _launches("anyhit_pages") == a0 + 1


def _rays(view, tile):
    """The frame's primary rays in tiles of ``tile``: (o, d) [R, 3] and
    (o3, d3) [n, tile, 3]."""
    vm = None if view is None else torch.tensor(view, device="cuda")
    o, d, _, _ = primary_rays_tiled(SIZE, SIZE, TPX, FOCAL, view_matrix=vm,
                                    device="cuda")
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    return (o, d), (o.reshape(-1, tile, 3).contiguous(),
                    d.reshape(-1, tile, 3).contiguous())


@pytest.mark.parametrize("view", list(VIEWS))
def test_gather_nearest_kernel_matches_plain(scene, view):
    """K1's fetch mode, on the gather frame's arguments (textured soft
    frames take it; here the prepared scene with ``attr_fetch`` off)."""
    prep, cfg = scene
    gather = cfg.replace(kernel=sr.KernelConfig(attr_fetch=False))
    args = _frame_args(prep, gather, VIEWS[view])["nearest_attrs"]
    n0 = _launches("nearest_attrs")
    kt, ki, _ = table.run("nearest_attrs", *args)
    assert _launches("nearest_attrs") == n0 + 1
    pt, pi, _ = nearest.tiled_nearest_attrs_plain(*args)
    hit = torch.isfinite(pt)
    assert hit.sum() > 4000 and torch.equal(torch.isfinite(kt), hit)
    torch.testing.assert_close(kt[hit], pt[hit], rtol=1e-5, atol=1e-6)
    assert (ki == pi).float().mean() >= 0.9999


@pytest.mark.parametrize("view", list(VIEWS))
def test_prepass_kernel_matches_plain(scene, view):
    """K3's flags equal its plain version's on every plan position, and K1
    over the refined plan gives the unrefined walk's (t, idx) exactly."""
    prep, cfg = scene
    (o, d), (o3, d3) = _rays(VIEWS[view], TPX * TPX)
    plan = pl.cull_rays(prep, o, d, TPX * TPX, cfg.cull_maxv, 2)
    n0 = _launches("prepass")
    kf = table.run("prepass", plan, prep.gram, o3, d3, 64, cfg.mt_eps)
    assert _launches("prepass") == n0 + 1
    pf = prepass.tiled_prepass_plain(plan, prep.gram, o3, d3, 64, cfg.mt_eps)
    assert torch.equal(kf, pf) and kf.any()
    ref = prepass.refine_plan(plan, kf)
    t0, i0 = nearest.tiled_nearest_rays(plan, prep.tri, o3, d3, 64,
                                        cfg.mt_eps)
    t1, i1 = nearest.tiled_nearest_rays(ref, prep.tri, o3, d3, 64,
                                        cfg.mt_eps)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)
    pt, pi = nearest.tiled_nearest_rays_plain(ref, prep.tri, o3, d3, 64,
                                              cfg.mt_eps)
    hit = torch.isfinite(pt)
    torch.testing.assert_close(t1[hit], pt[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lanes", [32, 256, 1024])
def test_nearest_grouped_kernel_matches_plain(scene, lanes):
    """K4 with sub-groups of 32 lanes (tiles of 128 rays), of 256 and of
    1,024 (the 4,096-ray pixel tiles) against its plain version and
    against the ungrouped walk of the same entries."""
    prep, cfg = scene
    tile = 4 * lanes
    (o, d), (o3, d3) = _rays(VIEWS["moved"], tile)
    plan = pl.cull_rays(prep, o, d, tile, cfg.cull_maxv, 2, groups=4)
    n0 = _launches("nearest_grouped")
    kt, ki = table.run("nearest_grouped", plan, prep.tri, o3, d3, 64,
                                           cfg.mt_eps, 4)
    assert _launches("nearest_grouped") == n0 + 1
    pt, pi = nearest.tiled_nearest_grouped_plain(plan, prep.tri, o3, d3, 64,
                                                 cfg.mt_eps, 4)
    hit = torch.isfinite(pt)
    assert hit.sum() > 4000 and torch.equal(torch.isfinite(kt), hit)
    torch.testing.assert_close(kt[hit], pt[hit], rtol=1e-5, atol=1e-6)
    assert (ki == pi).float().mean() >= 0.9999
    flat = pl.cull_rays(prep, o, d, tile, cfg.cull_maxv, 2)
    ut, ui = nearest.tiled_nearest_rays(flat, prep.tri, o3, d3, 64,
                                        cfg.mt_eps)
    assert torch.equal(ut, kt) and torch.equal(ui, ki)


@pytest.mark.parametrize("lanes", [32, 256])
def test_anyhit_grouped_kernel_matches_plain(scene, lanes):
    """K5 with sub-groups of 32 lanes (the legacy shadow in 128-ray tiles)
    and of 256 (the soft frame's folded 1,024-ray tiles) against its plain
    version and the ungrouped walk."""
    prep, cfg = scene
    kc = sr.KernelConfig(groups_ah=4)
    if lanes == 256:
        cfg = cfg.replace(light=sr.LightConfig(num_samples=4), kernel=kc)
    else:                       # the legacy hard shadow in 128-ray tiles
        cfg = cfg.replace(shadow_tile=128, kernel=kc)
    args = _frame_args(prep, cfg, VIEWS["moved"])["anyhit_grouped"]
    assert args[3].shape[1] == 4 * lanes
    n0 = _launches("anyhit_grouped")
    kf = table.run("anyhit_grouped", *args)
    assert _launches("anyhit_grouped") == n0 + 1
    pf = anyhit.tiled_anyhit_grouped_plain(*args)
    assert (kf == pf).float().mean() >= 0.9999 and kf.sum() > 50
    flat = args[0][:, :pl.PLAN_AUX + (args[0].shape[1] - pl.PLAN_AUX) * 8 // 9]
    uf = anyhit.tiled_anyhit(flat.contiguous(), *args[1:10])
    assert torch.equal(uf, kf)


def test_nearest_grouped_kernel_honors_masks():
    """Window 1 (the nearer quad) is masked to sub-groups 0 and 2: the
    other groups must keep window 0's hit."""
    tensors, rest, want = masked_windows()
    t, idx = nearest.tiled_nearest_grouped(*[x.cuda() for x in tensors],
                                           *rest)
    assert torch.equal(idx.cpu(), want.to(torch.int32))
    pt, pi = nearest.tiled_nearest_grouped_plain(
        *[x.cuda() for x in tensors], *rest)
    assert torch.equal(pi, idx) and torch.equal(pt, t)


def test_anyhit_grouped_kernel_honors_masks():
    """The occluder's window is masked to sub-groups 0 and 2: only their
    rays find it."""
    tensors, rest, want = masked_occluder()
    found = anyhit.tiled_anyhit_grouped(*[x.cuda() for x in tensors], *rest)
    assert torch.equal(found.cpu(), want)


@pytest.fixture(scope="module")
def mode_scenes():
    """The scenes of K1's new modes, by mode: the textured parity scene
    (checker ground, flat shading) and the smooth-normal one."""
    _need_cuda()
    out = {}
    for mode, build in ((nearest.TEXTURED, P.textured_on_ground),
                        (nearest.SMOOTH, P.smooth_on_ground)):
        cfg = sr.default_config().replace(
            mode="tiled", camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                                 focal=FOCAL),
            bvh=sr.BVHConfig(split="sah"),
            shading=sr.ShadingConfig(smooth_normals=mode == nearest.SMOOTH))
        out[mode] = (prepare(build(sr.SceneManager(), 3).build(), cfg,
                             device="cuda"), cfg)
    return out


@pytest.mark.parametrize("tpx", [32, 64])
@pytest.mark.parametrize("mode", ["textured", "smooth"])
def test_nearest_kernel_modes_match_plain(mode_scenes, mode, tpx):
    """K1's textured and smooth modes on the fused frame's arguments, at
    32- and 64-pixel tiles."""
    m = nearest.TEXTURED if mode == "textured" else nearest.SMOOTH
    prep, cfg = mode_scenes[m]
    k1 = _frame_args(prep, cfg.replace(tile_px=tpx), VIEWS["moved"],
                     tpx)["nearest_shaded"]
    assert k1[5] == tpx and k1[10] == m
    n0, m0 = _launches("nearest_shaded"), _mode_launches()[m]
    kt, ki, ko, ks, kb = table.run("nearest_shaded", *k1)
    assert _launches("nearest_shaded") == n0 + 1
    assert _mode_launches()[m] == m0 + 1
    pt, pi, po, ps, pb = nearest.tiled_nearest_shaded_plain(*k1)
    assert ks.shape == ps.shape == (kt.numel(), nearest.shade_width(m))
    hit = torch.isfinite(pt)
    assert hit.sum() > 4000 and torch.equal(torch.isfinite(kt), hit)
    torch.testing.assert_close(kt[hit], pt[hit], rtol=1e-5, atol=1e-6)
    same = ki == pi
    assert same.float().mean() >= 0.9999
    assert torch.equal(ko[same], po[same])
    flat = same.reshape(-1)
    torch.testing.assert_close(ks[flat], ps[flat], rtol=0, atol=1e-4)
    if m == nearest.TEXTURED:
        assert torch.equal(ks[flat, 4:], ps[flat, 4:])   # obj, tex id
        assert (ks[flat & hit.reshape(-1), 5] >= 0).sum() > 1000
    fin = torch.isfinite(pb)
    assert torch.equal(torch.isfinite(kb), fin)
    torch.testing.assert_close(kb[fin], pb[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["textured", "smooth"])
def test_render_mode_frame_launches_its_kernels(mode_scenes, mode):
    """The one-sample textured and smooth-normal frames launch K1 once, in
    their mode, and K2 once; the image matches the plain versions' on the
    CPU."""
    m = nearest.TEXTURED if mode == "textured" else nearest.SMOOTH
    prep, cfg = mode_scenes[m]
    n0 = _walk_launches()
    m0 = _mode_launches()
    img = sr.render(prep, cfg, P.BENCH_LIGHT)
    dn = {k: v - n0[k] for k, v in _walk_launches().items()}
    assert dn == {k: int(k in ("nearest_shaded", "anyhit_from_t"))
                  for k in WALKS}
    assert {k: v - m0[k] for k, v in _mode_launches().items()} == \
        {k: int(k == m) for k in nearest.MODES}
    cpu = sr.render(prep.to("cpu"), cfg, P.BENCH_LIGHT)
    diff = (img.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean() >= 0.999


def test_render_gather_frame_launches_its_kernels():
    """The textured, smooth-normal soft frame takes the gather branch on
    the card: K1's fetch mode and K2′ launch, and the image matches the
    plain versions' on the CPU."""
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                             focal=FOCAL),
        bvh=sr.BVHConfig(split="sah"), light=sr.LightConfig(num_samples=4),
        shading=sr.ShadingConfig(smooth_normals=True))
    prep = prepare(P.textured_on_ground(sr.SceneManager(), 3).build(), cfg,
                   device="cuda")
    n0 = _launches("nearest_attrs")
    a0 = _launches("anyhit")
    img = sr.render(prep, cfg, P.BENCH_LIGHT)
    assert _launches("nearest_attrs") == n0 + 1
    assert _launches("anyhit") == a0 + 1
    cpu = sr.render(prep.to("cpu"), cfg, P.BENCH_LIGHT)
    diff = (img.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean() >= 0.999


SPAN_BRANCHES = {
    "fused": (P.sphere_on_ground, {}),
    "fused_textured": (P.textured_on_ground, {}),
    "soft": (P.sphere_on_ground, dict(light=sr.LightConfig(num_samples=4))),
    "gather": (P.sphere_on_ground,
               dict(kernel=sr.KernelConfig(groups=4, groups_ah=4))),
    "paged": (P.sphere_on_ground, dict(tiled_impl="paged")),
}


@pytest.mark.parametrize("branch", sorted(SPAN_BRANCHES))
def test_recording_spans_launches_nothing(branch):
    """A frame of each branch of the tiled path renders the same image on
    the card with the program's spans recording as without, and each
    counter of the registry moves alike, some of them above 0; the
    recorded walks' spans are there."""
    from simple_raytracer_tpu_torch.kernels.tiled import frame_branch
    build, extra = SPAN_BRANCHES[branch]
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                             focal=FOCAL), **extra)
    prep = prepare(build(sr.SceneManager(), 3).build(), cfg, device="cuda")
    assert frame_branch(prep, cfg, TPX * TPX) == branch.split("_")[0]
    sr.render(prep, cfg, P.BENCH_LIGHT)
    before = metrics.counts()
    off = sr.render(prep, cfg, P.BENCH_LIGHT)
    mid = metrics.counts()
    with metrics.recording() as rec:
        on = sr.render(prep, cfg, P.BENCH_LIGHT)
    after = metrics.counts()
    assert torch.equal(off, on)
    d_off = {k: mid[k] - before[k] for k in before}
    d_on = {k: after[k] - mid[k] for k in before}
    assert d_on == d_off
    assert sum(d_on.values()) > 0
    names = {s.name for s in rec.spans}
    assert {"srt.frame", "srt.k1", "srt.anyhit"} <= names


@pytest.mark.parametrize("tpx", [64, 32])
@pytest.mark.parametrize("variant", fixed.VARIANTS)
def test_fixed_probe_kernel_matches_plain(variant, tpx):
    """Each fixed-cost probe on a ragged 200x136 frame (padded tiles, image
    stores cropped) equals its plain version exactly, t and idx, and
    counts its launch."""
    inputs = fixed.frame_inputs(200, 136, tpx, FOCAL, "cuda")
    inputs["a"] = 3e-6
    key = f"fixed.fixed_probe.launches.{variant}"
    n0 = metrics.counts().get(key, 0)
    t, idx = fixed.fixed_probe(variant, **inputs)
    pt, pidx = fixed.fixed_probe_plain(variant, **inputs)
    torch.cuda.synchronize()
    assert metrics.counts()[key] == n0 + 1
    assert t.shape == pt.shape and torch.equal(t, pt)
    assert (idx is None) == (pidx is None)
    if idx is not None:
        assert torch.equal(idx, pidx)


def test_attr_kernels_match_plain():
    """attr_gather and attr_window at small shapes equal their plain
    versions exactly and count their launches."""
    bid, at = attr.gather_inputs(6, "cuda")
    bid[0, :5] = -1
    g0, w0 = _launches("attr_gather"), _launches("attr_window")
    assert torch.equal(table.run("attr_gather", bid, at),
                       attr.attr_gather_plain(bid, at))
    starts, wbid, wat = attr.window_inputs(5, 10, 512, 64, "cuda")
    out = table.run("attr_window", starts, wbid, wat)
    assert torch.equal(out, attr.attr_window_plain(starts, wbid, wat))
    assert bool((out != 0).any())
    assert _launches("attr_gather") == g0 + 1
    assert _launches("attr_window") == w0 + 1


def test_probe_wrappers_reject_bad_inputs():
    inputs = fixed.frame_inputs(128, 64, 64, FOCAL, "cuda")
    with pytest.raises(ValueError, match="unknown probe variant"):
        fixed.fixed_probe("win", **inputs)
    with pytest.raises(ValueError):                  # a frame of 3 tiles
        fixed.fixed_probe("io", **{**inputs, "width": 192})
    with pytest.raises(ValueError):
        fixed.fixed_probe("io", **{**inputs, "origins": inputs["origins"]
                                   .float()})
    bid, at = attr.gather_inputs(2, "cuda")
    with pytest.raises(ValueError):
        attr.attr_gather(bid, at[:, :8].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        attr.attr_gather(bid, at.reshape(-1)[1:1 + at.numel() - 16]
                         .reshape(-1, 16))
    starts, wbid, wat = attr.window_inputs(2, 4, 256, 64, "cuda")
    with pytest.raises(ValueError):
        attr.attr_window(starts, wbid, wat.float())


def _k1_mode_args(scene, mode_scenes, mode: str, tpx: int, view="moved"):
    """K1's arguments on the frame of ``mode``'s scene at ``tpx``-pixel
    tiles: the fused frame's (flat, textured, smooth), or the flat frame's
    cut to the fetch mode's (plan, tri, tri_attr, cam, tile_px,
    window_tris, eps)."""
    m = {"flat": nearest.FLAT, "fetch": nearest.FLAT,
         "textured": nearest.TEXTURED, "smooth": nearest.SMOOTH}[mode]
    prep, cfg = scene if m == nearest.FLAT else mode_scenes[m]
    k1 = _frame_args(prep, cfg.replace(tile_px=tpx), VIEWS[view],
                     tpx)["nearest_shaded"]
    assert k1[5] == tpx and k1[10] == m
    return k1 if mode != "fetch" else (k1[0], k1[1], k1[2], k1[4], tpx,
                                       k1[6], k1[7])


def _k1_equal(mode: str, args):
    """K1 vs its plain version on ``args``: t and idx bit for bit, obj and
    the textured row's obj and tex id equal, the attribute rows equal, the
    shading rows within 1e-4 (exp, log and rsqrt round apart), the bounds
    rows as values (+0.0 == -0.0) within 1e-5 relative."""
    if mode == "fetch":
        kt, ki, ka = nearest.tiled_nearest_attrs(*args)
        pt, pi, pa = nearest.tiled_nearest_attrs_plain(*args)
        assert torch.equal(ka, pa)
    else:
        kt, ki, ko, ks, kb = nearest.tiled_nearest_shaded(*args)
        pt, pi, po, ps, pb = nearest.tiled_nearest_shaded_plain(*args)
        assert torch.equal(ko, po)
        torch.testing.assert_close(ks, ps, rtol=0, atol=1e-4)
        if mode == "textured":
            assert torch.equal(ks[:, 4:], ps[:, 4:])
        assert torch.equal(torch.isfinite(kb), torch.isfinite(pb))
        fin = torch.isfinite(pb)
        torch.testing.assert_close(kb[fin], pb[fin], rtol=1e-5, atol=0)
    assert torch.equal(kt, pt) and torch.equal(ki, pi)
    return kt, ki


@pytest.mark.parametrize("tpx", [64, 32])
@pytest.mark.parametrize("mode", ["flat", "textured", "smooth", "fetch"])
def test_k1_work_items_match_plain(scene, mode_scenes, mode, tpx):
    """K1's work items on a plan with every kind of row
    (_torch_cases.k1_stress: a range row of twice the scene's windows, more
    than one span; a list twice as deep; empty rows; every hit tied with a
    copy of higher id) equal the plain version in each mode; with lists in
    spans of 4 entries t and idx equal the plain walk in those spans; and
    the schedule lists each row once, longest first."""
    args = list(_k1_mode_args(scene, mode_scenes, mode, tpx))
    amap = args[11] if mode in ("textured", "smooth") else None
    wt = args[5] if mode == "fetch" else args[6]
    plan, tri, tri_attr, amap = k1_stress(args[0], args[1], args[2], amap,
                                          wt)
    args[:3] = plan, tri, tri_attr
    if amap is not None:
        args[11] = amap
    kt, ki = _k1_equal(mode, tuple(args))
    hit = torch.isfinite(kt)
    assert hit.sum() > 1000
    nw = tri.shape[0] // wt
    assert bool((ki[hit] < nw // 2 * wt).all())      # ties: the lower id
    assert not bool(hit[2::4].any())                  # empty rows miss
    cam, eps = (args[3], args[6]) if mode == "fetch" else (args[4], args[7])
    kw = {} if mode == "fetch" else dict(
        mode=args[10], mat=args[3], attr_map=amap, double_sided=args[8],
        specular_nl=args[9])
    launch, outs, sched = nearest.k1_call(plan, tri, tri_attr, cam, tpx, wt,
                                          eps, list_span=4, **kw)
    launch()
    d = tile_ray_dirs(cam, plan[:, 4], plan[:, 5], tpx)
    pt, pi = nearest.walk_plain(plan, tri, (cam[9], cam[10], cam[11]), d,
                                wt, eps, slices=nearest.k1_slices(tpx * tpx),
                                list_span=4)
    assert torch.equal(outs[0], pt) and torch.equal(outs[1], pi)
    # the schedule: every (tile, span) row once, walk lengths non-increasing
    rows, _length = nearest.work_rows(plan, nw, list_span=4)
    got = sched[2:2 + 2 * int(sched[1])].reshape(-1, 2)
    assert int(sched[1]) == rows.shape[0]
    assert int((rows[:, 0] == 0).sum()) > 1           # a range row's spans
    assert int((rows[:, 0] == 1).sum()) > 1           # a list row's spans

    def key(r):
        return (r[:, 0].long() << 20) + r[:, 1].long()
    assert torch.equal(key(got).sort().values, key(rows).sort().values)
    glen = nearest.row_lengths(plan, got, nw, list_span=4)
    assert bool((glen[1:] <= glen[:-1]).all())


@pytest.mark.parametrize("list_span, want", [(nearest.K1_LIST_SPAN, 0),
                                             (1, 64)])
def test_k1_list_spans_walk_from_their_own_start(list_span, want):
    """A lying bound holds a list walked as one span; a span of one entry
    walks the second window from its own start and finds the nearer hit,
    as the plain walk in the same spans does (tests/test_torch_k1_split.
    py)."""
    (plan, tri, attr_, _mat, cam), (tpx, wt, eps) = two_windows(1.0)
    launch, (t, idx, _), _ = nearest.k1_call(
        plan.cuda(), tri.cuda(), attr_.cuda(), cam.cuda(), tpx, wt, eps,
        list_span=list_span)
    launch()
    assert (idx == want).all() and torch.isfinite(t).all()


def test_k1_calls_do_not_leak_keys(scene):
    """Two views back to back, each way round: each call's results are its
    own view's plain results, with no key of the other call left over."""
    prep, cfg = scene
    a = _frame_args(prep, cfg, VIEWS["identity"])["nearest_shaded"]
    b = _frame_args(prep, cfg, VIEWS["moved"])["nearest_shaded"]
    for first, second in ((a, b), (b, a)):
        nearest.tiled_nearest_shaded(*first)
        kt, ki, *_ = nearest.tiled_nearest_shaded(*second)
        pt, pi, *_ = nearest.tiled_nearest_shaded_plain(*second)
        assert torch.equal(kt, pt) and torch.equal(ki, pi)


def test_k1_adds_no_host_sync(scene):
    """K1 in its fused and fetch modes queues its launches without a host
    synchronisation (the schedule lives on the card)."""
    prep, cfg = scene
    k1 = _frame_args(prep, cfg, VIEWS["moved"])["nearest_shaded"]
    nearest.tiled_nearest_shaded(*k1)              # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nearest.tiled_nearest_shaded(*k1)
        nearest.tiled_nearest_attrs(k1[0], k1[1], k1[2], k1[4], k1[5],
                                    k1[6], k1[7])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_k1_shape_matches_the_port():
    shape = nearest.k1_shape(64)
    assert shape["slice_rays"] == nearest.K1_SLICE
    assert shape["ctas_per_sm"] >= 2 and shape["registers"] <= 128


# the walks over explicit rays as work items: spans short enough to cut the
# scene's lists and ranges, and the stressed plans of _torch_cases
SPANS = (3, 4)
G = 4


def _stressed(plan, tri, wt: int, groups: int):
    if groups > 1:
        return grouped_stress(plan, tri, wt, groups)
    p, t, _, _ = k1_stress(plan, tri, tri[:, :4], None, wt)
    return p, t.contiguous()


def _primary_tiles(prep, cfg, kind: str, m: int):
    """K1's rays mode ("rays"), K4 ("grouped") or K6 ("pages") on the
    moved view's primary rays in tiles of ``m``, the plan stressed:
    (plan, tri, o, d, window_tris, groups)."""
    (o, d), _ = _rays(VIEWS["moved"], TPX * TPX)
    if kind == "pages":
        plan = paged.cull(prep, cfg, o, d, m, cfg.cull_maxv, apex=True)
        wt, groups = prep.page_tris, 1
    else:
        groups = G if kind == "grouped" else 1
        plan = pl.cull_rays(prep, o, d, m, cfg.cull_maxv, 2, groups=groups)
        wt = 2 * prep.block_size
    plan, tri = _stressed(plan, prep.tri, wt, groups)
    op, dp, _ = pl.pad_rays(o, d, m)
    n = op.shape[0] // m
    return (plan, tri, op.reshape(n, m, 3).contiguous(),
            dp.reshape(n, m, 3).contiguous(), wt, groups)


def _nearest_split_plain(plan, tri, o, d, wt, eps, groups, list_span):
    n, m = o.shape[:2]
    kw = dict(slice_rays=nearest.slice_rays(m, groups), list_span=list_span)
    if groups == 1:
        return nearest.walk_plain(plan, tri, tuple(o.unbind(-1)),
                                  tuple(d.unbind(-1)), wt, eps, **kw)
    sub, mask = nearest.group_walk_masks(plan, groups)
    g = m // groups
    t, idx = nearest.walk_plain(
        sub, tri, tuple(o.reshape(-1, g, 3).unbind(-1)),
        tuple(d.reshape(-1, g, 3).unbind(-1)), wt, eps, walk_mask=mask, **kw)
    return t.reshape(n, m), idx.reshape(n, m)


def _schedule_equal(plan, sched, n_windows: int, spans) -> None:
    """The card's schedule lists the plain schedule's rows, longest
    first."""
    rows, _ = nearest.work_rows(plan, n_windows, *spans)
    got = sched[2:2 + 2 * int(sched[1])].reshape(-1, 2)
    assert int(sched[1]) == rows.shape[0]

    def key(r):
        return (r[:, 0].long() << 20) + r[:, 1].long()
    assert torch.equal(key(got).sort().values, key(rows).sort().values)
    glen = nearest.row_lengths(plan, got, n_windows, *spans)
    assert bool((glen[1:] <= glen[:-1]).all())


@pytest.mark.parametrize("kind, m", [("rays", 4096), ("rays", 1000),
                                     ("grouped", 4096), ("grouped", 768),
                                     ("pages", 4096), ("pages", 1024)])
def test_rays_items_nearest_match_plain(scene, kind, m):
    """The nearest walk over explicit rays (K1's rays mode, K4, K6) on a
    stressed plan (a range row of several spans, deep lists, empty rows,
    hits tied with copies), tiles of whole and of cut-short slices: t and
    idx bit for bit the plain walk's in the same slices and spans, at
    short spans and at the wrapper's own; the card's schedule equals the
    plain one."""
    prep, cfg = scene
    plan, tri, o, d, wt, groups = _primary_tiles(prep, cfg, kind, m)
    launch, (t, idx), sched = nearest.rays_call(
        plan, tri, o, d, wt, cfg.mt_eps, groups, *SPANS)
    launch()
    pt, pi = _nearest_split_plain(plan, tri, o, d, wt, cfg.mt_eps, groups,
                                  SPANS[1])
    assert torch.equal(t, pt) and torch.equal(idx, pi)
    hit = torch.isfinite(t)
    assert hit.sum() > 1000 and not bool(hit[2::4].any())
    assert bool((idx[hit] < tri.shape[0] // 2).all())   # ties: lower id
    _schedule_equal(plan, sched, tri.shape[0] // wt, SPANS)
    if groups > 1:
        kt, ki = nearest.tiled_nearest_grouped(plan, tri, o, d, wt,
                                               cfg.mt_eps, groups)
        pt, pi = nearest.tiled_nearest_grouped_plain(plan, tri, o, d, wt,
                                                     cfg.mt_eps, groups)
    else:
        fn = paged.tiled_nearest if kind == "pages" else \
            nearest.tiled_nearest_rays
        kt, ki = fn(plan, tri, o, d, wt, cfg.mt_eps)
        pt, pi = nearest.tiled_nearest_rays_plain(plan, tri, o, d, wt,
                                                  cfg.mt_eps)
    assert torch.equal(kt, pt) and torch.equal(ki, pi)


def _shadow_tiles(prep, cfg, kind: str, m: int):
    """K2′ ("rays"), K5 ("grouped") or K7 ("pages") on shadow rays from the
    moved view's hit points in tiles of ``m`` (S = 4 samples folded in
    tiles of 768 or 1,024 rays, else hard), the plan stressed: (plan, tri,
    block_obj, o, d, self_obj, window_tris, groups)."""
    (o, d), _ = _rays(VIEWS["moved"], TPX * TPX)
    with table.using({"nearest_pages": paged.tiled_nearest_plain}):
        t, idx = paged.hits(prep, cfg, o, d, TPX * TPX, cfg.cull_maxv,
                            apex=True)
    hit = torch.isfinite(t)
    p = (o + torch.where(hit, t, 0.0)[:, None] * d)[hit]
    so = prep.scene.tri_obj[idx[hit].long()].to(torch.int32)
    S = 4 if m in (768, 1024) else 1
    ts = m // S
    step = p.shape[0] // (8 * ts)
    p = p[::step][:8 * ts].reshape(8, 1, ts, 3).expand(8, S, ts, 3)
    so = so[::step][:8 * ts].reshape(8, 1, ts).expand(8, S, ts)
    light = torch.tensor(P.BENCH_LIGHT, device="cuda")
    L = (light + torch.arange(S, device="cuda")[:, None] * 0.5)
    o2 = p.reshape(8, m, 3).contiguous()
    d2 = (L[None, :, None] - p).reshape(8, m, 3).contiguous()
    so = so.reshape(8, m).contiguous()
    if kind == "pages":
        plan = paged.cull_occl(prep, cfg, o2.reshape(-1, 3),
                               d2.reshape(-1, 3), m, cfg.cull_maxv,
                               hourglass=False)
        wt, groups = prep.page_tris, 1
    else:
        groups = G if kind == "grouped" else 1
        plan = pl.cull_occl(prep, o2.reshape(-1, 3), d2.reshape(-1, 3), m,
                            cfg.cull_maxv, 4, None, hourglass=False,
                            groups=groups)
        wt = 4 * prep.block_size
    plan, tri = _stressed(plan, prep.tri, wt, groups)
    bobj = torch.cat([prep.block_obj, prep.block_obj]).contiguous()
    return plan, tri, bobj, o2, d2, so, wt, groups


@pytest.mark.parametrize("kind, m", [("rays", 1024), ("rays", 256),
                                     ("rays", 1000), ("grouped", 1024),
                                     ("grouped", 768), ("pages", 1024),
                                     ("pages", 256)])
def test_rays_items_anyhit_match_plain(scene, kind, m):
    """The any-hit walk over explicit rays (K2′, K5, K7) on a stressed plan:
    found equal to the plain walk's on every lane, at short spans and at
    the wrapper's own; the card's schedule equals the plain one."""
    prep, cfg = scene
    plan, tri, bobj, o, d, so, wt, groups = _shadow_tiles(prep, cfg, kind,
                                                          m)
    args = (tri, bobj, o, d, so, wt, prep.block_size, cfg.mt_eps, True)
    pf = (anyhit.tiled_anyhit_grouped_plain(plan, *args, groups)
          if groups > 1 else anyhit.tiled_anyhit_plain(plan, *args))
    launch, found, sched = anyhit.anyhit_rays_call(plan, *args, groups,
                                                   *SPANS)
    launch()
    assert torch.equal(found, pf)
    assert 50 < int(pf.sum()) < pf.numel()
    _schedule_equal(plan, sched, tri.shape[0] // wt, SPANS)
    if groups > 1:
        kf = anyhit.tiled_anyhit_grouped(plan, *args, groups)
    else:
        fn = paged.tiled_anyhit if kind == "pages" else anyhit.tiled_anyhit
        kf = fn(plan, *args)
    assert torch.equal(kf, pf)


@pytest.mark.parametrize("list_span, want", [(0, 0), (1, 128)])
def test_rays_items_list_spans_walk_from_their_own_start(list_span, want):
    """A lying bound holds a list walked as one span (the wrapper's own
    spans); a span of one entry walks the second page from its own start
    and finds the nearer hit, as the plain walk in the same spans does
    (tests/test_torch_rays_split.py)."""
    (plan, tri, o, d), (wt, eps) = two_pages(1.0)
    launch, (t, idx), _ = nearest.rays_call(
        plan.cuda(), tri.cuda(), o.cuda(), d.cuda(), wt, eps,
        list_span=list_span or None)
    launch()
    assert (idx == want).all() and torch.isfinite(t).all()


def test_rays_items_add_no_host_sync(scene):
    """The walks over explicit rays queue their launches without a host
    synchronisation (the schedule lives on the card)."""
    prep, cfg = scene
    near = _primary_tiles(prep, cfg, "grouped", 4096)
    occ = _shadow_tiles(prep, cfg, "rays", 1024)
    nearest.tiled_nearest_grouped(*near[:4], near[4], cfg.mt_eps, near[5])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nearest.tiled_nearest_grouped(*near[:4], near[4], cfg.mt_eps,
                                      near[5])
        anyhit.tiled_anyhit(*occ[:6], occ[6], prep.block_size, cfg.mt_eps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_rays_items_shapes():
    """The walks over explicit rays: 256-thread CTAs, several to an SM,
    slices of the port's size."""
    for m, groups, rays in ((4096, 1, 512), (1024, 4, 256), (1000, 1, 512)):
        for shape in (nearest.rays_shape(64, m, groups),
                      anyhit.rays_shape(128, 32, m, groups)):
            assert shape["slice_rays"] == rays == nearest.slice_rays(m,
                                                                     groups)
            assert shape["threads"] == 256 and shape["ctas_per_sm"] >= 2


# K2 as work items: the fused frame of the in-view scene at the moved view,
# its shadow plan stressed (_torch_cases.k2_stress), at tiles of 4,096,
# 1,024 and 256 rays, short spans, single ones and the walk's own (None)
K2_CASES = [(64, SPANS), (64, None), (32, (1, 1)), (32, SPANS), (16, (2, 3))]


def _k2_args(prep, cfg, tpx: int):
    """K2's arguments on the moved view's fused frame at ``tpx``-pixel
    tiles, stressed: a range row of every window, deep lists, empty plans,
    all-miss tiles."""
    k2 = list(_frame_args(prep, cfg.replace(tile_px=tpx), VIEWS["moved"],
                          tpx)["anyhit_from_t"])
    assert k2[6] == tpx
    k2[:4] = k2_stress(*k2[:4], k2[7])
    return tuple(k2)


@pytest.mark.parametrize("tpx, spans", K2_CASES)
def test_k2_items_match_plain(scene, tpx, spans):
    """K2's work items on the stressed plans: found equal on every lane to
    the plain model of the items in the same slices and spans and to the
    whole-tile walk; tiles with an empty plan read !hit, miss lanes (and
    all-miss tiles) read 1; the card's schedule equals the plain one; the
    wrapper counts its launch."""
    prep, cfg = scene
    k2 = _k2_args(prep, cfg, tpx)
    plan, tri, t, wt = k2[0], k2[1], k2[3], k2[7]
    sp = spans or anyhit.rays_spans(wt)
    whole = anyhit.tiled_anyhit_from_t_plain(*k2)
    model = anyhit.tiled_anyhit_from_t_plain(
        *k2, slice_rays=nearest.slice_rays(tpx * tpx), spans=sp)
    launch, found, sched = anyhit.anyhit_from_t_call(*k2[:11], *sp)
    launch()
    assert torch.equal(model, whole) and torch.equal(found, whole)
    hit = torch.isfinite(t)
    assert int((found & hit).sum()) > 50 and bool(found[~hit].all())
    cnt = torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1])
    empty = cnt == 0
    assert bool((empty[:, None] & hit).any())
    assert torch.equal(found[empty], ~hit[empty])
    assert int(cnt[plan[:, 3] != 1].max()) > sp[0]   # a range row's spans
    _schedule_equal(plan, sched, tri.shape[0] // wt, sp)
    n0 = _launches("anyhit_from_t")
    assert torch.equal(table.run("anyhit_from_t", *k2), whole)
    assert _launches("anyhit_from_t") == n0 + 1


def test_k2_items_add_no_host_sync(scene):
    """K2 queues its two launches without a host synchronisation."""
    prep, cfg = scene
    k2 = _frame_args(prep, cfg, VIEWS["moved"])["anyhit_from_t"]
    anyhit.tiled_anyhit_from_t(*k2)                # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        anyhit.tiled_anyhit_from_t(*k2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_k2_items_shape():
    """K2's walk: 256-thread CTAs over slices of the port's size, at least
    two CTAs an SM, and no instance over rays from t spills registers."""
    for m, rays in ((4096, 512), (1024, 512), (256, 256)):
        shape = anyhit.rays_shape(128, 32, m, from_t=True)
        assert shape["slice_rays"] == rays == nearest.slice_rays(m)
        assert shape["threads"] == 256 and shape["ctas_per_sm"] >= 2
    spills = _spills(build.build()["log"], "RaysFromT")
    assert len(spills) == 2
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), spills


# K3 as work items: the stressed plans of _torch_cases.k3_stress (a range
# row of several spans, one longer than the plan's entries, deep lists,
# empty rows), tiles of whole and of cut-short slices, short spans and the
# kernel's own
K3_SPANS = ((3, 4), (prepass.PREPASS_RANGE_SPAN, prepass.PREPASS_LIST_SPAN))


def _k3_tiles(prep, cfg, m: int, lie: bool = False):
    """K3's operands on the moved view's primary rays in tiles of ``m``
    (padded by repeating the last ray), the plan stressed: (plan, gram, o,
    d, tri)."""
    (o, d), _ = _rays(VIEWS["moved"], TPX * TPX)
    plan = pl.cull_rays(prep, o, d, m, cfg.cull_maxv, 2)
    plan, tri, gram = k3_stress(plan, prep.tri, prep.gram, 64, lie)
    op, dp, _ = pl.pad_rays(o, d, m)
    n = op.shape[0] // m
    return (plan, gram, op.reshape(n, m, 3).contiguous(),
            dp.reshape(n, m, 3).contiguous(), tri)


@pytest.mark.parametrize("m, lie", [(4096, False), (1000, False),
                                    (768, False), (4096, True)])
def test_prepass_items_match_plain(scene, m, lie):
    """K3's work items on stressed plans, tiles of whole and cut-short
    slices, and lying entry bounds (each slice breaks on its own rays):
    the flags equal the item model's on every plan position, at short
    spans and at the kernel's own; the card's schedule equals the plain
    one (no rows for the long range row); with sound bounds the nearest
    walk over the refined plan equals the unrefined walk bit for bit."""
    prep, cfg = scene
    plan, gram, o, d, tri = _k3_tiles(prep, cfg, m, lie)
    mv = plan.shape[1] - pl.PLAN_AUX
    assert int(plan[2, 1]) > mv and int(plan[2, 3]) == 0
    for rs, ls in K3_SPANS:
        launch, flags, sched = prepass.prepass_call(plan, gram, o, d, 64,
                                                    cfg.mt_eps, rs, ls)
        launch()
        want = prepass.tiled_prepass_plain(plan, gram, o, d, 64, cfg.mt_eps,
                                           range_span=rs, list_span=ls)
        assert torch.equal(flags, want) and bool(flags.any())
        assert not bool(flags[2].any())
        _schedule_equal(prepass.walked_plan(plan), sched, gram.shape[0] // 64,
                        (rs, ls))
        if not lie:
            ref = prepass.refine_plan(plan, flags)
            t0, i0 = nearest.tiled_nearest_rays(plan, tri, o, d, 64,
                                                cfg.mt_eps)
            t1, i1 = nearest.tiled_nearest_rays(ref, tri, o, d, 64,
                                                cfg.mt_eps)
            assert torch.equal(t0, t1) and torch.equal(i0, i1)
    n0 = _launches("prepass")
    assert torch.equal(table.run("prepass", plan, gram, o, d, 64,
                                             cfg.mt_eps), flags)
    assert _launches("prepass") == n0 + 1


def test_prepass_items_calls_do_not_leak_flags(scene):
    """Two frames' operands back to back: each call's flags are its own
    operands' plain flags (the schedule zeroes them)."""
    prep, cfg = scene
    a = _k3_tiles(prep, cfg, 4096)[:4]
    b = _k3_tiles(prep, cfg, 1000)[:4]
    for first, second in ((a, b), (b, a)):
        prepass.tiled_prepass(*first, 64, cfg.mt_eps)
        kf = prepass.tiled_prepass(*second, 64, cfg.mt_eps)
        assert torch.equal(kf, prepass.tiled_prepass_plain(*second, 64,
                                                           cfg.mt_eps))


def test_prepass_items_add_no_host_sync(scene):
    """K3 queues its launches without a host synchronisation (the schedule
    lives on the card)."""
    prep, cfg = scene
    args = _k3_tiles(prep, cfg, 4096)[:4]
    prepass.tiled_prepass(*args, 64, cfg.mt_eps)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prepass.tiled_prepass(*args, 64, cfg.mt_eps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _spills(log: str, kernel: str) -> list:
    """The ``-Xptxas -v`` lines on the spills of each compiled instance of
    ``kernel`` in the build log."""
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        elif inside and "spill" in ln:
            out.append(ln.strip())
    return out


def test_prepass_items_shape():
    """K3's walk: 256-thread CTAs over slices of the port's size, at least
    two CTAs an SM, and no instance spills registers."""
    for m, rays in ((4096, 512), (1000, 512), (256, 256)):
        shape = prepass.prepass_shape(64, m)
        assert shape["slice_rays"] == rays == nearest.slice_rays(m)
        assert shape["threads"] == 256 and shape["ctas_per_sm"] >= 2
        assert shape["registers"] <= 128
    spills = _spills(build.build()["log"], "prepass_items_kernel")
    assert len(spills) == 2
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), spills


@pytest.mark.parametrize("mode", ["bruteforce", "bvh"])
@pytest.mark.parametrize("view", list(VIEWS))
def test_plain_mode_frame_on_the_card(mode, view):
    """The bruteforce and BVH frames render on the card by default (a raw
    Scene moved or prepared there), launch no kernel of csrc/, and are
    within 1 of the same frame on the CPU on >= 99.9% of pixels, equal on
    >= 98%; ray chunks of 5,000 (a padded last chunk) change nothing."""
    cfg = sr.default_config().replace(
        mode=mode, camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                          focal=FOCAL),
        light=sr.LightConfig(num_samples=2), bvh=sr.BVHConfig(split="sah"))
    scene = P.sphere_on_ground(sr.SceneManager(), 3).build()
    before = _walk_launches()
    img = sr.render(scene, cfg, P.BENCH_LIGHT, view_matrix=VIEWS[view])
    torch.cuda.synchronize()
    assert _walk_launches() == before
    assert img.is_cuda and img.shape == (SIZE, SIZE, 3)
    cpu = sr.render(scene, cfg, P.BENCH_LIGHT, view_matrix=VIEWS[view],
                    device="cpu")
    diff = (img.cpu().int() - cpu.int()).abs().amax(-1)
    assert (diff <= 1).float().mean() >= 0.999
    assert (diff == 0).float().mean() >= 0.98
    chunked = sr.render(scene, cfg.replace(ray_chunk=5000), P.BENCH_LIGHT,
                        view_matrix=VIEWS[view])
    assert torch.equal(chunked, img)
    if mode == "bvh":
        steps = metrics.counts("traverse.")
        assert 0 < steps["traverse.nearest_hit.steps"] and \
            0 < steps["traverse.any_hit_other.steps"]


def test_cli_renders_on_the_card(tmp_path):
    """``python -m simple_raytracer_tpu_torch render`` with no --device
    renders on the card: the BMP it writes equals ``render`` on the card
    of the same catalog scene."""
    import os
    import subprocess
    import sys
    from simple_raytracer_tpu_torch.io.image import read_bmp
    from simple_raytracer_tpu_torch.scene import catalog
    sphere = P.icosphere(2)
    sphere.verts[..., :3] *= 2.5
    (tmp_path / "sphere.obj").write_text(P.obj_text(sphere))
    out = str(tmp_path / "f.bmp")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "simple_raytracer_tpu_torch", "render",
         "--scene", "six_spheres", "--root", str(tmp_path), "--mode", "bvh",
         "--width", "160", "--height", "120", "--focal", "120",
         "--out", out], cwd=here, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    sm, view, light = catalog.six_spheres(str(tmp_path), 0.0,
                                          bake_view=False)
    cfg = sr.default_config().replace(
        mode="bvh", camera=sr.CameraConfig(width=160, height=120,
                                           focal=120.0))
    want = sr.render(sm.build(), cfg, light, view_matrix=view)
    assert torch.equal(torch.from_numpy(read_bmp(out)), want.cpu())


def _train_setup(scene):
    """The parity scene's train step on the card (tiled, its shadow in
    view at 128x128), the start params (colours x 0.7) and the target (the
    frame of the true params)."""
    prep, cfg = scene
    light = torch.tensor(P.BENCH_LIGHT, device="cuda")
    with torch.no_grad():
        rad, hit = sr.render_radiance(prep, cfg, light)
    target = torch.where(hit[..., None], rad, 0.0)
    params = sr.extract_params(prep.scene, light)
    params.obj_color = params.obj_color * 0.7
    return prep, cfg, params, target


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_runs_the_cuda_walks(scene, remat):
    """A tiled train step on a CUDA prepared scene launches K1's rays walk
    and K2′ once each (twice with ``remat``, whose backward reruns the
    forward) and no other kernel; its losses fall."""
    prep, cfg, params, target = _train_setup(scene)
    step = sr.make_train_step(prep, cfg, lr=1e-3, remat=remat)
    metrics.reset_counts()
    params, loss = step(params, target)
    torch.cuda.synchronize()
    n = 2 if remat else 1
    assert _walk_launches() == {r: n if r in ("nearest_rays", "anyhit") else 0
                             for r in WALKS}
    losses = [float(loss)]
    for _ in range(3):
        params, loss = step(params, target)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_train_step_equals_the_plain_walks(scene):
    """The step's loss and gradients on the CUDA walks against the same
    step on their plain versions (``table.plain()``): the winners equal
    bit for bit, so the loss agrees to rtol 1e-6 and the gradients to
    1e-4 of each field's largest (the backward's scatter-adds sum in any
    order)."""
    prep, cfg, params, target = _train_setup(scene)
    got = sr.make_train_step(prep, cfg).value_and_grad(params, target)
    with table.using(table.plain()):
        want = sr.make_train_step(prep, cfg).value_and_grad(params, target)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
    for a, b in zip(got[1].leaves(), want[1].leaves()):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# the tiled configurations over explicit rays or range-only plans: the
# frame's change, its branch, and the roles its frame launches
CONFIGS = {
    "sub_tile": (dict(hit_tile=1024), "soft",
                 ("nearest_rays_attrs", "anyhit")),
    "normalized": (dict(camera=sr.CameraConfig(width=SIZE, height=SIZE,
                                               focal=FOCAL,
                                               normalize_dirs=True)),
                   "soft", ("nearest_rays_attrs", "anyhit")),
    "range_only": (dict(cull_maxv=0), "gather", ("nearest_rays", "anyhit")),
    "paged_range_only": (dict(cull_maxv=0, tiled_impl="paged"), "paged",
                         ("nearest_pages", "anyhit_pages")),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_config_frame_launches_its_kernels(scene, config):
    """Each configuration's frame launches its branch's two kernels once and
    no other, and its image matches the plain versions' on the CPU."""
    from simple_raytracer_tpu_torch.kernels import tiled
    prep, cfg = scene
    change, branch, roles = CONFIGS[config]
    c = cfg.replace(**change)
    assert tiled.frame_branch(prep, c, TPX * TPX) == branch
    n0 = _walk_launches()
    img = sr.render(prep, c, P.BENCH_LIGHT)
    n1 = _walk_launches()
    assert {k for k in n0 if n1[k] != n0[k]} == set(roles)
    assert all(n1[k] == n0[k] + 1 for k in roles)
    cpu = sr.render(prep.to("cpu"), c, P.BENCH_LIGHT)
    diff = (img.cpu().int() - cpu.int()).abs()
    assert (diff <= 1).float().mean() >= 0.999


@pytest.mark.parametrize("config", ["sub_tile", "normalized", "range_only",
                                    "paged_range_only"])
@pytest.mark.parametrize("view", list(VIEWS))
def test_config_walks_match_plain(scene, config, view):
    """The nearest walk of each configuration (K1's fetch mode over rays,
    K1's rays mode over a range-only plan, K6 over page ranges) equals its
    plain version bit for bit, the fetched rows too."""
    prep, cfg = scene
    change, _branch, roles = CONFIGS[config]
    c = cfg.replace(**change)
    cam = c.camera
    vm = None if VIEWS[view] is None else torch.tensor(VIEWS[view],
                                                        device="cuda")
    o, d, _, _ = primary_rays_tiled(SIZE, SIZE, TPX, FOCAL,
                                    cam.normalize_dirs, view_matrix=vm,
                                    device="cuda")
    stores = {k: [] for k in WALKS}
    with table.using({k: table.spy(k, stores[k]) for k in WALKS}):
        render_flat_tiled(prep, c,
                          torch.tensor(P.BENCH_LIGHT, device="cuda"),
                          (vm, FOCAL, SIZE, SIZE, TPX),
                          rays=(o.reshape(-1, 3), d.reshape(-1, 3)))
    args = stores[roles[0]][0]
    got = table.roles()[roles[0]].cuda(*args)
    want = table.roles()[roles[0]].plain(*args)
    assert torch.isfinite(want[0]).sum() > 4000
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fetch_over_rays_wrapper_rejects_bad_inputs(scene):
    prep, cfg = scene
    o, d, _, _ = primary_rays_tiled(SIZE, SIZE, TPX, FOCAL, device="cuda")
    o, d = o.reshape(-1, 1024, 3), d.reshape(-1, 1024, 3)
    plan = pl.cull_rays(prep, o.reshape(-1, 3), d.reshape(-1, 3), 1024, 0,
                        2)
    wt = 2 * prep.block_size
    with pytest.raises(ValueError):                # tri_attr rows short
        nearest.tiled_nearest_rays_attrs(plan, prep.tri, prep.tri_attr[:-1],
                                         o, d, wt, 1e-9)
    with pytest.raises(ValueError):                # tri_attr on the CPU
        nearest.tiled_nearest_rays_attrs(plan, prep.tri, prep.tri_attr.cpu(),
                                         o, d, wt, 1e-9)


def test_ring_on_the_card_equals_the_plain_ring(scene):
    """The ring of 4 geometry shards on the card, through the local
    schedule: 16 K1 rays-walk calls and 16 K7 calls, and the frame equal
    bit for bit to the same ring over the plain walks."""
    from simple_raytracer_tpu_torch.dist import ring
    from simple_raytracer_tpu_torch.ops.camera import primary_rays
    _prep, cfg = scene
    sc = P.sphere_on_ground(sr.SceneManager(), 3).build()
    shards = ring.shard_geometry(sc, 4, cfg, device="cuda")
    tables = ring.strip_scene_tables(sc).to("cuda")
    o, d = primary_rays(SIZE, SIZE, FOCAL, device="cuda")
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    light = torch.tensor(P.BENCH_LIGHT, device="cuda")
    metrics.reset_counts()
    rad, hit = ring.render_flat_ring_local(tables, shards, cfg, o, d, light,
                                           apex=True)
    torch.cuda.synchronize()
    assert _launches("nearest_rays") == 16
    assert _launches("anyhit_pages") == 16
    with table.using(table.plain()):
        prad, phit = ring.render_flat_ring_local(tables, shards, cfg, o, d,
                                                 light, apex=True)
    assert torch.equal(hit, phit) and 100 < int(hit.sum()) < hit.numel()
    assert torch.equal(rad[hit], prad[phit])


def test_dp_render_on_one_nccl_process(scene):
    """A mesh of one process on the card (NCCL): the data-parallel frame
    equals the explicit-ray render of the same rays on every pixel."""
    from simple_raytracer_tpu_torch.dist import make_mesh, render_sharded
    from simple_raytracer_tpu_torch.ops.camera import primary_rays
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    prep, cfg = scene
    mesh = make_mesh(1, ("dp",), device="cuda")
    light = torch.tensor(P.BENCH_LIGHT, device="cuda")
    img = render_sharded(prep, cfg, light, mesh)
    o, d = primary_rays(SIZE, SIZE, FOCAL, device="cuda")
    rad, hit = render_flat_tiled(prep, cfg, light, None,
                                 rays=(o.reshape(-1, 3), d.reshape(-1, 3)))
    want = finalize_image(rad.reshape(SIZE, SIZE, 3), hit.reshape(SIZE, SIZE),
                          cfg)
    assert torch.equal(img, want)
