"""PyTorch port on the GPU: the shading kernel (csrc/shade.cu, reached by
render/integrator.py::shade_cuda) against the plain integrator
(integrator.shade_plain: the record gather, then shade_records), bit for
bit.

Every test here needs a CUDA device and nvcc, and skips without them.  The
file imports neither JAX nor the JAX package; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_shade_cuda.py

Cases: the four record kinds (flat, smooth, textured, textured + smooth)
at 1, 4 and 16 light samples, shadows on and off, the tone map on and off,
the diffuse and specular quirks toggled, the tone map's special exponents;
rays that miss and a ray count that is no multiple of the kernel's block;
the uint8 frames of the benchmark's two soft scenes at three yaws through
``render``, the kernel's and the plain integrator's equal on every pixel;
the kernel's route with no host read; one CUDA call and no plain call a
soft frame.
"""

import dataclasses

import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.kernels import table
from simple_raytracer_tpu_torch.ops.camera import primary_rays_world
from simple_raytracer_tpu_torch.render import integrator
from simple_raytracer_tpu_torch.render.renderer import brute_force_hits
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics
from rtbench import traffic as tr

pytestmark = pytest.mark.cuda

LIGHT = (500.0, -300.0, -200.0)
PIVOT = (0.3, 0.2, 60.0)
COLOR = (0.9, 0.8, 1.1)
# a frame of rays that is no multiple of the kernel's 256-thread block,
# part of them missing the scene
WIDTH, HEIGHT, FOCAL = 61, 43, 60.0
KINDS = {"flat": ("sphere", False), "smooth": ("sphere", True),
         "textured": ("textured", False),
         "textured_smooth": ("textured", True)}
# the benchmark's soft cells: scene, BVH split, smooth normals
CELLS = {"textured6": ("textured", "sah", True),
         "dense6": ("dense", "median", False)}
YAWS = (-25.0, 0.0, 25.0)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _cuda():
    _need_cuda()


@pytest.fixture(scope="module")
def small():
    """Small scenes on the card: the flat sphere on the ground, and the
    textured one (its ground textured), both of two objects."""
    _need_cuda()
    return {"sphere": P.sphere_on_ground(sr.SceneManager(), 2).build()
            .to("cuda"),
            "textured": P.textured_on_ground(sr.SceneManager(), 2).build()
            .to("cuda")}


def _cfg(smooth: bool, samples: int, tonemap: bool = True,
         double_sided: bool = True, specular_nl: bool = True,
         gamma: float = 1.1):
    return sr.default_config().replace(
        light=sr.LightConfig(position=LIGHT, color=COLOR,
                             num_samples=samples),
        shading=sr.ShadingConfig(smooth_normals=smooth,
                                 tonemap_enabled=tonemap,
                                 double_sided_diffuse=double_sided,
                                 specular_nl_factor=specular_nl,
                                 gamma=gamma))


def _rays(scene):
    """The frame's rays from a camera turned 10 degrees, and their nearest
    hits by the bruteforce walk (-1 and inf on a miss)."""
    o, d = primary_rays_world(WIDTH, HEIGHT, tr.yaw_about(PIVOT, 10.0),
                              FOCAL, False, device="cuda")
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    t, idx = brute_force_hits(scene, o, d)
    return o, d, t, idx


def _found_fn(S: int, R: int, seed: int):
    """A shadow query that answers with seeded random flags [S * R]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    found = torch.rand((S * R,), generator=g, device="cuda") < 0.4
    return lambda point, light, self_obj, hit=None: found


def _same_bits(got, want) -> bool:
    """Equal to the bit, NaN equal to NaN."""
    got, want = got.contiguous(), want.contiguous()
    both_nan = torch.isnan(got) & torch.isnan(want)
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | both_nan).all())


def _both(scene, cfg, o, d, t, idx, shadow_fn):
    light = torch.tensor(LIGHT, device="cuda")
    got = integrator.shade_cuda(scene, cfg, o, d, t, idx, light, shadow_fn)
    want = integrator.shade_plain(scene, cfg, o, d, t, idx, light, shadow_fn)
    return got, want


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("samples", [1, 4, 16])
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("tonemap", [False, True])
def test_kernel_equals_plain(small, kind, samples, shadows, tonemap):
    """Every ray's radiance, misses included, equal to the plain
    integrator's to the bit."""
    name, smooth = KINDS[kind]
    scene = small[name]
    o, d, t, idx = _rays(scene)
    R = o.shape[0]
    assert R % 256 and bool((idx < 0).any()) and bool((idx >= 0).any())
    cfg = _cfg(smooth, samples, tonemap)
    fn = _found_fn(samples, R, samples) if shadows else None
    got, want = _both(scene, cfg, o, d, t, idx, fn)
    assert got.shape == want.shape == (R, 3)
    assert _same_bits(got, want), (kind, samples, shadows, tonemap)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("double_sided,specular_nl",
                         [(False, True), (True, False), (False, False)])
def test_quirks_toggled(small, kind, double_sided, specular_nl):
    """The clamped diffuse and the specular term without its n.l factor."""
    name, smooth = KINDS[kind]
    scene = small[name]
    o, d, t, idx = _rays(scene)
    cfg = _cfg(smooth, 4, double_sided=double_sided,
               specular_nl=specular_nl)
    got, want = _both(scene, cfg, o, d, t, idx, _found_fn(4, o.shape[0], 7))
    assert _same_bits(got, want), (kind, double_sided, specular_nl)


@pytest.mark.parametrize("gamma", [2.2, 2.0, 3.0, 0.5, -0.5, -1.0, -2.0])
def test_tone_map_exponents(small, gamma):
    """torch.pow's special exponents of the tone map, and another gamma."""
    scene = small["textured"]
    o, d, t, idx = _rays(scene)
    got, want = _both(scene, _cfg(True, 4, gamma=gamma), o, d, t, idx,
                      _found_fn(4, o.shape[0], 3))
    assert _same_bits(got, want), gamma


@pytest.fixture(scope="module")
def cells():
    """The benchmark's two soft scenes prepared on the card."""
    _need_cuda()
    out = {}
    for name, (scene, split, smooth) in CELLS.items():
        cfg = sr.default_config().replace(
            mode="tiled", bvh=sr.BVHConfig(split=split),
            camera=sr.CameraConfig(width=600, height=400, focal=400.0),
            light=sr.LightConfig(position=LIGHT, num_samples=16),
            shading=sr.ShadingConfig(smooth_normals=smooth))
        built = (P.textured_on_ground(sr.SceneManager(), 6) if
                 scene == "textured" else
                 P.dense_textured_on_ground(sr.SceneManager())).build()
        out[name] = (cfg, prepare(built, cfg, device="cuda"))
    return out


def _counts():
    """The shading's counters: csrc/shade.cu's calls and launches, and the
    plain integrator's calls."""
    now = metrics.counts("integrator.")
    return tuple(now.get(f"integrator.{k}", 0) for k in (
        "shade_cuda.calls", "shade_cuda.launches", "shade_plain.calls"))


@pytest.mark.parametrize("name", list(CELLS))
def test_soft_frames_equal_plain(cells, monkeypatch, name):
    """The cell's frame at the arc's two ends and its middle: the uint8
    image equal on every pixel and the radiance to the bit; each frame
    shades in one CUDA call and one launch, with no plain call."""
    cfg, prep = cells[name]
    light = torch.tensor(LIGHT, device="cuda")
    for deg in YAWS:
        view = tr.yaw_about(PIVOT, deg)
        metrics.reset_counts("integrator.")
        img = sr.render(prep, cfg, light, view_matrix=view)
        assert _counts() == (1, 1, 0)
        rad, _ = sr.render_radiance(prep, cfg, light, view_matrix=view)
        with table.using({"shade": integrator.shade_plain}):
            ref = sr.render(prep, cfg, light, view_matrix=view)
            ref_rad, _ = sr.render_radiance(prep, cfg, light,
                                            view_matrix=view)
        assert _counts()[2] == 2
        assert torch.equal(img, ref), (name, deg, int((img != ref).sum()))
        assert _same_bits(rad, ref_rad), (name, deg)


@pytest.mark.parametrize("name", list(CELLS))
def test_cuda_route_reads_nothing_back(cells, monkeypatch, name):
    """After a warm-up, ``shade`` on the CUDA route, the frame's shadow
    query included, queues with no host synchronisation."""
    cfg, prep = cells[name]
    light = torch.tensor(LIGHT, device="cuda")
    calls = []
    real = integrator.shade

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    with monkeypatch.context() as m:
        m.setattr(integrator, "shade", spy)
        sr.render(prep, cfg, light, view_matrix=tr.yaw_about(PIVOT, 5.0))
    (a, k), = calls
    assert table.pick("shade", *a, **k) is integrator.shade_cuda
    real(*a, **k)
    torch.cuda.synchronize()
    before = _counts()[0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        real(*a, **k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _counts()[0] == before + 1


def test_autograd_on_the_card_takes_the_plain_route(small):
    """With a gradient to carry the card shades in plain PyTorch, and the
    gradient reaches the object colours."""
    scene = small["sphere"]
    o, d, t, idx = _rays(scene)
    color = scene.obj_color.clone().requires_grad_(True)
    s = dataclasses.replace(scene, obj_color=color)
    light = torch.tensor(LIGHT, device="cuda")
    cuda, _, plain = _counts()
    rad = integrator.shade(s, _cfg(False, 4), o, d, t, idx, light)
    assert (_counts()[0], _counts()[2]) == (cuda, plain + 1)
    rad[idx >= 0].sum().backward()
    assert color.grad is not None and bool((color.grad != 0).any())
