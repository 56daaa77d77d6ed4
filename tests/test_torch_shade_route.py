"""PyTorch port: the shading's route (the ``shade`` role of
kernels/table.py) and the wiring of its CUDA wrapper, on the CPU.

The shading kernel (csrc/shade.cu) runs only on the card
(tests/test_torch_shade_cuda.py holds it to the plain integrator there).
Here: which shading ``shade`` takes for each device, record and gradient;
the CPU frame's image and counters as the plain integrator gives them; the
CUDA wrapper's light samples, shadow query and kernel arguments, with a
plain stand-in for the kernel; the light samples' offsets made once per
device; and diff/render.py's gradients through the plain route.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.diff.render import render_radiance_diff
from simple_raytracer_tpu_torch.kernels import table
from simple_raytracer_tpu_torch.ops.camera import primary_rays_world
from simple_raytracer_tpu_torch.render import integrator
from simple_raytracer_tpu_torch.render.renderer import (brute_force_hits,
                                                         brute_force_shadow)
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics
from rtbench import traffic as tr

LIGHT = (500.0, -300.0, -200.0)
PIVOT = (0.3, 0.2, 60.0)
SIZE, FOCAL, S = 48, 60.0, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def textured():
    """The textured sphere on the ground: two objects, the ground
    textured."""
    return P.textured_on_ground(sr.SceneManager(), 1).build()


def _cfg(smooth: bool = True, samples: int = S, **shading):
    return sr.default_config().replace(
        camera=sr.CameraConfig(width=SIZE, height=SIZE, focal=FOCAL),
        light=sr.LightConfig(position=LIGHT, color=(0.9, 0.8, 1.1),
                             num_samples=samples),
        shading=sr.ShadingConfig(smooth_normals=smooth, **shading))


def _rays(scene, deg: float = 10.0):
    o, d = primary_rays_world(SIZE, SIZE, tr.yaw_about(PIVOT, deg), FOCAL,
                              False)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t, idx = brute_force_hits(scene, o, d)
    return o, d, t, idx


def _counts():
    now = metrics.counts("integrator.")
    return tuple(now.get(f"integrator.{k}", 0) for k in (
        "shade_cuda.calls", "shade_cuda.launches", "shade_plain.calls"))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("grad", ["none", "off", "on"])
@pytest.mark.parametrize("record", [False, True])
def test_route(device, grad, record):
    """The kernel takes CUDA tensors with no record and no gradient to
    carry; the CPU, a given record, or autograd with an input that
    requires a gradient go plain.  An input that requires a gradient under
    no_grad carries none."""
    x = torch.zeros(3, requires_grad=grad != "none")
    rec = {"obj": torch.zeros(1, dtype=torch.int32)} if record else None
    want = (integrator.shade_cuda
            if device == "cuda" and not record and grad != "on"
            else integrator.shade_plain)
    # a scene on ``device`` whose tensors need no gradient, the rays x
    scene = types.SimpleNamespace(device=torch.device(device), **dict.fromkeys(
        ("verts", "vnormals", "tri_normal", "uvs", "obj_color", "obj_ambient",
         "obj_specular", "obj_shininess", "tex_data")))
    args = (scene, None, x, x, x, None, x, None, rec)
    if grad == "off":
        with torch.no_grad():
            got = table.pick("shade", *args)
    else:
        got = table.pick("shade", *args)
    assert got is want, (device, grad, record)


@pytest.mark.parametrize("smooth", [False, True])
def test_cpu_shade_is_the_plain_integrator(textured, smooth):
    """On the CPU ``shade`` is the record gather and ``shade_records``,
    bit for bit, counted as one plain call and no CUDA call."""
    o, d, t, idx = _rays(textured)
    cfg = _cfg(smooth)
    light = torch.tensor(LIGHT)
    shadow_fn = brute_force_shadow(textured)
    before = _counts()
    got = integrator.shade(textured, cfg, o, d, t, idx, light, shadow_fn)
    assert _counts() == (before[0], before[1], before[2] + 1)
    rec = integrator.gather_hit_records(textured, idx, cfg)
    want = integrator.shade_records(textured, cfg, rec, o, d, t, light,
                                    shadow_fn)
    assert torch.equal(got, want)


def test_cpu_frame_takes_the_plain_route(monkeypatch):
    """A tiled gather frame on the CPU (textured, smooth normals, S > 1)
    shades once, plain, and its image equals the frame shaded by
    ``shade_records`` over the gathered records."""
    cfg = _cfg(True, S).replace(mode="tiled",
                                bvh=sr.BVHConfig(split="sah"))
    prep = prepare(P.textured_on_ground(sr.SceneManager(), 1).build(), cfg,
                   device="cpu")
    light = torch.tensor(LIGHT)
    view = tr.yaw_about(PIVOT, -12.0)
    before = _counts()
    img = sr.render(prep, cfg, light, view_matrix=view)
    assert _counts() == (before[0], before[1], before[2] + 1)

    def old_shade(scene, cfg_, o, d, t, idx, lp, shadow_fn=None,
                  record=None):
        rec = integrator.gather_hit_records(scene, idx, cfg_)
        return integrator.shade_records(scene, cfg_, rec, o, d, t, lp,
                                        shadow_fn)
    monkeypatch.setattr(integrator, "shade", old_shade)
    ref = sr.render(prep, cfg, light, view_matrix=view)
    assert torch.equal(img, ref)
    assert bool((img != torch.tensor(cfg.background, dtype=torch.uint8))
                .any())


@pytest.mark.parametrize("samples", [1, S])
@pytest.mark.parametrize("shadows", [False, True])
def test_cuda_wrapper_wiring(textured, monkeypatch, samples, shadows):
    """``shade_cuda`` as ``shade`` takes it, with the kernel replaced by a
    plain stand-in that reads what the wrapper hands it (the light samples
    [S, 3]; the shadow flags [S, R], sample-major; the rays, t and ids):
    the radiance of ``shade_plain`` bit for bit, one call, one launch."""
    o, d, t, idx = _rays(textured)
    cfg = _cfg(True, samples)
    light = torch.tensor(LIGHT)
    shadow_fn = brute_force_shadow(textured) if shadows else None
    seen = {}

    def stand_in(scene, cfg_, o_, d_, t_, idx_, samples_, found=None):
        seen.update(samples=samples_, found=found)
        metrics.count("integrator.shade_cuda.launches")
        flags = (None if found is None else
                 lambda *a, **k: found.reshape(-1))
        rec = integrator.gather_hit_records(scene, idx_, cfg_)
        return integrator.shade_records(scene, cfg_, rec, o_, d_, t_, light,
                                        flags)
    monkeypatch.setattr(integrator, "shade_launch", stand_in)
    before = _counts()
    with table.using({"shade": integrator.shade_cuda}):
        got = integrator.shade(textured, cfg, o, d, t, idx, light,
                               shadow_fn)
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])
    assert torch.equal(seen["samples"], integrator.light_sample_positions(
        light, samples, cfg.light.jitter_step))
    if shadows:
        assert seen["found"].shape == (samples, o.shape[0])
        assert seen["found"].dtype == torch.bool
        assert bool(seen["found"].any())
    else:
        assert seen["found"] is None
    want = integrator.shade_plain(textured, cfg, o, d, t, idx, light,
                                  shadow_fn)
    assert torch.equal(got, want)


def test_one_object_scene_has_no_shadow_query(monkeypatch):
    """A scene of one object is never shadowed, on either route: the
    shadow query is not made."""
    scene = P.textured_on_ground(sr.SceneManager(), 1).build()
    one = dataclasses.replace(scene, obj_color=scene.obj_color[:1],
                              tri_obj=torch.zeros_like(scene.tri_obj))
    o, d, t, idx = _rays(one)
    seen = {}

    def stand_in(*a):
        seen["found"] = a[7]
        return torch.zeros_like(o)

    def query(*a, **k):
        raise AssertionError("a one-object scene made a shadow query")
    monkeypatch.setattr(integrator, "shade_launch", stand_in)
    with table.using({"shade": integrator.shade_cuda}):
        integrator.shade(one, _cfg(), o, d, t, idx, torch.tensor(LIGHT),
                         query)
    assert seen["found"] is None


def test_sample_offsets_are_made_once():
    """The samples' offsets are made once per (S, jitter step, device) and
    equal the reference's cumulative jitter: +step on x, y, z in turn after
    each sample."""
    a = integrator._sample_offsets(5, 3.0, torch.device("cpu"))
    assert integrator._sample_offsets(5, 3.0, torch.device("cpu")) is a
    assert integrator._sample_offsets(5, 2.0, torch.device("cpu")) is not a
    want = np.array([[0, 0, 0], [3, 0, 0], [3, 3, 0], [3, 3, 3], [6, 3, 3]],
                    np.float32)
    assert np.array_equal(a.numpy(), want)
    lp = integrator.light_sample_positions(LIGHT, 5, 3.0)
    assert np.array_equal(lp.numpy(), np.float32(LIGHT) + want)


def test_diff_gradients_flow_through_the_plain_route():
    """diff/render.py's differentiated shading takes the plain route (the
    textured, smooth-normal record gather), and the loss's gradient reaches
    the vertices, the colours and the light."""
    scene = P.textured_on_ground(sr.SceneManager(), 1).build()
    verts = scene.verts.clone().requires_grad_(True)
    color = scene.obj_color.clone().requires_grad_(True)
    s = dataclasses.replace(scene, verts=verts, obj_color=color)
    light = torch.tensor(LIGHT, requires_grad=True)
    cfg = _cfg(True, 2).replace(mode="bruteforce")
    before = _counts()
    rad, hit = render_radiance_diff(s, cfg, light)
    assert _counts()[0:2] == before[0:2]
    assert _counts()[2] == before[2] + 1
    rad[hit].sum().backward()
    for g in (verts.grad, color.grad, light.grad):
        assert g is not None and bool(torch.isfinite(g).all())
        assert bool((g != 0).any())
