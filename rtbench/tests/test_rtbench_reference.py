"""The plain reference against the program's plain CPU path, pixel for
pixel, on tiny frames; the frozen scenes against the program's builders;
and the control (the reference in bfloat16, in the program's place)
failing the run's own check."""

import numpy as np
import pytest
import torch

from rtbench import control, faults, spec, traffic as tr
from rtbench.reference.render import Frame, Reference
from rtbench.scenes import port, procedural as B


def program_image(scene, frame):
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.render.renderer import render
    cfg = sr.default_config().replace(
        mode="tiled", bvh=sr.BVHConfig(split="sah"),
        camera=sr.CameraConfig(width=frame.width, height=frame.height,
                               focal=frame.focal),
        light=sr.LightConfig(num_samples=frame.samples),
        shading=sr.ShadingConfig(smooth_normals=frame.smooth_normals))
    prep = prepare(port.to_port(scene), cfg, device="cpu")
    return render(prep, cfg, frame.light, view_matrix=frame.view).numpy()


# sizes at which no ray runs exactly along an edge of the ground box: there
# the program (triangles in BVH order) and the reference (in scene order)
# break the tie between two faces differently
CASES = {
    "hard shadow, flat": (B.sphere_on_ground(2), 1, False, 96, 54, 54.0),
    "S=4, textured, smooth": (B.textured_on_ground(2), 4, True, 120, 80,
                              80.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("yaw", [0.0, -23.0])
def test_reference_equals_the_program_plain_path(case, yaw):
    scene, S, smooth, W, H, f = CASES[case]
    view = tr.yaw_about(B.SPHERE_CENTRE, yaw)
    frame = Frame(W, H, f, view, B.BENCH_LIGHT, S, smooth)
    want = program_image(scene, frame).reshape(-1, 3)
    ref = Reference(scene)
    got = ref.pixels(frame, np.arange(W * H))
    assert np.array_equal(got, want)
    # the frame exercises the shadow: turning it off changes pixels
    dark = Frame(W, H, f, view, B.BENCH_LIGHT, S, smooth, shadows=False)
    assert (ref.pixels(dark, np.arange(W * H)) != got).any(-1).sum() > 0


@pytest.mark.parametrize("build", ["sphere_on_ground", "textured_on_ground"])
def test_frozen_scenes_equal_the_program_builders(build):
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.scene import procedural as P
    mine = port.to_port(getattr(B, build)(3))
    theirs = getattr(P, build)(sr.SceneManager(), 3).build()
    for name in mine.ARRAY_FIELDS:
        assert np.array_equal(getattr(mine, name).numpy(),
                              getattr(theirs, name).numpy()), name


@pytest.mark.parametrize("cell", ["icosphere6.shadow1080",
                                  "textured6.soft600"])
def test_every_seed_builds_the_same_scene(cell):
    c = spec.resolve(cell)
    c.config = dict(c.config, subdivisions=2)
    a, b = (c.scene_builder().build(c.config, s) for s in (1, 2 ** 31 + 7))
    for x, y in zip(a.objects, b.objects):
        assert np.array_equal(x.mesh.verts, y.mesh.verts)


@pytest.mark.parametrize("cell", ["icosphere6.shadow1080",
                                  "textured6.soft600",
                                  "icosphere6.bench1080"])
def test_the_control_fails_the_limit(cell):
    c = spec.resolve(cell)
    c.traffic, c.config = tr.rehearsal(c.traffic, c.config, width=160)
    out = control.read(c, 11, faults.CONTROL, 0.5, "cpu", "cpu")
    assert out["correct"] is False and out["frames_checked"] > 0
    assert any(v["value"] > v["limit"] for v in out["checks"].values()), out


def test_reference_in_bfloat16_differs():
    scene = B.sphere_on_ground(2)
    frame = Frame(64, 36, 200.0, tr.yaw_about(B.SPHERE_CENTRE, 5.0),
                  B.BENCH_LIGHT)
    px = np.arange(64 * 36)
    a = Reference(scene).pixels(frame, px)
    b = Reference(scene, dtype=torch.bfloat16).pixels(frame, px)
    assert (a != b).any()
