"""The dense soft-shadow cell (``dense6.soft600``): its frozen scene against
the program's builder, its arc against the reference, its control and
faults in a rehearsal, and the hourglass planner's metrics on a synthetic
trace."""

import re

import numpy as np
import pytest
import torch

from rtbench import control, faults, session, spec, traffic as tr
from rtbench.metrics import program_kernels
from rtbench.reference.render import Reference
from rtbench.scenes import port
from rtbench.scenes.dense_textured_on_ground import dense_textured_on_ground
from rtbench.spec import metric_module
from rtbench.trace import FRAME_SPAN, Trace

CELL = "dense6.soft600"


@pytest.mark.parametrize("subdivisions", [2, 4])
def test_frozen_scene_equals_the_program_builder(subdivisions):
    """Triangle for triangle, with the same normals, UVs, materials and
    textures."""
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.scene import procedural as P
    mine = port.to_port(dense_textured_on_ground(subdivisions))
    theirs = P.dense_textured_on_ground(sr.SceneManager(),
                                        subdivisions).build()
    for name in mine.ARRAY_FIELDS:
        assert np.array_equal(getattr(mine, name).numpy(),
                              getattr(theirs, name).numpy()), name


def test_the_configuration_states_its_scene():
    c = spec.resolve(CELL)
    scene = c.scene_builder().build(c.config, 2 ** 31 + 5)
    assert scene.num_triangles == c.config["triangles"] == 163852
    assert [o.name for o in scene.objects] == ["sphere", "ground", "sphere2"]
    assert c.config["bvh_split"] == "median"
    assert not c.config["smooth_normals"] and c.traffic["light_samples"] == 16


def test_arc_views_keep_the_spheres_and_a_shadow():
    """Every view of the arc (a small size, the reference) shows soft
    shadows and the second sphere on at least half as many pixels as the
    cell's own view; the first sphere too, down to a yaw of -15 degrees,
    past which the second sphere, nearer the camera, hides it (wholly from
    -20 degrees: about a fifth of the arc's frames)."""
    c = spec.resolve(CELL)
    t, cfg = tr.rehearsal(c.traffic, c.config, width=192)
    scene = c.scene_builder().build(cfg, 1)
    ref = Reference(scene)
    amp = float(t["arc"]["amplitude_deg"])
    W, H = int(t["width"]), int(t["height"])
    px = torch.arange(W * H)
    base = None
    for yaw in [0.0] + list(np.linspace(-amp, amp, 11)):
        view = tr.yaw_about(cfg["pivot"], yaw)
        frame = tr.frame(t, cfg, view)
        o, d = ref.rays(frame, px)
        _, idx = ref.nearest(o, d)
        obj = ref.tri_obj[idx.clamp_min(0)][idx >= 0]
        seen = [int((obj == k).sum()) for k in (0, 2)]
        base = base or seen
        assert seen[1] > 0.5 * base[1] > 0, (yaw, seen)
        if yaw >= -15.0:
            assert seen[0] > 0.5 * base[0] > 0, (yaw, seen)
        elif yaw <= -20.0:
            assert seen[0] <= 1, (yaw, seen)
        lit = tr.frame(dict(t, shadows=False), cfg, view)
        shadowed = int((ref.pixels(frame, px) != ref.pixels(lit, px))
                       .any(-1).sum())
        assert shadowed > 0, yaw
    assert t["expect"]["shadow_in_view"]


@pytest.mark.parametrize("plant", ["none", faults.CONTROL, "noshadow",
                                   "altered"])
def test_rehearsal_passes_and_its_plants_fail(plant):
    """The cell's session at a small size on the CPU: the program passes
    the check, the control and the faults are refused."""
    c = spec.resolve(CELL)
    c.traffic, c.config = tr.rehearsal(c.traffic, c.config, width=160)
    out = control.read(c, 2 ** 31 + 9, plant, 0.5, "cpu", "cpu")
    assert out["frames_checked"] > 0 and out["shadow_pixels"] > 0
    assert out["correct"] is (plant == "none"), out


def X(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_hourglass_metrics_read_a_synthetic_trace():
    events = [
        X("user_annotation", FRAME_SPAN, 0, 1000),
        X("user_annotation", FRAME_SPAN, 1000, 1000),
        X("kernel", "void (anonymous namespace)::plan_tiles_kernel<1, "
          "false>((anonymous namespace)::Operands, float const*)", 10, 40,
          tid=7),
        X("kernel", "void (anonymous namespace)::plan_hourglass_kernel<0, "
          "true>((anonymous namespace)::Operands, float const*)", 100, 300,
          tid=7),
        X("kernel", "void (anonymous namespace)::plan_hourglass_kernel<0, "
          "true>((anonymous namespace)::Operands, float const*)", 1100, 500,
          tid=7),
        X("kernel", "my_plan_hourglass_kernel_x", 1700, 50, tid=7),
    ]
    t = Trace(events, calls=2)
    ctx = session.Context(t, {}, 600 * 400, 163852, 16, t.frames)
    ms = metric_module("hourglass_ms").read(ctx)
    assert ms == pytest.approx(0.4)
    pct = metric_module("hourglass_roofline_pct")
    pairs = 3750 * 5121
    least = max(pairs * pct.OPS_PER_PAIR / 67e12 * 1e3,
                (5121 * 28 + 3750 * 48 + pairs / 8) / 3.35e12 * 1e3)
    assert pct.least_ms(600 * 400, 16, 163852) == pytest.approx(least)
    assert pct.OPS_PER_PAIR == 90
    assert pct.read(ctx) == pytest.approx(100 * least / 0.4)
    assert 0 < pct.read(ctx) < 100
    assert re.search(program_kernels(), events[3]["name"])
    assert metric_module("torch_ops_ms").read(ctx) == pytest.approx(0.025)
    none = session.Context(Trace(events[:3], calls=2), {}, 1, 1, 16, 2)
    assert metric_module("hourglass_ms").read(none) is None
    assert pct.read(none) is None
    assert pct.read(session.Context(None, {}, 1, 1, 16, 0)) is None
