"""Every view of a mix's arc keeps the mesh in view (at least half as many
of its pixels as the cell's own view shows), and the mesh's shadow in
view, or out of it, as the mix expects (a small size, the reference)."""

import numpy as np
import pytest
import torch

from rtbench import spec, traffic as tr
from rtbench.reference.render import Reference
from rtbench.scenes import procedural as B

ALL = spec.with_later(spec.read_json(spec.BENCHMARK))
MIXES = sorted({(w["config"], w["traffic"]) for w in ALL["workloads"]})
WIDTH = 192


@pytest.mark.parametrize("config,mix", MIXES)
def test_arc_views_keep_the_mesh_and_the_shadow(config, mix):
    cell = spec.resolve_in(ALL, f"{config}.{mix}")
    t, cfg = tr.rehearsal(cell.traffic, cell.config, width=WIDTH)
    scene = B.textured_on_ground(3) if cfg["smooth_normals"] else \
        B.sphere_on_ground(3)
    ref = Reference(scene)
    amp = float(t["arc"]["amplitude_deg"])
    W, H = int(t["width"]), int(t["height"])
    px = torch.arange(W * H)
    base = None
    for yaw in [0.0] + list(np.linspace(-amp, amp, 7)):
        frame = tr.frame(t, cfg, tr.yaw_about(cfg["pivot"], yaw))
        o, d = ref.rays(frame, px)
        _, idx = ref.nearest(o, d)
        sphere = int((ref.tri_obj[idx.clamp_min(0)] == 0)[idx >= 0].sum())
        base = base or sphere
        assert sphere > 0.5 * base > 0, (yaw, sphere, base)
        lit = tr.frame(dict(t, shadows=False), cfg,
                       tr.yaw_about(cfg["pivot"], yaw))
        shadowed = int((ref.pixels(frame, px) != ref.pixels(lit, px))
                       .any(-1).sum())
        if t["expect"]["shadow_in_view"]:
            assert shadowed > 0, yaw
        else:
            assert shadowed == 0, (yaw, shadowed)
