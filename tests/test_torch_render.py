"""PyTorch port, the slice: ``render_radiance(mode="tiled")`` +
``finalize_image`` vs the JAX package's tiled frame.

The JAX frame runs through ``render_flat_tiled`` with its fused nearest and
from-t any-hit kernels (interpret mode); spies assert that both were taken.
The frames of the branch switches (textured smooth-normal soft shadows,
sub-groups, the prepass, no attribute fetch, fused Phong or the fused
shadow off) run against JAX's frame with the same switches, spies on
``tiled_t`` showing which of its steps ran.  Image bars are the JAX
package's own (tests/test_tiled.py:90-94): within 1 on >= 99.9% of pixels,
equal on >= 98%.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import (from_jax_prepared,
                                                        prepare)
from simple_raytracer_tpu_torch.kernels import anyhit, nearest, table, tiled
from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
from simple_raytracer_tpu_torch.render.renderer import render, render_radiance

from simple_raytracer_tpu.accel.prepared import prepare as jprepare

from _torch_parity import (FOCAL, HEIGHT, LIGHT, TILE_PX, VIEW, WIDTH,
                           configs, jax_prepared_arrays, managers)
from _torch_parity import jax_frame as _jax_frame

VIEWS = {"identity": None, "moved": VIEW}


@pytest.fixture(scope="module")
def frames():
    """(JAX image, port image) per view, each computed once."""
    mp = pytest.MonkeyPatch()
    try:
        _, jsm = managers()
        cfg, jcfg = configs()
        jprep = jprepare(jsm.build(), jcfg)
        prep = from_jax_prepared(jax_prepared_arrays(jprep),
                                 num_triangles=int(jprep.num_triangles),
                                 device="cpu")
        out = {}
        for name, vm in VIEWS.items():
            jimg = _jax_frame(jprep, jcfg, vm, mp)
            img = render(prep, cfg, LIGHT, view_matrix=vm).numpy()
            out[name] = (jimg, img)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("view", list(VIEWS))
def test_frame_matches_jax(frames, view):
    jimg, img = frames[view]
    assert img.shape == (HEIGHT, WIDTH, 3) and img.dtype == np.uint8
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    bg = (img == np.array([173, 216, 230])).all(-1)
    assert 0.2 < (~bg).mean() < 0.95


def test_frame_shadow_dims_pixels():
    """The shadow pass darkens what the unshadowed frame lights."""
    sm, _ = managers()
    cfg, _ = configs()
    prep = prepare(sm.build(), cfg, device="cpu")
    on = render(prep, cfg, LIGHT).numpy().astype(int)
    off = render(prep, cfg.replace(light=sr.LightConfig(enable_shadows=False)),
                 LIGHT).numpy().astype(int)
    dimmed = (off - on).max(axis=-1) > 0
    assert dimmed.sum() > 200
    assert ((off - on) >= 0).all()


def test_render_prepares_a_scene_and_counts_no_launch_on_cpu():
    sm, _ = managers(2)
    cfg, _ = configs()
    n0 = table.calls()
    scene = sm.build()
    img = render(scene, cfg, LIGHT, device="cpu")
    rad, hit = render_radiance(prepare(scene, cfg, device="cpu"), cfg, LIGHT)
    assert img.shape == (HEIGHT, WIDTH, 3)
    assert rad.shape == (HEIGHT, WIDTH, 3) and hit.shape == (HEIGHT, WIDTH)
    assert torch.isfinite(rad).all() and 0.2 < hit.float().mean() < 0.95
    # CPU tensors take the plain versions: no kernel launch is counted
    assert table.calls() == n0


def test_ragged_frame_size():
    """A frame that is not a whole number of tiles renders its padded
    tiles and crops them, like the JAX package."""
    sm, jsm = managers(2)
    cam = dict(width=100, height=70, focal=FOCAL)
    cfg = sr.default_config().replace(mode="tiled",
                                      camera=sr.CameraConfig(**cam))
    img = render(sm.build(), cfg, LIGHT, device="cpu").numpy()
    from simple_raytracer_tpu import config as jconfig
    from simple_raytracer_tpu.render.renderer import render as jrender
    jcfg = jconfig.default_config().replace(
        mode="tiled", camera=jconfig.CameraConfig(**cam))
    jimg = np.asarray(jrender(jsm.build(), jcfg, jnp.asarray(LIGHT)))
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert img.shape == (70, 100, 3)
    assert (diff <= 1).mean() > 0.999 and (diff == 0).mean() > 0.98


# ROADMAP.md items ported since their case was written, and the branch
# their frames take now: 7e (soft shadows on textured or smooth-normal
# scenes) is the sublane gather branch, 7d (one-sample smooth-normal
# frames) the fused branch in K1's smooth mode;
# test_switch_frame_matches_jax and tests/test_torch_fused_modes.py hold
# their images to JAX's.  3 (bruteforce) and 8 (BVH) are modes of their
# own, with no tiled branch (None): they render;
# tests/test_torch_bruteforce.py and tests/test_torch_bvh.py hold their
# images to JAX's.  7f (the tiled configurations that raised) takes a
# branch by the field it changes: a hit_tile sub-tile and normalized
# directions K1's fetch mode over the explicit rays (soft), cull_maxv=0
# the range-only walks (gather); tests/test_torch_tiled_configs.py holds
# their images to JAX's
PORTED = {"item 7e": "gather", "item 7d": "fused", "item 3": None,
          "item 8": None,
          "item 7f": {"hit_tile": "soft", "cull_maxv": "gather",
                      "camera": "soft"}}


@pytest.mark.parametrize("change, item", [
    (dict(mode="bruteforce"), "item 3"),
    (dict(mode="bvh"), "item 8"),
    (dict(light=sr.LightConfig(num_samples=4),
          shading=sr.ShadingConfig(smooth_normals=True)), "item 7e"),
    (dict(shading=sr.ShadingConfig(smooth_normals=True)), "item 7d"),
    (dict(hit_tile=1024), "item 7f"),
    (dict(cull_maxv=0), "item 7f"),
    (dict(camera=sr.CameraConfig(width=WIDTH, height=HEIGHT,
                                 normalize_dirs=True)), "item 7f"),
])
def test_unported_branches_raise(change, item):
    """Every item these cases were written for is ported (``PORTED``): a
    frame of each is accepted and takes its branch, or, in a mode of its
    own, renders; the tiled frames of item 7f render too."""
    sm, _ = managers(1)
    cfg, _ = configs()
    prep = prepare(sm.build(), cfg, device="cpu")
    c = cfg.replace(**change)
    if PORTED[item] is not None:
        want = PORTED[item]
        if isinstance(want, dict):
            want = want[next(iter(change))]
        tiled.check_supported(prep, c, TILE_PX * TILE_PX)
        assert tiled.frame_branch(prep, c, TILE_PX * TILE_PX) == want
        if item != "item 7f":
            return
    img = render(prep, c, LIGHT)
    bg = (img == torch.tensor([173, 216, 230], dtype=torch.uint8)).all(-1)
    assert img.shape == (HEIGHT, WIDTH, 3) and 0.05 < float(
        (~bg).float().mean()) < 0.99


def test_hit_tile_at_least_the_tile_renders_the_full_tile():
    """hit_tile >= the tile is the full tile, as in JAX: a 128x64 frame
    with hit_tile = 2 x tile equals the hit_tile=0 frame pixel for pixel;
    a sub-tile renders the explicit rays in quarter tiles, with the full
    tile's winners on every lane and its image at JAX's bars."""
    sm, _ = managers(1)
    cfg, _ = configs()
    cfg = cfg.replace(camera=sr.CameraConfig(width=128, height=64,
                                             focal=FOCAL))
    prep = prepare(sm.build(), cfg, device="cpu")
    tile = TILE_PX * TILE_PX
    img = render(prep, cfg, LIGHT).numpy()
    big = render(prep, cfg.replace(hit_tile=2 * tile), LIGHT).numpy()
    assert img.shape == (64, 128, 3)
    assert np.array_equal(big, img)
    sub = cfg.replace(hit_tile=tile // 4)
    assert tiled.frame_branch(prep, sub, tile) == "soft"
    simg = render(prep, sub, LIGHT).numpy()
    diff = np.abs(simg.astype(int) - img.astype(int))
    assert (diff <= 1).mean() > 0.999 and (diff == 0).mean() > 0.98
    cs = (None, FOCAL, 128, 64, TILE_PX)
    o, d, _, _ = primary_rays_tiled(128, 64, TILE_PX, FOCAL)
    t, idx, *_ = nearest.hits_shaded(prep, cfg, torch.tensor(LIGHT), cs,
                                     cfg.cull_maxv)
    st, sidx, _ = nearest.hits_attrs(prep, cfg, None, cfg.cull_maxv,
                                     rays=(o.reshape(-1, 3),
                                           d.reshape(-1, 3)),
                                     tile=tile // 4)
    assert torch.isfinite(t).any()
    assert torch.equal(st, t) and torch.equal(sidx, idx)


def test_render_radiance_needs_prepared_scene():
    sm, _ = managers(1)
    cfg, _ = configs()
    with pytest.raises(TypeError):
        render_radiance(sm.build(), cfg, LIGHT)
    with pytest.raises(ValueError):
        render(sm.build(), cfg.replace(mode="nope"), LIGHT, device="cpu")


# frames of the branch switches: (textured + smooth normals, samples, port
# KernelConfig fields, JAX environment, JAX KernelConfig fields, the port's
# branch, the steps of JAX tiled_t it runs)
GATHER_STEPS = ("hits", "anyhit")
SWITCHES = {
    "textured_smooth_s4": (True, 4, {}, {}, {}, "gather", GATHER_STEPS),
    # no fused mode holds both a texture and smooth normals: JAX's prepare
    # gives the scene no attribute layout, so even S = 1 gathers
    "textured_smooth_s1": (True, 1, {}, {}, {}, "gather", GATHER_STEPS),
    "textured_smooth_s4_grouped": (True, 4, dict(groups=4, groups_ah=4), {},
                                   {}, "gather", GATHER_STEPS),
    "flat_prepass": (False, 1, dict(prepass=True),
                     {"SRT_TILED_PREPASS": "1"}, {}, "gather", GATHER_STEPS),
    "flat_no_fetch": (False, 1, dict(attr_fetch=False), {},
                      dict(attr_fetch=False), "gather", GATHER_STEPS),
    "flat_no_fused_phong": (False, 1, dict(fused_phong=False), {},
                            dict(fused_phong=False), "soft",
                            ("hits_attrs", "anyhit")),
    "textured_smooth_no_fused_phong": (True, 1, dict(fused_phong=False), {},
                                       dict(fused_phong=False), "gather",
                                       GATHER_STEPS),
    "flat_no_fused_shadow": (False, 1, dict(fused_shadow=False), {},
                             dict(fused_shadow=False), "legacy",
                             ("hits_shaded", "anyhit")),
}
SPIED = ("hits", "hits_attrs", "hits_shaded", "anyhit", "anyhit_from_t")


@pytest.fixture(scope="module")
def gather_scenes():
    """The parity scene and its textured smooth-normal variant, in both
    packages, with the same triangle order."""
    out = {}
    for textured in (False, True):
        _, jsm = managers(textured=textured)
        cfg, jcfg = configs()
        jprep = jprepare(jsm.build(), jcfg)
        out[textured] = (from_jax_prepared(
            jax_prepared_arrays(jprep), has_textures=textured,
            num_triangles=int(jprep.num_triangles), device="cpu"), jprep)
    return out


@pytest.mark.parametrize("frame", list(SWITCHES))
def test_switch_frame_matches_jax(gather_scenes, frame, monkeypatch):
    """Frames of the branch switches through both packages, each package
    taking the branch the switches choose.  JAX cannot plan sub-groups (its
    grouped planner raises NameError), so the grouped frame is held to
    JAX's ungrouped image: the sub-groups skip work, never hits."""
    tex, S, kc, env, jkc, branch, steps = SWITCHES[frame]
    prep, jprep = gather_scenes[tex]
    cfg, jcfg = configs(num_samples=S)
    cfg = cfg.replace(kernel=sr.KernelConfig(**kc),
                      shading=sr.ShadingConfig(smooth_normals=tex))
    jcfg = jcfg.replace(kernel=dataclasses.replace(jcfg.kernel, **jkc),
                        shading=type(jcfg.shading)(smooth_normals=tex))
    assert tiled.frame_branch(prep, cfg, TILE_PX * TILE_PX) == branch
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jimg = _jax_frame(jprep, jcfg, VIEW, monkeypatch, spied=SPIED,
                      expect=steps)
    n0 = table.calls()
    img = render(prep, cfg, LIGHT, view_matrix=VIEW).numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert table.calls() == n0
    diff = np.abs(img.astype(int) - jimg.astype(int))
    print(f"switch frame {frame}: {int((diff > 0).any(-1).sum())} pixels "
          f"differ, max {int(diff.max())}")
    assert (diff <= 1).mean() > 0.999, diff.max()
    assert (diff == 0).mean() > 0.98
    bg = (img == np.array(cfg.background, np.uint8)).all(-1)
    assert 0.2 < (~bg).mean() < 0.95
