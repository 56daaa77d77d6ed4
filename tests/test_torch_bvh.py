"""PyTorch port, the BVH mode against the JAX package's (a ``lax.while_loop``
per ray under ``vmap`` there, one walk batched over rays here).

* ``accel/prepared.py``: the flattened BVH (``node_min``, ``node_max``,
  ``skip``, ``leaf_first``, ``leaf_count``, ``num_nodes``, ``max_leaf``)
  equals JAX ``prepare``'s exactly, under median and SAH splits, on a
  two-object and a textured scene;
* ``accel/traverse.py``: ``bvh_hits`` against JAX's at the JAX package's
  bars (tests/test_tiled.py:74-94: t rtol 1e-4 / atol 1e-6, idx equal on
  >= 99.9% of rays) and against the port's bruteforce hits; the BVH shadow
  equals JAX's on every lane with and without max-t; a ray stops once it
  finds an occluder;
* ``render`` in BVH mode against JAX's BVH image (within 1 on >= 99.9% of
  pixels, equal on >= 98%): shadows on and off, S = 4, smooth normals, a
  textured scene, a view matrix, a raw Scene prepared by ``render``; an
  empty scene renders background.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel import traverse
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.render import renderer as trender
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.accel import traverse as jtraverse
from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.render import renderer as jrender

from _torch_parity import FOCAL, HEIGHT, LIGHT, VIEW, WIDTH, managers

NODE_FIELDS = ("node_min", "node_max", "skip", "leaf_first", "leaf_count")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when
    other test processes load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image_bars(img, jimg):
    diff = np.abs(np.asarray(img).astype(int) - np.asarray(jimg).astype(int))
    assert img.shape == jimg.shape
    assert (diff <= 1).mean() >= 0.999, diff.max()
    assert (diff == 0).mean() >= 0.98


def _hit_bars(t, idx, jt, jidx):
    t, jt = np.asarray(t), np.asarray(jt)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(t[fin], jt[fin], rtol=1e-4, atol=1e-6)
    assert (np.asarray(idx) == np.asarray(jidx)).mean() >= 0.999


def _configs(split: str = "sah", **change):
    cam = dict(width=WIDTH, height=HEIGHT, focal=FOCAL)
    cfg = sr.default_config().replace(
        mode="bvh", camera=sr.CameraConfig(**cam),
        light=sr.LightConfig(**change.get("light", {})),
        shading=sr.ShadingConfig(**change.get("shading", {})),
        bvh=sr.BVHConfig(split=split))
    jcfg = jconfig.default_config().replace(
        mode="bvh", camera=jconfig.CameraConfig(**cam),
        light=jconfig.LightConfig(**change.get("light", {})),
        shading=jconfig.ShadingConfig(**change.get("shading", {})),
        bvh=jconfig.BVHConfig(split=split))
    return cfg, jcfg


@pytest.fixture(scope="module")
def prepared():
    """(port PreparedScene, JAX PreparedScene) of the parity scene
    (icosphere(2) on the box ground) and its textured variant, by split;
    the port's from its own ``prepare``."""
    out = {}
    for textured in (False, True):
        sm, jsm = managers(2, textured=textured)
        for split in ("median", "sah"):
            cfg, jcfg = _configs(split)
            out[textured, split] = (prepare(sm.build(), cfg, device="cpu"),
                                    jprepare(jsm.build(), jcfg))
    return out


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("split", ["median", "sah"])
def test_bvh_arrays_equal_jax(prepared, split, textured):
    prep, jprep = prepared[textured, split]
    for name in NODE_FIELDS:
        got, want = getattr(prep, name).numpy(), np.asarray(getattr(jprep,
                                                                    name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert prep.num_nodes == jprep.num_nodes > 10
    assert prep.max_leaf == jprep.max_leaf
    # the leaf windows stay inside the padded triangle array
    last = int((prep.leaf_first + prep.max_leaf).max())
    assert last <= prep.scene.num_triangles


def _steps(walk: str) -> int:
    """The most steps one call of ``walk`` took since the counters' reset
    (the ``traverse.*.steps`` counters)."""
    return metrics.counts().get(f"traverse.{walk}.steps", 0)


def _rays(view):
    o, d = tcam.primary_rays_world(WIDTH, HEIGHT, view, FOCAL)
    return o.reshape(-1, 3), d.reshape(-1, 3)


@pytest.mark.parametrize("split", ["median", "sah"])
def test_bvh_hits_match_jax_and_bruteforce(prepared, split):
    """The parity view's primary rays: the walk's (t, idx) against JAX's
    walk and against the port's bruteforce hits over the same (BVH-order)
    triangles."""
    prep, jprep = prepared[False, split]
    o, d = _rays(VIEW)
    metrics.reset_counts("traverse.")
    t, idx = traverse.bvh_hits(prep, o, d)
    jt, jidx = jtraverse.bvh_hits(jprep, jnp.asarray(o.numpy()),
                                  jnp.asarray(d.numpy()))
    assert idx.dtype == torch.int32 and t.shape == (WIDTH * HEIGHT,)
    _hit_bars(t, idx, jt, jidx)
    bt, bidx = trender.brute_force_hits(prep.scene, o, d)
    _hit_bars(t, idx, bt, bidx)
    assert 0.2 < float(torch.isfinite(t).float().mean()) < 0.99
    assert 0 < _steps("nearest_hit") <= prep.num_nodes


@pytest.mark.parametrize("no_max_t", [True, False])
def test_bvh_shadow_matches_jax_on_every_lane(prepared, no_max_t):
    """Shadow rays from the parity view's hit points toward the light, and
    from the same points toward a light behind the sphere (so max-t
    matters): found equal to JAX's on every lane, and to the port's
    bruteforce shadow."""
    prep, jprep = prepared[False, "sah"]
    o, d = _rays(VIEW)
    t, idx = traverse.bvh_hits(prep, o, d)
    hit = torch.isfinite(t)
    pts = (o + t[:, None] * d)[hit]
    obj = prep.scene.tri_obj[idx[hit].long()]
    lights = torch.tensor([LIGHT, (0.5, 0.0, 70.0)], dtype=torch.float32)
    light = lights[torch.arange(pts.shape[0]) % 2]
    f = traverse.bvh_shadow_fn(prep, no_max_t=no_max_t)(pts, light, obj)
    jf = jtraverse.bvh_shadow_fn(jprep, no_max_t=no_max_t)(
        *(jnp.asarray(x.numpy()) for x in (pts, light, obj)))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    bf = trender.brute_force_shadow(prep.scene, no_max_t=no_max_t)(
        pts, light, obj)
    assert torch.equal(f, bf)
    assert 0.01 < float(f.float().mean()) < 0.99


def test_any_hit_walk_stops_once_found(prepared):
    """Rays that start inside the sphere toward the ground find it at once
    and stop: the walk takes fewer steps than the same rays' nearest walk
    (which visits every box they cross)."""
    prep, _ = prepared[False, "sah"]
    n = 256
    o = torch.tensor([[0.3, 0.2, 60.0]]).expand(n, 3).contiguous()
    d = torch.stack([torch.linspace(-0.2, 0.2, n), torch.ones(n),
                     torch.zeros(n)], dim=1)
    obj = torch.full((n,), 5, dtype=torch.int32)        # no object's id
    metrics.reset_counts("traverse.")
    found = traverse.any_hit_other(prep, o, d, obj)
    assert bool(found.all())
    traverse.bvh_hits(prep, o, d)
    assert _steps("any_hit_other") < _steps("nearest_hit")


CASES = {
    "default": (False, {}, None),
    "moved": (False, {}, VIEW),
    "no_shadows": (False, dict(light=dict(enable_shadows=False)), VIEW),
    "max_t": (False, dict(light=dict(shadow_no_max_t=False)), None),
    "soft_s4": (False, dict(light=dict(num_samples=4)), VIEW),
    "smooth": (False, dict(shading=dict(smooth_normals=True)), VIEW),
    "textured": (True, {}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bvh_frame_matches_jax(prepared, case):
    textured, change, view = CASES[case]
    prep, jprep = prepared[textured, "sah"]
    cfg, jcfg = _configs("sah", **change)
    img = trender.render(prep, cfg, LIGHT, view_matrix=view).numpy()
    jimg = np.asarray(jrender.render(
        jprep, jcfg, jnp.asarray(LIGHT),
        view_matrix=None if view is None else jnp.asarray(view)))
    assert img.dtype == np.uint8 and img.shape == (HEIGHT, WIDTH, 3)
    _image_bars(img, jimg)
    bg = (img == np.array([173, 216, 230])).all(-1)
    assert 0.05 < (~bg).mean() < 0.99


def test_frame_steps_span_its_ray_chunks(prepared):
    """After a BVH frame the walks' step counts are the frame's lockstep
    steps: the same over ragged ray chunks as in one chunk, though the last
    chunk alone walks fewer steps; the image does not change."""
    prep, _ = prepared[False, "sah"]
    cfg, _ = _configs("sah")
    chunk = 97
    img = trender.render(prep, cfg, LIGHT, VIEW)
    steps = (_steps("nearest_hit"), _steps("any_hit_other"))
    chunked = trender.render(prep, cfg.replace(ray_chunk=chunk), LIGHT, VIEW)
    assert torch.equal(chunked, img)
    assert (_steps("nearest_hit"), _steps("any_hit_other")) == steps
    o, d = _rays(VIEW)
    tail = o.shape[0] - (o.shape[0] - 1) % chunk - 1
    metrics.reset_counts("traverse.")
    traverse.bvh_hits(prep, o[tail:], d[tail:])
    assert 0 < _steps("nearest_hit") < steps[0]


def test_raw_scene_renders_through_prepare(prepared):
    """``render`` prepares a raw Scene for the BVH mode onto the device it
    is asked for (the card unless "cpu"); the frame equals the prepared
    scene's; ``render_radiance`` wants a PreparedScene."""
    sm, _ = managers(2)
    cfg, _ = _configs("median")
    prep, _ = prepared[False, "median"]
    img = trender.render(sm.build(), cfg, LIGHT, VIEW, device="cpu")
    assert torch.equal(img, trender.render(prep, cfg, LIGHT, VIEW))
    with pytest.raises(TypeError):
        trender.render_radiance(sm.build(), cfg, LIGHT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.render(sm.build(), cfg, LIGHT)


def test_bvh_empty_scene_is_background():
    sm = sr.SceneManager()
    sm.set_triangles("nothing", P.mesh_from_triangles(
        np.zeros((0, 3, 3), np.float32)))
    cfg, _ = _configs()
    cfg = cfg.replace(camera=sr.CameraConfig(width=16, height=8))
    img = trender.render(sm.build(), cfg, LIGHT, device="cpu")
    assert bool((img == torch.tensor([173, 216, 230],
                                     dtype=torch.uint8)).all())
