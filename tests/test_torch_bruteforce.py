"""PyTorch port, the bruteforce mode and the ops it needs, against the JAX
package's (plain jnp there, plain PyTorch here).

* ``ops/camera.py``: ``primary_rays`` and ``primary_rays_world`` (a rigid
  and a general view, normalized or not) equal JAX's bit for bit;
* ``ops/intersect.py``: ``slab_test_origin`` and ``slab_test`` on random
  boxes, with zero direction components and origins on slab planes (the
  NaN of 0/0 must read as a miss), equal JAX's on every lane;
  ``nearest_hit`` equals JAX's;
* ``render/renderer.py``: ``brute_force_hits`` against JAX at the JAX
  package's bars (tests/test_tiled.py:74-94: t rtol 1e-4 / atol 1e-6, idx
  equal on >= 99.9% of rays), with ray chunks and a ragged tail; the
  triangle passes equal one pass bit for bit; a duplicated triangle gives
  the lower index; an empty scene misses; ``brute_force_shadow`` equals
  JAX's on every lane with and without max-t;
* ``render`` in bruteforce mode against JAX's bruteforce image (within 1
  on >= 99.9% of pixels, equal on >= 98%) under the ShadingConfig and
  LightConfig toggles of PARITY.md rows 11-21, a view matrix, a raw Scene
  and a PreparedScene; ray chunks change nothing; the port's own tiled
  image against its bruteforce image at the same bars.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.ops import camera as tcam
from simple_raytracer_tpu_torch.ops import intersect as tisect
from simple_raytracer_tpu_torch.render import renderer as trender
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import pad_rays

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.ops import camera as jcam
from simple_raytracer_tpu.ops import intersect as jisect
from simple_raytracer_tpu.render import renderer as jrender
from simple_raytracer_tpu.utils import pad_rays as jpad_rays

from _torch_parity import FOCAL, HEIGHT, LIGHT, VIEW, WIDTH, managers

RNG_VIEW = np.random.default_rng(5).normal(size=(4, 4)).astype(np.float32)
VIEWS = {"none": None, "rigid": VIEW, "general": RNG_VIEW}


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


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("view", list(VIEWS))
def test_primary_rays_match_jax_bit_for_bit(view, normalize):
    W, H = 150, 70
    V = VIEWS[view]
    if V is None:
        o, d = tcam.primary_rays(W, H, FOCAL, normalize)
        jo, jd = jcam.primary_rays(W, H, FOCAL, normalize)
    else:
        o, d = tcam.primary_rays_world(W, H, V, FOCAL, normalize)
        jo, jd = jcam.primary_rays_world(W, H, jnp.asarray(V), FOCAL,
                                         normalize)
    assert o.shape == d.shape == (H, W, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def _slab_cases(n: int = 4096):
    """Random boxes and rays, with zero direction components and origins
    on a slab plane (0/0 = NaN there) in about a third of the lanes."""
    rng = np.random.default_rng(11)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 4, (n, 3)).astype(np.float32)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    # aimed near the box: about half the rays hit
    d = ((lo + hi) / 2 - o + rng.normal(scale=2.5, size=(n, 3))
         * np.sign(rng.normal(size=(n, 1)))).astype(np.float32)
    axis = rng.integers(0, 3, n)
    zero = rng.random(n) < 0.3
    d[zero, axis[zero]] = 0.0
    on = rng.random(n) < 0.3
    plane = np.where(rng.random((n, 1)) < 0.5, lo, hi)
    o[on, axis[on]] = plane[on, axis[on]]
    both = zero & on
    assert both.sum() > 100
    return o, d, lo, hi


def test_slab_tests_match_jax_on_every_lane():
    o, d, lo, hi = _slab_cases()
    got = tisect.slab_test(*(torch.from_numpy(x) for x in (o, d, lo, hi)))
    want = np.asarray(jisect.slab_test(*(jnp.asarray(x)
                                         for x in (o, d, lo, hi))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.1 < want.mean() < 0.9
    # boxes around the origin and planes through it for the origin test
    lo0, hi0 = lo - o, hi - o
    lo0[:64, 0] = 0.0
    got = tisect.slab_test_origin(*(torch.from_numpy(x)
                                    for x in (d, lo0, hi0)))
    want = np.asarray(jisect.slab_test_origin(*(jnp.asarray(x)
                                                for x in (d, lo0, hi0))))
    np.testing.assert_array_equal(got.numpy(), want)


def _soup(n: int = 300, seed: int = 3):
    """A random triangle soup [n, 3, 3] in front of the origin."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-6, 6, (n, 1, 3)) + np.array([0, 0, 20.0])
    return (c + rng.normal(scale=2.0, size=(n, 3, 3))).astype(np.float32)


def _rays(n: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), np.ones((n, 1))],
                       axis=1).astype(np.float32)
    return o, d


def test_nearest_hit_matches_jax():
    """One ray at a time, at JAX's bars (Möller–Trumbore rounds apart in
    the last bits: XLA contracts its products)."""
    v = _soup()
    o, d = _rays(64)
    got = [tisect.nearest_hit(torch.from_numpy(o[k]), torch.from_numpy(d[k]),
                              torch.from_numpy(v)) for k in range(64)]
    want = [jisect.nearest_hit(jnp.asarray(o[k]), jnp.asarray(d[k]),
                               jnp.asarray(v)) for k in range(64)]
    _hit_bars([float(t) for t, _ in got], [int(i) for _, i in got],
              [float(t) for t, _ in want], [int(i) for _, i in want])
    assert 10 < sum(int(i) >= 0 for _, i in got) < 64


class _Soup:
    """The scene fields the bruteforce walk reads: w = 1 vertices and one
    object id per triangle, for both packages."""

    def __init__(self, v, obj, jax_side=False):
        h = np.concatenate([v, np.ones(v.shape[:2] + (1,), np.float32)], -1)
        self.verts = jnp.asarray(h) if jax_side else torch.from_numpy(h)
        self.tri_obj = (jnp.asarray(obj) if jax_side
                        else torch.from_numpy(obj))

    def verts_cart(self):
        return self.verts[..., :3] / self.verts[..., 3:4]


def _soups(v, obj=None):
    obj = np.zeros(len(v), np.int32) if obj is None else obj
    return _Soup(v, obj), _Soup(v, obj, True)


@pytest.mark.parametrize("chunk", [0, 1000])
def test_brute_force_hits_match_jax(chunk):
    """1,900 rays (a ragged last chunk of 900 with ``chunk``) against the
    soup: at JAX's bars, and equal to the unchunked walk."""
    ts, js = _soups(_soup())
    o, d = _rays(1900)
    t, idx = trender.brute_force_hits(ts, torch.from_numpy(o),
                                      torch.from_numpy(d), chunk=chunk)
    jt, jidx = jrender.brute_force_hits(js, jnp.asarray(o), jnp.asarray(d),
                                        chunk=chunk)
    assert t.shape == idx.shape == (1900,) and idx.dtype == torch.int32
    _hit_bars(t, idx, jt, jidx)
    assert 0.2 < np.isfinite(np.asarray(jt)).mean() < 0.99
    t0, i0 = trender.brute_force_hits(ts, torch.from_numpy(o),
                                      torch.from_numpy(d))
    assert torch.equal(t, t0) and torch.equal(idx, i0)


def _passes_of(monkeypatch, tris: int, rays: int):
    """Cut the bruteforce walk's passes to ``tris`` triangles for
    ``rays`` rays."""
    monkeypatch.setattr(trender, "PAIRS_PER_PASS", tris * rays)


@pytest.mark.parametrize("per_pass", [1, 7, 64])
def test_triangle_passes_equal_one_pass(monkeypatch, per_pass):
    """The walk over triangles in passes of ``per_pass`` (merged with
    strict < in ascending order) equals one pass over all, bit for bit;
    ties included (every triangle is there twice)."""
    v = _soup(150)
    ts, _ = _soups(np.concatenate([v, v]))
    o, d = (torch.from_numpy(x) for x in _rays(700))
    _passes_of(monkeypatch, 300, 700)
    t1, i1 = trender.brute_force_hits(ts, o, d)
    _passes_of(monkeypatch, per_pass, 700)
    t, idx = trender.brute_force_hits(ts, o, d)
    assert torch.equal(t, t1) and torch.equal(idx, i1)
    hit = idx >= 0
    assert hit.float().mean() > 0.2 and bool((idx[hit] < 150).all())


def test_duplicated_triangle_gives_the_lower_index(monkeypatch):
    v = _soup(20)
    ts, js = _soups(np.concatenate([v[:10], v[3:4], v[10:]]))
    o, d = (torch.from_numpy(x) for x in _rays(400))
    _passes_of(monkeypatch, 4, 400)
    t, idx = trender.brute_force_hits(ts, o, d)
    jt, jidx = jrender.brute_force_hits(js, jnp.asarray(o.numpy()),
                                        jnp.asarray(d.numpy()))
    assert bool((idx != 10).all()) and int((idx == 3).sum()) > 0
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_empty_scene_misses_every_ray():
    ts, js = _soups(np.zeros((0, 3, 3), np.float32))
    o, d = (torch.from_numpy(x) for x in _rays(10))
    t, idx = trender.brute_force_hits(ts, o, d)
    assert bool(torch.isinf(t).all()) and bool((idx == -1).all())
    assert idx.dtype == torch.int32
    assert not bool(trender.brute_force_shadow(ts)(o, d, idx).any())


@pytest.mark.parametrize("no_max_t", [True, False])
def test_brute_force_shadow_matches_jax_on_every_lane(monkeypatch, no_max_t):
    """Shadow rays from points among the soup toward lights on both sides:
    other-object hits at any t >= 0, or only t <= 1, as JAX finds them."""
    v = _soup(240)
    obj = (np.arange(240) % 3).astype(np.int32)
    ts, js = _soups(v, obj)
    rng = np.random.default_rng(9)
    pts = (rng.uniform(-6, 6, (2000, 3)) + [0, 0, 20.0]).astype(np.float32)
    light = np.where(rng.random((2000, 1)) < 0.5, [0.0, 0.0, -10.0],
                     [3.0, -2.0, 45.0]).astype(np.float32)
    self_obj = rng.integers(0, 3, 2000).astype(np.int32)
    _passes_of(monkeypatch, 50, 2000)
    f = trender.brute_force_shadow(ts, no_max_t=no_max_t)(
        *(torch.from_numpy(x) for x in (pts, light, self_obj)))
    jf = jrender.brute_force_shadow(js, no_max_t=no_max_t)(
        *(jnp.asarray(x) for x in (pts, light, self_obj)))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert 0.05 < f.float().mean() < 0.95


def test_pad_rays_matches_jax():
    o, d = _rays(37)
    po, pd, R = pad_rays(torch.from_numpy(o), torch.from_numpy(d), 16)
    jo, jd, jR = jpad_rays(jnp.asarray(o), jnp.asarray(d), 16)
    assert R == jR == 37 and po.shape == (48, 3)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


# frames against JAX's bruteforce image: (textured scene, port config
# changes, the same for JAX's config classes, view)
def _cases():
    sd = dict(double_sided_diffuse=False, specular_nl_factor=False)
    return {
        "default": (False, {}, None),
        "moved": (False, {}, VIEW),
        "no_shadows": (False, dict(light=dict(enable_shadows=False)), None),
        "max_t": (False, dict(light=dict(shadow_no_max_t=False)), VIEW),
        "no_tonemap": (False, dict(shading=dict(tonemap_enabled=False)),
                       None),
        "no_quirks": (False, dict(shading=sd), VIEW),
        "soft_s4": (False, dict(light=dict(num_samples=4)), VIEW),
        "smooth": (False, dict(shading=dict(smooth_normals=True)), VIEW),
        "textured": (True, {}, None),
    }


CASES = _cases()


def _config_pair(change: dict, mode: str = "bruteforce"):
    cam = dict(width=WIDTH, height=HEIGHT, focal=FOCAL)
    cfg = sr.default_config().replace(
        mode=mode, camera=sr.CameraConfig(**cam),
        light=sr.LightConfig(**change.get("light", {})),
        shading=sr.ShadingConfig(**change.get("shading", {})))
    jcfg = jconfig.default_config().replace(
        mode=mode, camera=jconfig.CameraConfig(**cam),
        light=jconfig.LightConfig(**change.get("light", {})),
        shading=jconfig.ShadingConfig(**change.get("shading", {})))
    return cfg, jcfg


@pytest.fixture(scope="module")
def scenes():
    """(port Scene, JAX Scene) of the parity scene (icosphere(2) on the
    box ground) and of its textured variant."""
    out = {}
    for textured in (False, True):
        sm, jsm = managers(2, textured=textured)
        out[textured] = (sm.build(), jsm.build())
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_bruteforce_frame_matches_jax(scenes, case):
    textured, change, view = CASES[case]
    scene, jscene = scenes[textured]
    cfg, jcfg = _config_pair(change)
    img = trender.render(scene, cfg, LIGHT, view_matrix=view,
                         device="cpu").numpy()
    jimg = np.asarray(jrender.render(
        jscene, jcfg, jnp.asarray(LIGHT),
        view_matrix=None if view is None else jnp.asarray(view)))
    assert img.dtype == np.uint8 and img.shape == (HEIGHT, WIDTH, 3)
    _image_bars(img, jimg)
    bg = (img == np.array([173, 216, 230])).all(-1)
    assert 0.05 < (~bg).mean() < 0.99


def test_prepared_scene_and_ray_chunks_give_the_same_frame(scenes):
    """A PreparedScene renders its (reordered, padded) scene to the same
    image as the raw Scene; ray chunks of 1,000 (a ragged, padded last
    chunk) equal one chunk bit for bit; the default config is bruteforce
    and its render is not on the CPU unless asked."""
    scene, _ = scenes[False]
    cfg, _ = _config_pair(dict(light=dict(num_samples=2)))
    assert sr.default_config().mode == "bruteforce"
    whole = trender.render(scene, cfg, LIGHT, VIEW, device="cpu")
    chunked = trender.render(scene, cfg.replace(ray_chunk=1000), LIGHT, VIEW,
                             device="cpu")
    assert torch.equal(whole, chunked)
    prep = prepare(scene, cfg.replace(mode="tiled"), device="cpu")
    _image_bars(trender.render(prep, cfg, LIGHT, VIEW).numpy(),
                whole.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trender.render(scene, cfg, LIGHT)


@pytest.mark.parametrize("textured", [False, True])
def test_tiled_frame_matches_bruteforce(scenes, textured):
    """The port's tiled frame (the fused branch, the kernels' plain
    versions) against its bruteforce frame at JAX's bars: texel seams may
    round apart (ROADMAP.md §3), within the bars."""
    scene, _ = scenes[textured]
    cfg, _ = _config_pair({})
    bf = trender.render(scene, cfg, LIGHT, VIEW, device="cpu").numpy()
    tiled = trender.render(scene, cfg.replace(mode="tiled"), LIGHT, VIEW,
                           device="cpu").numpy()
    _image_bars(tiled, bf)


def test_bruteforce_empty_scene_is_background():
    sm = sr.SceneManager()
    sm.set_triangles("nothing", P.mesh_from_triangles(
        np.zeros((0, 3, 3), np.float32)))
    cfg, _ = _config_pair({})
    cfg = cfg.replace(camera=sr.CameraConfig(width=16, height=8))
    img = trender.render(sm.build(), cfg, LIGHT, device="cpu")
    assert bool((img == torch.tensor([173, 216, 230],
                                     dtype=torch.uint8)).all())
