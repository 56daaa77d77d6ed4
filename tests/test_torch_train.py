"""PyTorch port, the single-card trainer (``dist/train.py``) and checkpoints
(``utils/checkpoint.py``) against the JAX package's.

* ``make_train_step`` over 5 SGD steps in tiled, BVH and bruteforce mode
  against JAX ``make_train_step(jprep, bruteforce)`` on the same prepared
  scene: losses within rtol 1e-5, finite and falling; a plain Scene's
  step against JAX's; ``remat`` equal to the plain step (rtol 1e-6); the
  loss at the true params below 1e-10 with a padded band of tile rows
  (64x32 at 64-pixel tiles); ``torch.optim.Adam`` against ``optax.adam``;
  ``mesh=`` over one process equals the step without a mesh bit for bit;
* on the axis-aligned ground JAX's bruteforce step (autograd through every
  ray-triangle pair) turns vertices to NaN (rays in faces' planes, and the
  prepared scene's degenerate pad triangles, divide by a determinant of 0);
  the port's, through the winners' recompute, stays finite and falls;
* a checkpoint written by either package loads in the other, leaf for
  leaf; ``params_from_jax``; a missing file loads as None, and a failed
  save leaves no temporary file;
* the trainer's modules import no JAX.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import from_jax_prepared
from simple_raytracer_tpu_torch.dist import make_mesh
from simple_raytracer_tpu_torch.dist import train as ttrain
from simple_raytracer_tpu_torch.utils import checkpoint as tckpt

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.dist import train as jtrain
from simple_raytracer_tpu.render.renderer import render_radiance as jrender
from simple_raytracer_tpu.utils import checkpoint as jckpt

from _torch_parity import (LIGHT, jax_prepared_arrays, managers,
                           tilted_ground)

W, H, FOCAL = 64, 32, 100.0
STEPS, LR = 5, 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when
    other test processes load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    cam = dict(width=W, height=H, focal=FOCAL)
    cfg = sr.default_config().replace(camera=sr.CameraConfig(**cam),
                                      bvh=sr.BVHConfig(split="sah"))
    jcfg = jconfig.default_config().replace(
        camera=jconfig.CameraConfig(**cam), bvh=jconfig.BVHConfig(split="sah"))
    return cfg, jcfg


_SETUPS = {}


def _setup(kind: str = "tilted"):
    """(port PreparedScene, JAX PreparedScene, target [H, W, 3] numpy: JAX's
    bruteforce radiance of the true params, misses 0) of the parity scene
    with its ground "tilted" off the axes, or "flat" (axis-aligned)."""
    if kind not in _SETUPS:
        build = tilted_ground if kind == "tilted" else None
        _sm, jsm = managers(2, build=build)
        cfg, jcfg = _configs()
        jprep = jprepare(jsm.build(), jcfg.replace(mode="tiled"))
        prep = from_jax_prepared(jax_prepared_arrays(jprep), device="cpu")
        rad, hit = jrender(jprep.scene, jcfg, jnp.asarray(LIGHT))
        target = np.asarray(jnp.where(hit[..., None], rad, 0.0))
        _SETUPS[kind] = prep, jprep, target
    return _SETUPS[kind]


def _start(params, color=0.7):
    return dataclasses.replace(params, obj_color=params.obj_color * color)


def port_losses(step, scene, target, steps=STEPS):
    """Losses of ``steps`` steps from ``scene``'s params, colours x 0.7,
    and the last params."""
    params = _start(ttrain.extract_params(scene, LIGHT))
    losses = []
    for _ in range(steps):
        params, loss = step(params, torch.from_numpy(target.copy()))
        losses.append(float(loss))
    return losses, params


def jax_losses(jstep, jscene, target, steps=STEPS):
    params = _start(jtrain.extract_params(jscene, jnp.asarray(LIGHT)))
    losses = []
    for _ in range(steps):
        params, loss = jstep(params, jnp.asarray(target))
        losses.append(float(loss))
    return losses, params


_JAX_LOSSES = {}


def jax_bruteforce_losses(kind: str = "tilted"):
    if kind not in _JAX_LOSSES:
        _prep, jprep, target = _setup(kind)
        jcfg = _configs()[1].replace(mode="bruteforce")
        _JAX_LOSSES[kind] = jax_losses(
            jtrain.make_train_step(jprep, jcfg, lr=LR), jprep.scene, target)
    return _JAX_LOSSES[kind]


def _falls(losses):
    assert all(np.isfinite(losses)), losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


@pytest.mark.parametrize("mode", ["tiled", "bvh", "bruteforce"])
def test_train_step_matches_jax(mode):
    """5 SGD steps from obj_color x 0.7: the losses equal JAX's bruteforce
    step's within rtol 1e-5 and fall, and the params stay finite."""
    prep, _jprep, target = _setup()
    step = sr.make_train_step(prep, _configs()[0].replace(mode=mode), lr=LR)
    losses, params = port_losses(step, prep.scene, target)
    want, jparams = jax_bruteforce_losses()
    _falls(losses)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for p in params.leaves():
        assert torch.isfinite(p).all()
    np.testing.assert_allclose(params.obj_color.numpy(),
                               np.asarray(jparams.obj_color), rtol=1e-5)


def test_plain_scene_step_matches_jax():
    """``make_train_step`` of a plain Scene (bruteforce, the CLI's) against
    JAX's of the same Scene."""
    sm, jsm = managers(2, build=tilted_ground)
    scene, jscene = sm.build(), jsm.build()
    cfg, jcfg = _configs()
    rad, hit = jrender(jscene, jcfg, jnp.asarray(LIGHT))
    target = np.asarray(jnp.where(hit[..., None], rad, 0.0))
    losses, _ = port_losses(sr.make_train_step(scene, cfg, lr=LR), scene,
                            target)
    want, _ = jax_losses(jtrain.make_train_step(jscene, jcfg, lr=LR), jscene,
                         target)
    _falls(losses)
    np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_axis_aligned_ground_keeps_the_port_finite():
    """On the axis-aligned ground JAX's bruteforce step differentiates
    every ray-triangle pair and the pairs with a zero determinant turn its
    vertices to NaN (its loss then jumps); the port's differentiates the
    winners and falls, finite."""
    prep, _jprep, target = _setup("flat")
    want, jparams = jax_bruteforce_losses("flat")
    assert not np.isfinite(np.asarray(jparams.verts)).all()
    assert want[1] > want[0]
    for mode in ("bruteforce", "tiled"):
        step = sr.make_train_step(prep, _configs()[0].replace(mode=mode),
                                  lr=LR)
        losses, params = port_losses(step, prep.scene, target)
        _falls(losses)
        assert torch.isfinite(params.verts).all()
        assert losses[0] == pytest.approx(want[0], rel=1e-5)


@pytest.mark.parametrize("mode", ["tiled", "bvh", "bruteforce"])
def test_remat_equals_the_plain_step(mode):
    prep, _jprep, target = _setup()
    cfg = _configs()[0].replace(mode=mode)
    plain, _ = port_losses(sr.make_train_step(prep, cfg, lr=LR), prep.scene,
                           target, 3)
    remat, _ = port_losses(sr.make_train_step(prep, cfg, lr=LR, remat=True),
                           prep.scene, target, 3)
    np.testing.assert_allclose(remat, plain, rtol=1e-6)


def test_pad_band_loss_at_truth():
    """64x32 at 64-pixel tiles pads 32 rows of real rays past the frame,
    some on the ground; the mask keeps them out, so the loss at the true
    params is ~0."""
    prep, _jprep, _target = _setup()
    cfg = _configs()[0].replace(mode="tiled")
    with torch.no_grad():
        rad, hit = sr.render_radiance(prep, cfg, LIGHT)
    target = torch.where(hit[..., None], rad, 0.0)
    step = sr.make_train_step(prep, cfg, lr=0.0)
    params, loss = step(ttrain.extract_params(prep.scene, LIGHT), target)
    assert float(loss) < 1e-10, float(loss)
    assert torch.equal(params.verts, prep.scene.verts)


def test_adam_matches_optax():
    """``optimizer=`` a ``torch.optim.Adam`` factory against JAX's
    ``optimizer=optax.adam``, both in bruteforce mode: the same losses and
    params over 5 steps.  (Adam moves every vertex by about lr a step, so
    a tiled step, whose walks keep the prepared tables of the first
    vertices, would lose edge rays that the bruteforce walk keeps.)"""
    optax = pytest.importorskip("optax")
    prep, jprep, target = _setup()
    cfg, jcfg = _configs()
    lr = 1e-4
    step = sr.make_train_step(prep, cfg.replace(mode="bruteforce"),
                              optimizer=lambda ps: torch.optim.Adam(ps,
                                                                    lr=lr))
    params = _start(ttrain.extract_params(prep.scene, LIGHT))
    state = step.init(params)
    jstep = jtrain.make_train_step(jprep, jcfg.replace(mode="bruteforce"),
                                   optimizer=optax.adam(lr))
    jparams = _start(jtrain.extract_params(jprep.scene, jnp.asarray(LIGHT)))
    jstate = optax.adam(lr).init(jparams)
    losses, want = [], []
    for _ in range(STEPS):
        params, state, loss = step(params, state,
                                   torch.from_numpy(target.copy()))
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(target))
        losses.append(float(loss))
        want.append(float(jloss))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for name in ("obj_color", "obj_ambient", "light_pos"):
        np.testing.assert_allclose(getattr(params, name).numpy(),
                                   np.asarray(getattr(jparams, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_mesh_raises_distribution():
    """``make_train_step(mesh=)`` over a mesh of one process (a world of
    one, gloo) gives the loss and the gradients of the step without a
    mesh, bit for bit: the all-reduce of one process is the identity; a
    mesh of two processes, where one exists, raises."""
    prep, _jprep, target = _setup()
    cfg = _configs()[0].replace(mode="tiled")
    mesh = make_mesh(1, ("dp",), device="cpu")
    params = sr.extract_params(prep.scene, LIGHT)
    params.obj_color = params.obj_color * 0.7
    target = torch.from_numpy(np.array(target))
    want = sr.make_train_step(prep, cfg, lr=LR).value_and_grad(params,
                                                               target)
    got = sr.make_train_step(prep, cfg, mesh=mesh,
                             lr=LR).value_and_grad(params, target)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1].leaves(), want[1].leaves()):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="2 processes requested"):
        make_mesh(2, ("dp",), device="cpu")


def _jax_params(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(5, 3, 4), (2, 3), (2,), (2,), (2,), (7, 3), (3,)]
    return jtrain.DiffParams(*[jnp.asarray(rng.normal(size=s), jnp.float32)
                               for s in shapes])


def test_checkpoints_load_across_the_packages(tmp_path):
    """JAX's checkpoint of a DiffParams loads into the port's template and
    the port's into JAX's, leaf for leaf, with the step and extras."""
    jp = _jax_params()
    leaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    path = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(path, jp, 7, extra={"lr": 0.5})
    template = ttrain.params_from_jax([np.zeros_like(x) for x in leaves],
                                      device="cpu")
    params, step = tckpt.load_checkpoint(path, template)
    assert step == 7 and isinstance(params, ttrain.DiffParams)
    for a, b in zip(params.leaves(), leaves):
        np.testing.assert_array_equal(a.numpy(), b)

    mine = ttrain.params_from_jax([x * 2 for x in leaves], device="cpu")
    path = str(tmp_path / "t.npz")
    tckpt.save_checkpoint(path, mine, 9, extra={"lr": 0.25})
    restored, step = jckpt.load_checkpoint(path, jp)
    assert step == 9
    for a, b in zip(jax.tree.leaves(restored), mine.leaves()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with np.load(path) as z:
        assert float(z["extra_lr"]) == 0.25
        assert sorted(z.files) == sorted(
            [f"leaf_{i}" for i in range(7)] + ["__step__", "extra_lr"])


def test_params_from_jax_equal_extract_params():
    prep, jprep, _target = _setup()
    jp = jtrain.extract_params(jprep.scene, jnp.asarray(LIGHT))
    got = ttrain.params_from_jax([np.asarray(x) for x in jax.tree.leaves(jp)],
                                 device="cpu")
    want = ttrain.extract_params(prep.scene, LIGHT)
    for a, b in zip(got.leaves(), want.leaves()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ttrain.params_from_jax([np.zeros(3)], device="cpu")


def test_checkpoint_missing_file_and_failed_save(tmp_path, monkeypatch):
    template = ttrain.params_from_jax(
        [np.asarray(x) for x in jax.tree.leaves(_jax_params())],
        device="cpu")
    assert tckpt.load_checkpoint(str(tmp_path / "none.npz"), template) is None

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_checkpoint(str(tmp_path / "c.npz"), template, 1)
    assert os.listdir(tmp_path) == []


def test_trainer_modules_import_no_jax():
    """Each new module imports with JAX blocked (an import of jax or the
    JAX package raises), in a fresh interpreter."""
    mods = ["simple_raytracer_tpu_torch.diff.render",
            "simple_raytracer_tpu_torch.dist.train",
            "simple_raytracer_tpu_torch.utils.checkpoint",
            "simple_raytracer_tpu_torch.examples.fit_texture",
            "simple_raytracer_tpu_torch.cli"]
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['simple_raytracer_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
