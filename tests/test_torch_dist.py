"""PyTorch port, the distribution layer (``dist/``: ``multihost.py``,
``sharding.py``, ``ring.py``, the mesh paths of ``train.py``,
``driver/animation.py::frames_parallel`` and ``dryrun.py``) against the JAX
package's on its virtual 8-device CPU mesh (tests/conftest.py).

The port's side runs in gloo CPU processes, one world per shape, started
once by the module's fixture (tests/_torch_dist_worker.py): a 2-process
"dp" world joined from torchrun's environment, a 4-process "gp" world
joined from explicit arguments, and a 2 x 2 "composed" world.  The scene
is the icosphere(2) parity scene on its tilted ground
(``_torch_parity.tilted_ground``), built in numpy and given to both
packages; frames are 64x32 and 32x16.

* the data-parallel render in all three modes equals, pixel for pixel,
  the port's render of the same rays in one process, and is within JAX's
  bars of JAX's ``render_sharded`` (within 1 on >= 99.9% of pixels, equal
  on >= 98%); the tiled one is within the port's bars of the fused frame;
* the ring's (t, object, occlusion) against JAX's ring: t within rtol 1e-4
  / atol 1e-6, the object equal on >= 99.9% of rays, occlusion equal; the
  ring's overlap schedule, its plain schedule and its local schedule
  (``ring_*_local``) agree bit for bit;
* ``render_geometry_sharded`` and ``render_composed`` equal JAX's and a
  single bruteforce render on >= 99.5% of pixels (JAX's ring bar);
* the DP step's loss and ``obj_color`` after one step against the
  unsharded step (rtol 1e-5 / 1e-4, as tests/test_dist.py) in bruteforce
  and tiled mode, and against JAX's sharded step, with 5 steps descending;
* the composed step's loss and ``ReplicatedParams`` against JAX's composed
  step, carried across with ``params_from_jax``; with shadows on (which
  JAX's cannot differentiate: no JVP through its Pallas any-hit kernel)
  the port's step runs and its loss is finite;
* ``frames_parallel`` equals ``frames_batched``; ``render_turntable(mesh=)``
  on two processes writes its metrics once; ``host_local_rows``;
  ``init_distributed`` from explicit arguments, from torchrun's
  environment, a repeat call, and no call without either; ``make_mesh``
  raises with too few processes; ``dryrun_multichip(4)`` runs to its end.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.dist.dryrun import dryrun_multichip, free_port
from simple_raytracer_tpu_torch.dist.train import (ReplicatedParams,
                                                   params_from_jax)
from simple_raytracer_tpu_torch.driver.animation import frames_batched
from simple_raytracer_tpu_torch.kernels.tiled import render_flat_tiled
from simple_raytracer_tpu_torch.ops.camera import primary_rays
from simple_raytracer_tpu_torch.render.integrator import finalize_image
from simple_raytracer_tpu_torch.scene.catalog import orbit_view

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.dist import make_mesh as jmake_mesh
from simple_raytracer_tpu.dist import make_train_step as jmake_train_step
from simple_raytracer_tpu.dist import render_sharded as jrender_sharded
from simple_raytracer_tpu.dist import ring as jring
from simple_raytracer_tpu.dist.train import (extract_params as jextract,
                                             make_train_step_composed as
                                             jmake_composed)
from simple_raytracer_tpu.ops.camera import primary_rays as jprimary_rays
from simple_raytracer_tpu.render.renderer import (render as jrender,
                                                  render_radiance as
                                                  jrender_radiance)

import _torch_dist_worker as W
from _torch_parity import managers, tilted_ground

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
WORLDS = {"dp": 2, "gp": 4, "composed": 4}
EXPLICIT = ("gp",)            # worlds joined from explicit arguments
TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when
    pytest-xdist runs files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(mode="bruteforce", width=W.WIDTH, height=W.HEIGHT,
          shadows=True):
    return jconfig.default_config().replace(
        mode=mode, camera=jconfig.CameraConfig(width=width, height=height,
                                               focal=W.FOCAL),
        light=jconfig.LightConfig(enable_shadows=shadows))


def _launch(world: str, inputs: str, out_dir: str) -> list:
    """Start the processes of ``world``; returns the Popen objects."""
    n, port = WORLDS[world], free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                         "LOCAL_RANK")}
    base["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(n):
        args = [sys.executable, WORKER, world, inputs, out_dir]
        env = dict(base)
        if world in EXPLICIT:
            args += [f"127.0.0.1:{port}", str(n), str(r)]
        else:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _jax_refs(jscene, jtarget) -> dict:
    """What the JAX package computes for the same checks."""
    light = jnp.asarray(W.LIGHT, jnp.float32)
    ref = {}
    for mode in W.MODES:
        cfg = _jcfg(mode)
        op = jscene if mode == "bruteforce" else jprepare(jscene, cfg)
        ref[f"img_{mode}"] = np.asarray(
            jrender_sharded(op, cfg, light, jmake_mesh(2, ("dp",))))
    # the ring's (t, object, occlusion), as the worker's ring_queries
    o, d = jprimary_rays(W.SMALL_W, W.SMALL_H, W.FOCAL)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)

    def body(shard, o, d):
        shard = jax.tree.map(lambda a: a[0], shard)
        t, rec = jring.ring_nearest_hit(shard, o, d, eps=1e-12)
        hit = jnp.isfinite(t)
        p = jnp.where(hit[:, None],
                      o + jnp.where(hit, t, 0.0)[:, None] * d, 0.0)
        occ = jring.ring_any_hit_other(shard, p, light - p,
                                       jnp.maximum(rec["obj"], 0),
                                       eps=1e-12, hit=hit)
        return t, rec["obj"], occ
    f = jax.jit(jax.shard_map(
        body, mesh=jmake_mesh(4, ("gp",)),
        in_specs=(P("gp"), P("gp"), P("gp")),
        out_specs=(P("gp"), P("gp"), P("gp")), check_vma=False))
    ref["ring"] = [np.asarray(x) for x in f(jring.shard_geometry(jscene, 4),
                                            o, d)]
    cfg = _jcfg()
    ref["img_geometry"] = np.asarray(jring.render_geometry_sharded(
        jscene, cfg, light, jmake_mesh(4, ("gp",))))
    ref["img_composed"] = np.asarray(jring.render_composed(
        jscene, cfg, light, jmake_mesh(4, ("dp", "gp"), (2, 2))))
    ref["img_single"] = np.asarray(jrender(jscene, cfg, light))
    # the DP step (bruteforce) and the composed step, no shadows
    tcfg = _jcfg(width=W.SMALL_W, height=W.SMALL_H, shadows=False)
    p0 = jextract(jscene, light)
    p0.light_pos = p0.light_pos + 25.0
    p0.obj_color = p0.obj_color * 0.5
    step = jmake_train_step(jscene, tcfg, mesh=jmake_mesh(2, ("dp",)),
                            lr=W.LR)
    p, loss = step(p0, jtarget)
    ref["train_obj_color"] = np.asarray(p.obj_color)
    losses = [float(loss)]
    for _ in range(W.STEPS):
        p, loss = step(p, jtarget)
        losses.append(float(loss))
    ref["train_losses"] = np.array(losses)
    cstep, cp, _ = jmake_composed(jscene, tcfg,
                                  jmake_mesh(4, ("dp", "gp"), (2, 2)),
                                  lr=W.LR)
    cp.light_pos = light + 10.0
    cp.obj_color = cp.obj_color * 0.5
    cp, closs = cstep(cp, jtarget)
    ref["composed_loss"] = float(closs)
    ref["composed_leaves"] = [np.asarray(x) for x in jax.tree.leaves(cp)]
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's processes' outputs ({world: [npz of rank r]}), the JAX
    references, and the port's scene, started together: the worlds run
    while this process computes the JAX side."""
    sm, jsm = managers(2, build=tilted_ground)
    scene, jscene = sm.build(), jsm.build()
    jtarget, jhit = jrender_radiance(
        jscene, _jcfg(width=W.SMALL_W, height=W.SMALL_H, shadows=False),
        jnp.asarray(W.LIGHT, jnp.float32))
    jtarget = jnp.where(jhit[..., None], jtarget, 0.0)
    d = tmp_path_factory.mktemp("dist")
    inputs = str(d / "inputs.npz")
    np.savez(inputs, has_textures=scene.has_textures,
             target=np.asarray(jtarget),
             **{f"scene_{k}": v for k, v in scene.numpy().items()})
    procs = {w: _launch(w, inputs, str(d)) for w in WORLDS}
    try:
        ref = _jax_refs(jscene, jtarget)
        outs = {w: [p.communicate(timeout=TIMEOUT)[0] for p in ps]
                for w, ps in procs.items()}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.wait()
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"{w} rank {r}:\n{outs[w][r][-4000:]}"
    got = {w: [dict(np.load(d / f"{w}_{r}.npz"))
               for r in range(WORLDS[w])] for w in WORLDS}
    return got, ref, scene, torch.from_numpy(np.array(jtarget))


def _bars(img, ref, within=0.999, equal=0.98):
    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32)).max(-1)
    assert (diff <= 1).mean() >= within, (diff <= 1).mean()
    assert (diff == 0).mean() >= equal, (diff == 0).mean()


def _light():
    return torch.tensor(W.LIGHT)


@pytest.mark.parametrize("mode", W.MODES)
def test_dp_render_equals_one_process_and_jax(worlds, mode):
    got, ref, scene, _ = worlds
    cfg = W.frame_cfg(mode)
    img = got["dp"][0][f"img_{mode}"]
    np.testing.assert_array_equal(img, got["dp"][1][f"img_{mode}"])
    if mode == "tiled":
        prep = prepare(scene, cfg, "cpu")
        o, d = primary_rays(W.WIDTH, W.HEIGHT, W.FOCAL)
        rad, hit = render_flat_tiled(prep, cfg, _light(), None,
                                     rays=(o.reshape(-1, 3),
                                           d.reshape(-1, 3)))
        one = finalize_image(rad.reshape(W.HEIGHT, W.WIDTH, 3),
                             hit.reshape(W.HEIGHT, W.WIDTH), cfg).numpy()
        # the explicit-ray entry against the fused frame of the camera
        _bars(img, sr.render(prep, cfg, _light()).numpy())
    else:
        op = scene if mode == "bruteforce" else prepare(scene, cfg, "cpu")
        one = sr.render(op, cfg, _light(), device="cpu").numpy()
    np.testing.assert_array_equal(img, one)
    bg = (img == np.array([173, 216, 230])).all(-1)
    assert 0.05 < (~bg).mean() < 0.99
    _bars(img, ref[f"img_{mode}"])


def test_ring_matches_jax(worlds):
    got, ref, _, _ = worlds
    g = got["gp"][0]
    t, obj, occ = (g[f"ring_{k}_overlap"] for k in ("t", "obj", "occ"))
    jt, jobj, jocc = ref["ring"]
    hit = np.isfinite(t)
    np.testing.assert_array_equal(hit, np.isfinite(jt))
    assert 20 < hit.sum() < hit.size
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-4, atol=1e-6)
    assert (obj == jobj).mean() >= 0.999
    lanes = hit & (obj == jobj)
    np.testing.assert_array_equal(occ[lanes] != 0, jocc[lanes])
    assert (occ[hit] != 0).sum() > 0


def test_ring_schedules_are_bit_equal(worlds):
    got, _, _, _ = worlds
    g = got["gp"]
    for k in ("t", "obj", "occ"):
        local = g[0][f"ring_{k}_local"]
        for r in range(WORLDS["gp"]):
            for sched in ("overlap", "plain"):
                x = g[r][f"ring_{k}_{sched}"]
                assert x.tobytes() == local.tobytes(), (k, r, sched)


@pytest.mark.parametrize("what", ["geometry", "composed"])
def test_ring_frames_match_jax_and_one_process(worlds, what):
    got, ref, scene, _ = worlds
    ranks = got["gp" if what == "geometry" else "composed"]
    img = ranks[0][f"img_{what}"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(img, r[f"img_{what}"])
    single = sr.render(scene, W.frame_cfg(), _light(), device="cpu").numpy()
    for other in (single, ref[f"img_{what}"], ref["img_single"]):
        assert (img == other).all(-1).mean() >= 0.995
    bg = (img == np.array([173, 216, 230])).all(-1)
    assert 0.05 < (~bg).mean() < 0.99


@pytest.mark.parametrize("mode", ["bruteforce", "tiled"])
def test_dp_step_matches_unsharded_and_jax(worlds, mode):
    got, ref, scene, target = worlds
    g = got["dp"][0]
    cfg = W.train_cfg(mode)
    op = scene if mode == "bruteforce" else prepare(scene, cfg, "cpu")
    base = op if mode == "bruteforce" else op.scene
    p, loss = sr.make_train_step(op, cfg, lr=W.LR)(
        W.start_params(base, _light()), target)
    np.testing.assert_allclose(g[f"train_{mode}_loss"], float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(g[f"train_{mode}_obj_color"],
                               p.obj_color.numpy(), rtol=1e-4, atol=1e-7)
    losses = g[f"train_{mode}_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    np.testing.assert_array_equal(losses, got["dp"][1][f"train_{mode}_"
                                                       "losses"])
    if mode == "bruteforce":
        np.testing.assert_allclose(losses, ref["train_losses"], rtol=1e-5)
        np.testing.assert_allclose(g[f"train_{mode}_obj_color"],
                                   ref["train_obj_color"], rtol=1e-4,
                                   atol=1e-7)


def test_composed_step_matches_jax(worlds):
    got, ref, _, _ = worlds
    g = got["composed"]
    np.testing.assert_allclose(g[0]["composed_loss"], ref["composed_loss"],
                               rtol=1e-5)
    want = params_from_jax(ref["composed_leaves"], device="cpu",
                           cls=ReplicatedParams)
    for i, leaf in enumerate(want.leaves()):
        for r in range(WORLDS["composed"]):
            np.testing.assert_allclose(g[r][f"composed_leaf_{i}"],
                                       leaf.numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=f"leaf {i}, rank {r}")
    assert np.isfinite(g[0]["composed_shadows_loss"])
    assert g[0]["composed_shadows_loss"] > 0


def test_frames_parallel_equals_frames_batched(worlds):
    got, _, scene, _ = worlds
    views = np.stack([orbit_view(a, 100.0, 0.0, 0.0) for a in (0.0, 60.0)])
    want = frames_batched(scene, W.frame_cfg(), views, _light(),
                          device="cpu").numpy()
    for r in range(WORLDS["dp"]):
        np.testing.assert_array_equal(got["dp"][r]["frames"], want)


def test_frame_parallel_turntable_writes_metrics_once(worlds):
    """render_turntable(mesh=) over two processes sharing one metrics
    file: the axis's first process writes the prepare and sweep events
    (the sweep naming both processes) and saves every frame."""
    got, _, _, _ = worlds
    for r in range(WORLDS["dp"]):
        g = got["dp"][r]
        assert list(g["turntable_events"]) == ["prepare", "sweep"]
        assert list(g["turntable_devices"]) == [0, WORLDS["dp"]]
        assert g["turntable_saved"].tolist() == [True, True]


def test_host_local_rows_and_make_mesh(worlds):
    got, _, _, _ = worlds
    rows = [tuple(r["rows"]) for r in got["dp"]]
    assert rows == [(0, 16), (16, 33)]
    assert all(bool(r["make_mesh_3_raised"]) for r in got["dp"])


def test_init_distributed_from_arguments_and_environment(worlds):
    got, _, _, _ = worlds
    for w, ranks in got.items():
        for r in ranks:
            assert bool(r["joined"]) and bool(r["repeat"]), w
            assert int(r["world_size"]) == WORLDS[w]
            if w not in EXPLICIT:
                assert not bool(r["nothing_named"])
                assert bool(r["nothing_initialised"])


def test_dryrun_multichip_runs_to_its_end():
    line = dryrun_multichip(4, timeout=TIMEOUT)
    assert line.startswith("dryrun_multichip(4): composed dp2xgp2"), line
