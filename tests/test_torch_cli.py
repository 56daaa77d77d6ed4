"""PyTorch port, the command line and what it drives, against the JAX
package's: image output (``io/image.py``), metrics and traces
(``utils/metrics.py``), the turntable driver (``driver/animation.py``) and
``python -m simple_raytracer_tpu_torch render|animate`` (``cli.py``).

* ``write_bmp`` writes JAX's bytes (with and without row padding); the
  standard-library PNG decodes, through PIL, to the same array;
  ``read_bmp`` reads a BMP back;
* ``sweep_angles`` and ``frame_filename`` equal JAX's; ``render_turntable``
  saves each frame as soon as it is rendered (a failed frame keeps the ones
  before it) and writes every frame of the sweep, in world and bake mode,
  images at JAX's bars (within 1 on >= 99.9% of pixels, equal on >= 98%),
  and resumes past the files that exist; ``frames_batched`` equals per-frame ``render``;
* ``Metrics`` writes the JSONL keys JAX's writes; ``profile_trace`` writes
  a Chrome trace that ``busy_share`` reads;
* the CLI's flags and defaults are JAX's (``--root`` relative, plus
  ``--device``); ``render`` and ``animate`` with ``--device cpu`` write
  their files from stand-in OBJ assets written here, the rendered frame
  at JAX's bars against the JAX CLI's; ``train --data-parallel`` and
  ``animate --frame-parallel`` run on a world of one process, equal to
  the commands without them; ``frames_parallel`` and
  ``render_turntable(mesh=)`` equal the frames of one process; with no
  CUDA device and no ``--device cpu`` the CLI raises; ``--show`` without
  PIL raises a clear error;
* ``train --device cpu`` on the stand-in OBJ files: its flags are JAX's,
  its losses are emitted and fall, equal to JAX's ``train``'s; it saves a
  checkpoint every ``--ckpt-every`` steps and at the end, and a rerun
  resumes from it (``resumed``); without a CUDA device and without
  ``--device cpu`` it raises before it trains.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch import cli
from simple_raytracer_tpu_torch.dist import make_mesh
from simple_raytracer_tpu_torch.driver import animation
from simple_raytracer_tpu_torch.io import image
from simple_raytracer_tpu_torch.render.renderer import ensure_prepared, render
from simple_raytracer_tpu_torch.scene import catalog
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics

from simple_raytracer_tpu import cli as jcli
from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.driver import animation as janimation
from simple_raytracer_tpu.io import image as jimage
from simple_raytracer_tpu.utils import metrics as jmetrics

CAM = dict(width=60, height=40)
SMALL = ["--width", "60", "--height", "40"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small tensor ops: one intra-op thread keeps them fast when
    other test processes load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Stand-in assets of the reference's layout: sphere.obj an
    icosphere(1) of radius 2.5, cube.obj the unit box."""
    root = tmp_path_factory.mktemp("assets")
    sphere = P.icosphere(1)
    sphere.verts[..., :3] *= 2.5
    (root / "sphere.obj").write_text(P.obj_text(sphere))
    (root / "cube.obj").write_text(P.obj_text(P.box()))
    return str(root)


def _image_bars(img, jimg):
    diff = np.abs(np.asarray(img).astype(int) - np.asarray(jimg).astype(int))
    assert img.shape == jimg.shape
    assert (diff <= 1).mean() >= 0.999, diff.max()
    assert (diff == 0).mean() >= 0.98


def _picture(h=13, w=7, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("w", [7, 8])
def test_write_bmp_writes_jax_bytes(tmp_path, w):
    img = _picture(w=w)
    image.write_bmp(str(tmp_path / "a.bmp"), torch.from_numpy(img))
    jimage.write_bmp(str(tmp_path / "b.bmp"), img)
    ours, theirs = (tmp_path / "a.bmp"), (tmp_path / "b.bmp")
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(image.read_bmp(str(tmp_path / "a.bmp")),
                                  img)


def test_png_decodes_to_the_same_array(tmp_path):
    from PIL import Image
    img = _picture(37, 21, 1)
    path = str(tmp_path / "sub" / "a.png")
    image.save_image(path, img)
    with Image.open(path) as f:
        assert f.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(f), img)
    image.save_image(str(tmp_path / "a.BMP"), img)
    np.testing.assert_array_equal(image.read_bmp(str(tmp_path / "a.BMP")),
                                  img)


@pytest.mark.parametrize("step", [10.0, 120.0, 0.75])
def test_sweep_angles_and_names_match_jax(step):
    anim, janim = sr.AnimationConfig(step_deg=step), \
        jconfig.AnimationConfig(step_deg=step)
    a, ja = animation.sweep_angles(anim), janimation.sweep_angles(janim)
    np.testing.assert_array_equal(a, ja)
    assert a.dtype == ja.dtype
    for x in a[:5]:
        for fmt in ("bmp", "png"):
            assert animation.frame_filename(x, fmt) == \
                janimation.frame_filename(x, fmt)


def test_metrics_write_jax_keys(tmp_path, capsys):
    paths = [str(tmp_path / "ours.jsonl"), str(tmp_path / "theirs.jsonl")]
    for cls, path in zip((metrics.Metrics, jmetrics.Metrics), paths):
        m = cls(path)
        m.emit(event="frame", angle=10.0, ms=1.5)
        with m.timer("sweep", frames=3):
            pass
        m.close()
    ours, theirs = ([json.loads(x) for x in open(p)] for p in paths)
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert [r["event"] for r in ours] == ["frame", "sweep"]
    assert capsys.readouterr().out.count('"event"') == 4


def test_profile_trace_writes_a_trace(tmp_path):
    with metrics.profile_trace(None):
        pass
    d = str(tmp_path / "trace")
    with metrics.profile_trace(d):
        torch.ones(64).cumsum(0)
    path = os.path.join(d, metrics.TRACE_FILE)
    share = metrics.busy_share(path)
    assert os.path.getsize(path) > 0 and share["window_ms"] > 0
    assert share["kernels"] == 0 and share["busy_share"] == 0.0


@pytest.mark.parametrize("mode", ["bvh", "bruteforce"])
def test_turntable_writes_matches_jax_and_resumes(tmp_path, assets, mode):
    """Three frames of the four-cube turntable in world mode: each file
    written, each image at JAX's bars against JAX's turntable; a second
    run writes nothing; bake mode writes the same frames."""
    from simple_raytracer_tpu.driver.animation import render_turntable as jtt
    cfg = sr.default_config().replace(mode=mode,
                                      camera=sr.CameraConfig(**CAM))
    jcfg = jconfig.default_config().replace(
        mode=mode, camera=jconfig.CameraConfig(**CAM))
    anim = sr.AnimationConfig(step_deg=120.0, orbit_radius=100.0,
                              camera_y=0.0, pitch_deg=0.0)
    janim = jconfig.AnimationConfig(step_deg=120.0, orbit_radius=100.0,
                                    camera_y=0.0, pitch_deg=0.0)
    out, jout = str(tmp_path / "ours"), str(tmp_path / "theirs")
    files = animation.render_turntable(
        "four_cubes", assets, cfg, anim, out_dir=out, device="cpu",
        metrics_path=str(tmp_path / "m.jsonl"))
    jfiles = jtt("four_cubes", assets, jcfg, janim, out_dir=jout)
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in jfiles] == \
        ["output0.bmp", "output120.bmp", "output240.bmp"]
    for f, jf in zip(files, jfiles):
        _image_bars(image.read_bmp(f), image.read_bmp(jf))
    events = [json.loads(x)["event"] for x in open(tmp_path / "m.jsonl")]
    assert events == ["prepare", "sweep"]
    mtimes = [os.path.getmtime(f) for f in files]
    again = animation.render_turntable("four_cubes", assets, cfg, anim,
                                       out_dir=out, device="cpu")
    assert again == files and [os.path.getmtime(f) for f in files] == mtimes
    baked = animation.render_turntable("four_cubes", assets, cfg, anim,
                                       out_dir=str(tmp_path / "baked"),
                                       world_space=False, device="cpu")
    for f, b in zip(files, baked):
        _image_bars(image.read_bmp(b), image.read_bmp(f))


@pytest.mark.parametrize("world_space", [True, False])
def test_turntable_keeps_the_frames_before_a_failure(tmp_path, assets,
                                                     monkeypatch,
                                                     world_space):
    """Each frame is saved as soon as it is rendered: when the second
    frame's render fails, the first frame's file is on disk, and a resumed
    sweep writes only the frames that are missing."""
    cfg = sr.default_config().replace(mode="bvh",
                                      camera=sr.CameraConfig(**CAM))
    anim = sr.AnimationConfig(step_deg=120.0, orbit_radius=100.0,
                              camera_y=0.0, pitch_deg=0.0)
    out = str(tmp_path / "gen")
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("render failed")
        return render(*args, **kwargs)

    monkeypatch.setattr(animation, "render", failing)
    with pytest.raises(RuntimeError, match="render failed"):
        animation.render_turntable("four_cubes", assets, cfg, anim,
                                   out_dir=out, world_space=world_space,
                                   device="cpu")
    assert os.listdir(out) == ["output0.bmp"]
    first = os.path.getmtime(os.path.join(out, "output0.bmp"))
    animation.render_turntable("four_cubes", assets, cfg, anim, out_dir=out,
                               world_space=world_space, device="cpu")
    assert sorted(os.listdir(out)) == ["output0.bmp", "output120.bmp",
                                       "output240.bmp"]
    assert os.path.getmtime(os.path.join(out, "output0.bmp")) == first
    assert len(calls) == 4


def test_frames_batched_equals_per_frame_render(tmp_path, assets, capsys):
    """``frames_batched`` equals per-frame ``render``; so do
    ``frames_parallel`` and ``render_turntable(mesh=)`` over a mesh of one
    process (a world of one, gloo), whose sweep event names 1 device."""
    cfg = sr.default_config().replace(mode="bvh",
                                      camera=sr.CameraConfig(**CAM))
    sm, _, light = catalog.four_cubes(assets, 0.0, bake_view=False)
    prep = ensure_prepared(sm.build(), cfg, "cpu")
    views = np.stack([catalog.orbit_view(a, 100.0, 0.0, 0.0)
                      for a in (0.0, 50.0, 200.0)])
    imgs = animation.frames_batched(prep, cfg, views, light)
    assert imgs.shape == (3, 40, 60, 3) and imgs.dtype == torch.uint8
    for k in range(3):
        assert torch.equal(imgs[k], render(prep, cfg, light,
                                           view_matrix=views[k]))
    mesh = make_mesh(1, ("pp",), device="cpu")
    assert torch.equal(animation.frames_parallel(prep, cfg, views, light,
                                                 mesh), imgs)
    anim = sr.AnimationConfig(step_deg=120.0, orbit_radius=100.0,
                              camera_y=0.0, pitch_deg=0.0)
    out = str(tmp_path / "gen")
    capsys.readouterr()
    paths = animation.render_turntable("four_cubes", assets, cfg, anim,
                                       out_dir=out, mesh=mesh, device="cpu")
    sweep = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if '"sweep"' in x]
    assert len(sweep) == 1 and sweep[0]["devices"] == 1
    assert sweep[0]["frames"] == 3
    for a, path in zip(animation.sweep_angles(anim), paths):
        view = catalog.orbit_view(a, anim.orbit_radius, anim.camera_y,
                                  anim.pitch_deg, anim.yaw_offset_deg)
        np.testing.assert_array_equal(
            image.read_bmp(path),
            render(prep, cfg, light, view_matrix=view).numpy())


def _flags(add):
    p = argparse.ArgumentParser()
    add(p)
    return {a.dest: a.default for a in p._actions if a.dest != "help"}


def test_cli_flags_are_jax_flags_plus_device():
    ours, theirs = _flags(cli._add_render_flags), _flags(
        jcli._add_render_flags)
    assert ours.pop("device") == "cuda"
    assert ours.pop("root") == "reference" and theirs.pop("root")
    assert ours == theirs
    assert ours["mode"] == "tiled"


@pytest.mark.parametrize("mode", ["bruteforce", "bvh", "tiled"])
def test_cli_render_writes_the_frame(tmp_path, assets, mode):
    """``render`` of the six spheres on the CPU: the BMP equals the port's
    ``render`` of the same scene, and is at JAX's bars against the JAX
    CLI's BMP; the PNG decodes to the same image; the metrics file has
    the scene, render and saved events."""
    out = str(tmp_path / "f.bmp")
    args = ["render", "--scene", "six_spheres", "--root", assets, "--mode",
            mode, *SMALL, "--focal", "40"]
    assert cli.main(args + ["--device", "cpu", "--out", out, "--metrics",
                            str(tmp_path / "m.jsonl")]) == 0
    img = image.read_bmp(out)
    sm, view, light = catalog.six_spheres(assets, 0.0, bake_view=False)
    cfg = sr.default_config().replace(
        mode=mode, camera=sr.CameraConfig(width=60, height=40, focal=40.0))
    want = render(sm.build(), cfg, light, view_matrix=view, device="cpu")
    np.testing.assert_array_equal(img, want.numpy())
    bg = (img == np.array([173, 216, 230])).all(-1)
    assert 0.05 < (~bg).mean() < 0.99
    assert jcli.main(args + ["--out", str(tmp_path / "j.bmp")]) == 0
    _image_bars(img, image.read_bmp(str(tmp_path / "j.bmp")))
    events = [json.loads(x)["event"] for x in open(tmp_path / "m.jsonl")]
    assert events == ["scene", "render", "saved"]
    if mode == "bvh":
        from PIL import Image
        png = str(tmp_path / "f.png")
        assert cli.main(args + ["--device", "cpu", "--out", png]) == 0
        with Image.open(png) as f:
            np.testing.assert_array_equal(np.asarray(f), img)


def test_cli_animate_writes_and_resumes(tmp_path, assets, capsys):
    out = str(tmp_path / "gen")
    args = ["animate", "--scene", "one_cube", "--root", assets, *SMALL,
            "--step-deg", "120", "--fmt", "png", "--out-dir", out,
            "--mode", "bvh", "--device", "cpu"]
    assert cli.main(args) == 0
    names = sorted(os.listdir(out))
    assert names == ["output0.png", "output120.png", "output240.png"]
    mtimes = [os.path.getmtime(os.path.join(out, n)) for n in names]
    capsys.readouterr()
    assert cli.main(args) == 0
    assert '"sweep"' not in capsys.readouterr().out
    assert [os.path.getmtime(os.path.join(out, n)) for n in names] == mtimes


def test_cli_unported_commands_raise(tmp_path, assets, capsys):
    """``train --data-parallel`` and ``animate --frame-parallel``, started
    plainly, run on a world of one process: the losses equal those of the
    step without a mesh, and the frames those of the plain sweep."""
    train = ["train", "--scene", "one_cube", "--root", assets, *SMALL,
             "--focal", "40", "--steps", "2", "--log-every", "1",
             "--device", "cpu"]
    losses = []
    for extra in ([], ["--data-parallel"]):
        capsys.readouterr()
        assert cli.main(train + extra) == 0
        losses.append([json.loads(x)["loss"] for x in
                       capsys.readouterr().out.splitlines()
                       if '"train"' in x])
    assert len(losses[0]) == 2 and losses[1] == losses[0]
    frames = []
    for extra in ([], ["--frame-parallel"]):
        out = tmp_path / ("fp" if extra else "plain")
        assert cli.main(["animate", "--scene", "one_cube", "--root", assets,
                         *SMALL, "--step-deg", "120", "--mode", "bvh",
                         "--device", "cpu", "--out-dir", str(out)]
                        + extra) == 0
        frames.append({n: image.read_bmp(str(out / n))
                       for n in sorted(os.listdir(out))})
    assert list(frames[1]) == ["output0.bmp", "output120.bmp",
                               "output240.bmp"]
    for n in frames[0]:
        np.testing.assert_array_equal(frames[1][n], frames[0][n])


def test_cli_needs_the_card_unless_asked(tmp_path, assets, monkeypatch):
    """Without ``--device cpu`` and with no CUDA device the CLI raises and
    writes nothing; ``--show`` without PIL raises a clear error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "f.bmp")
    for cmd in (["render", "--out", out], ["animate", "--out-dir",
                                           str(tmp_path / "gen")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(cmd + ["--scene", "one_cube", "--root", assets,
                            "--mode", "bruteforce", *SMALL])
    assert not os.listdir(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        cli.main(["render", "--scene", "one_cube", "--root", assets,
                  "--device", "cpu", "--show", "--out", out, *SMALL])
    assert not os.path.exists(out)


TRAIN = ["train", "--scene", "six_spheres", *SMALL, "--focal", "40",
         "--lr", "1e-3", "--log-every", "1"]


def _events(out: str, event: str) -> list:
    return [json.loads(x) for x in out.splitlines()
            if x.startswith("{") and json.loads(x)["event"] == event]


def test_cli_train_flags_are_jax_flags_plus_device(monkeypatch):
    """``train`` parses JAX's flags with JAX's defaults, plus
    ``--device``."""
    got = {}
    monkeypatch.setattr(cli, "cmd_train", lambda a: got.setdefault("t", a))
    monkeypatch.setattr(jcli, "cmd_train", lambda a: got.setdefault("j", a))
    cli.main(["train"])
    jcli.main(["train"])
    ours, theirs = vars(got["t"]), vars(got["j"])
    for d in (ours, theirs):
        d.pop("fn")
    assert ours.pop("device") == "cuda"
    assert ours.pop("root") == "reference" and theirs.pop("root")
    assert ours == theirs
    assert (ours["steps"], ours["lr"], ours["ckpt_every"]) == (50, 1e-5, 20)


def test_cli_train_losses_fall_and_match_jax(tmp_path, assets, capsys):
    """Five steps on the CPU: a ``train`` event a step, the losses finite
    and falling, the first (the same params, the same target) equal to the
    JAX CLI's within rtol 1e-5.  JAX's later losses jump: its bruteforce
    step differentiates every ray-triangle pair, and the icosphere's faces
    that contain the centre column's rays give NaN vertices
    (tests/test_torch_train.py)."""
    args = TRAIN + ["--root", assets, "--steps", "5"]
    assert cli.main(args + ["--device", "cpu", "--metrics",
                            str(tmp_path / "m.jsonl")]) == 0
    losses = [e["loss"] for e in _events(capsys.readouterr().out, "train")]
    assert [e["step"] for e in _events(open(tmp_path / "m.jsonl").read(),
                                       "train")] == list(range(5))
    assert all(np.isfinite(losses)) and len(losses) == 5
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert jcli.main(args) == 0
    want = [e["loss"] for e in _events(capsys.readouterr().out, "train")]
    assert losses[0] == pytest.approx(want[0], rel=1e-5)


def test_cli_train_checkpoints_and_resumes(tmp_path, assets, capsys):
    """``--checkpoint`` every 2 steps and at the end; a rerun to 7 steps
    resumes at step 5 and runs only steps 5 and 6, its first loss below
    the first run's last; the checkpoint holds the params' seven leaves
    and the step, as JAX's does."""
    ck = str(tmp_path / "ck" / "train.npz")
    args = TRAIN + ["--root", assets, "--device", "cpu", "--checkpoint", ck,
                    "--ckpt-every", "2"]
    assert cli.main(args + ["--steps", "5"]) == 0
    first = _events(capsys.readouterr().out, "train")
    with np.load(ck) as z:
        assert int(z["__step__"]) == 5
        assert sorted(z.files) == sorted([f"leaf_{i}" for i in range(7)]
                                         + ["__step__"])
    assert cli.main(args + ["--steps", "7"]) == 0
    out = capsys.readouterr().out
    assert _events(out, "resumed") == [
        dict(_events(out, "resumed")[0], event="resumed", step=5)]
    second = _events(out, "train")
    assert [e["step"] for e in second] == [5, 6]
    assert second[0]["loss"] < first[-1]["loss"]
    with np.load(ck) as z:
        assert int(z["__step__"]) == 7
    assert [n for n in os.listdir(tmp_path / "ck")] == ["train.npz"]


def test_cli_train_needs_the_card_unless_asked(tmp_path, assets,
                                               monkeypatch, capsys):
    """Without ``--device cpu`` and with no CUDA device ``train`` raises
    before it trains or writes a checkpoint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TRAIN + ["--root", assets, "--steps", "2",
                          "--checkpoint", ck])
    assert not os.path.exists(ck)
    assert '"train"' not in capsys.readouterr().out
