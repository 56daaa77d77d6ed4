"""PyTorch port, the native host code (``native/``) against the Python paths
and the JAX package's.

* the C++ median BVH equals the port's numpy builder and JAX's
  ``build_bvh(..., use_native=False)`` on every field;
* ``load_obj`` through the native scan equals the port's Python scan
  (``SRT_NO_NATIVE=1``) and JAX's Python scan on every ``MeshData`` field,
  on a written icosphere and on a textured file with normals, texcoords,
  materials and quads;
* every kind of line on which the scan could read otherwise than Python is
  held to both packages' Python scans: the scan is exact, or it defers and
  ``load_obj`` gives Python's result or raises Python's error (the JAX
  package's own C++ scan reads the first four otherwise);
* ``SRT_NO_NATIVE=1`` turns the native paths off;
* two processes that build into an empty directory at once both load one
  working library;
* a tiled CPU frame of a natively loaded, median-split scene equals the
  Python paths' frame on every pixel.

The library is built with g++ here; the file fails when g++ is present and
the build fails, and skips only without g++.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel import bvh as tbvh
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.native import build as nbuild
from simple_raytracer_tpu_torch.native import (bvh_build_native,
                                               native_available,
                                               obj_parse_native)
from simple_raytracer_tpu_torch.scene import obj_loader as tobj
from simple_raytracer_tpu_torch.scene import procedural as P

from simple_raytracer_tpu.accel import bvh as jbvh
from simple_raytracer_tpu.scene import obj_loader as jobj

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BVH_FIELDS = ("node_min", "node_max", "skip", "leaf_first", "leaf_count",
              "perm", "max_leaf", "depth")
MESH_FIELDS = ("verts", "normals", "uvs", "tri_color", "tri_tex", "textures")


@pytest.fixture(scope="module", autouse=True)
def library():
    """The built library: fails the file when g++ is present and the build
    fails; skips only without g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    b = nbuild.build()
    assert os.path.isfile(b["path"])
    assert b["path"].startswith(nbuild.BUILD_DIR + os.sep)
    assert native_available()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield b
    torch.set_num_threads(n)


def assert_same(got, want, what: str) -> None:
    """Equal arrays (values, dtype and shape) or equal Python values."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.dtype == want.dtype and got.shape == want.shape, (
            what, got.dtype, got.shape, want.dtype, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def assert_mesh(got, want, what: str) -> None:
    for f in MESH_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f"{what}: {f}")


@pytest.mark.parametrize("T", [0, 1, 5, 8, 9, 100, 1000])
def test_native_bvh_equals_python(T):
    verts = np.random.default_rng(7 + T).standard_normal(
        (T, 3, 3)).astype(np.float32)
    got = tbvh.build_bvh(verts, 8)
    assert bvh_build_native(verts, 8) is not None
    for want, who in ((tbvh.build_bvh(verts, 8, use_native=False), "port"),
                      (jbvh.build_bvh(verts, 8, use_native=False), "jax")):
        for f in BVH_FIELDS:
            assert_same(getattr(got, f), getattr(want, f), f"{who} T={T} {f}")


def test_native_bvh_defers_on_nan():
    verts = np.random.default_rng(0).standard_normal((20, 3, 3)).astype(
        np.float32)
    verts[3, 1, 2] = np.nan
    assert bvh_build_native(verts, 8) is None
    got = tbvh.build_bvh(verts, 8)
    want = tbvh.build_bvh(verts, 8, use_native=False)
    for f in BVH_FIELDS:
        assert_same(getattr(got, f), getattr(want, f), f)


def test_build_bvh_split_keeps_its_position():
    """``split`` stays the third positional argument; ``use_native`` is
    keyword-only."""
    verts = np.random.default_rng(3).standard_normal((50, 3, 3)).astype(
        np.float32)
    for split in ("median", "sah"):
        got = tbvh.build_bvh(verts, 8, split)
        want = tbvh.build_bvh(verts, 8, split=split, use_native=False)
        for f in BVH_FIELDS:
            assert_same(getattr(got, f), getattr(want, f), f"{split} {f}")
    with pytest.raises(TypeError):
        tbvh.build_bvh(verts, 8, "median", False)


def write_textured(d) -> str:
    """A quad and a triangle with texcoords, normals, two materials (one
    textured by a PNG written here), relative indices and comments."""
    from PIL import Image
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (8, 16, 3), dtype=np.uint8)).save(
        os.path.join(d, "tex.png"))
    with open(os.path.join(d, "m.mtl"), "w") as f:
        f.write("newmtl painted\nKd 1 1 1\nmap_Kd tex.png\n"
                "newmtl plain\nKd 0.5 0.5 0.5\n")
    path = os.path.join(d, "textured.obj")
    with open(path, "w") as f:
        f.write("# a textured file\nmtllib m.mtl\no thing\n"
                "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.25 0.5 1.5\n"
                "vt 0.1 0.2\nvt 0.9 0.1\nvt 0.8 0.95\nvt -0.3 1.7\n"
                "vn 0 0 1\nvn 0.6 0 0.8\n"
                "usemtl painted\ns off\nf 1/1/1 2/2/1 3/3/2 4/4/2\n"
                "usemtl plain\nf -1/-1/-1 -2/-2 -3//-1\n"
                "usemtl painted\nf 5/4 1/1 3/2\n")
    return path


@pytest.mark.parametrize("kind", ["icosphere4", "textured"])
def test_load_obj_native_equals_python(kind, tmp_path, monkeypatch):
    if kind == "icosphere4":
        path = str(tmp_path / "sphere.obj")
        with open(path, "w") as f:
            f.write(P.obj_text(P.icosphere(4, 0.08)))
    else:
        path = write_textured(str(tmp_path))
    assert obj_parse_native(path) is not None      # the native scan runs
    got = tobj.load_obj(path)
    monkeypatch.setenv("SRT_NO_NATIVE", "1")
    assert obj_parse_native(path) is None
    assert_mesh(got, tobj.load_obj(path), f"{kind} vs the port's Python")
    assert_mesh(got, jobj.load_obj(path), f"{kind} vs JAX's Python")
    if kind == "icosphere4":
        assert got.num_triangles == 5120
    else:
        assert got.num_triangles == 4 and got.textures == ["tex.png"]
        assert (got.tri_tex == [0, 0, -1, 0]).all()


V4 = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
# (name, OBJ text, "exact" or "defer"): every kind of line that the scan
# could read otherwise than Python; the first four are read otherwise by the
# JAX package's C++ scan
DIVERGENT = [
    ("v tab", V4 + "v\t2 2 2\nf -1 -2 -3\n", "exact"),
    ("bare v", V4 + "v\nf -1 -2 -3\n", "exact"),
    ("vtx", V4 + "vt 0.5 0.5\nvtx 5 5\nvt 0.25 0.75\nf 1/-1 2/-2 3/1\n",
     "exact"),
    ("double rounding",
     "v 1.00000005960464477539062500001 0 0\n" + V4 + "f 1 2 3\n", "exact"),
    ("crlf", V4.replace("\n", "\r\n") + "f 1 2 3 4\r\n", "exact"),
    ("usemtl tab", V4 + "usemtl\tname\nf 1 2 3\nusemtl\nf 2 3 4\n"
     "usemtl other extra\nf 1 3 4\n", "exact"),
    ("300 corners", "".join(f"v {np.cos(k / 50):.6f} {np.sin(k / 50):.6f} 0\n"
                            for k in range(300))
     + "f " + " ".join(str(k + 1) for k in range(300)) + "\n", "exact"),
    ("hex", V4 + "v 0x10 0 0\nf 1 2 3\n", "defer"),
    ("f suffix", V4 + "v 1.0f 0 0\nf 1 2 3\n", "defer"),
    ("lone cr", V4.replace("\n", "\r") + "f 1 2 3\rf -1 -2 -3\r", "exact"),
    ("form feed", V4 + "v\x0c3 3 3\x0c\nf -1 -2 -3\x0c\n", "exact"),
    # more cases of the same kinds
    ("e without digits", V4 + "v 1.0e 0 0\nf 1 2 3\n", "defer"),
    ("underscore", V4 + "v 1_0 0 0\nf -1 -2 -3\n", "defer"),
    ("inf and nan", V4 + "v inf -Infinity nan\nf -1 -2 -3\n", "defer"),
    ("ascii separators", V4 + "\x0bv\x1c4\x1d5\x1e6\x1f\nf -1 -2 -3\n",
     "exact"),
    ("nbsp", V4 + "v\u00a07 7 7\nf -1 -2 -3\n", "defer"),
    ("utf-8 bom", "\ufeff" + V4 + "f 1 2 3\n", "defer"),
    ("non-ascii comment and object", "# modèle créé\no objet_é\n" + V4
     + "f 1 2 3\n", "exact"),
    ("nul in a name", V4 + "usemtl a\x00b\nf 1 2 3\n", "exact"),
    ("nul in a number", V4 + "v 1\x00 2 3\nf 1 2 3\n", "defer"),
    ("extra and missing components", V4 + "v 1 2 3 0.5 junk\nvt 0.5\n"
     "vn 1\nvt\nf 5/1/1 1/2 2\n", "exact"),
    ("plain literals", V4 + "v +.5 -0 5.\nv 1e-50 1E+39 -00.25e1\n"
     "v 1e400 -1e-400 0.1\nf -1 -2 -3\n", "exact"),
    ("signed and zero indices", V4 + "f +1 +2 -1\nf 0 1 2\nf 1/2/3/x 2 3\n",
     "exact"),
    ("short faces", V4 + "f\nf 1\nf 1 2\nf 1//1 2//2 3//3\n", "exact"),
    ("bad index", V4 + "f 1 2 x\n", "defer"),
    ("index past int32", V4 + "f 3000000000 1 2\n", "defer"),
    ("index underscore", V4 + "f 1_0 1 2\n", "defer"),
    ("comment after numbers", V4 + "v 1 2 3 # a comment\nf -1 -2 -3\n",
     "exact"),
    ("comment inside numbers", V4 + "v 1 # 3\nf 1 2 3\n", "defer"),
    ("no final newline", V4 + "f 1 2 3", "exact"),
]


def scan(fn, path):
    """fn(path), or the type of the error it raises."""
    try:
        return fn(path)
    except Exception as e:      # noqa: BLE001 -- compared by type
        return type(e)


@pytest.mark.parametrize("name,text,expect", DIVERGENT,
                         ids=[c[0] for c in DIVERGENT])
def test_scan_exact_or_defers(name, text, expect, tmp_path, monkeypatch):
    path = str(tmp_path / "case.obj")
    with open(path, "wb") as f:
        f.write(text.encode("utf-8"))
    port, jax_ = scan(tobj._parse_obj_python, path), scan(
        jobj._parse_obj_python, path)
    if isinstance(port, type):
        assert jax_ is port, (name, jax_, port)
    else:
        for a, b, f in zip(port, jax_, range(6)):
            assert_same(np.asarray(a) if f < 5 else a,
                        np.asarray(b) if f < 5 else b, f"{name}: jax {f}")
    got = obj_parse_native(path)
    if expect == "defer":
        assert got is None, name
    else:
        assert got is not None, name
        assert not isinstance(port, type), (name, port)
        for f, (a, b) in enumerate(zip(got, port)):
            assert_same(a, b, f"{name}: field {f}")
    mesh = scan(tobj.load_obj, path)
    monkeypatch.setenv("SRT_NO_NATIVE", "1")
    want = scan(tobj.load_obj, path)
    if isinstance(want, type):
        assert mesh is want, (name, mesh, want)
    else:
        assert_mesh(mesh, want, name)


def test_no_native_switch(tmp_path, monkeypatch):
    path = str(tmp_path / "box.obj")
    with open(path, "w") as f:
        f.write(P.obj_text(P.box()))
    calls = []
    python_scan = tobj._parse_obj_python
    monkeypatch.setattr(tobj, "_parse_obj_python",
                        lambda p: calls.append(p) or python_scan(p))
    native = tobj.load_obj(path)
    assert calls == [] and native_available()
    monkeypatch.setenv("SRT_NO_NATIVE", "1")
    assert not native_available()
    assert bvh_build_native(P.box().verts[..., :3], 8) is None
    assert_mesh(tobj.load_obj(path), native, "SRT_NO_NATIVE")
    assert calls == [path]


def test_scan_defers_on_non_ascii_bytes_outside_utf8(tmp_path, monkeypatch):
    """The scan models Python's decoding as UTF-8: under another locale
    encoding a file with non-ASCII bytes goes to the Python scan."""
    import locale
    ascii_path, latin_path = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
    with open(ascii_path, "wb") as f:
        f.write((V4 + "f 1 2 3\n").encode())
    with open(latin_path, "wb") as f:
        f.write(b"# mod\xe8le\n" + (V4 + "f 1 2 3\n").encode())
    assert obj_parse_native(latin_path) is not None
    monkeypatch.setattr(locale, "getpreferredencoding", lambda _: "latin-1")
    assert obj_parse_native(latin_path) is None
    assert obj_parse_native(ascii_path) is not None


BUILD_AND_USE = """
import sys
import numpy as np
from simple_raytracer_tpu_torch.native import build
build.BUILD_DIR = sys.argv[1]
from simple_raytracer_tpu_torch.native import bvh_build_native
b = build.build()
res = bvh_build_native(np.arange(27, dtype=np.float32).reshape(3, 3, 3), 1)
print(b["path"], b["cached"], res[5].tolist(), res[2].tolist())
"""


def test_concurrent_builds(tmp_path):
    d = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("SRT_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_USE, d],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0][0] == lines[1][0]
    assert [ln[2:] for ln in lines] == [lines[0][2:]] * 2
    assert sorted(os.listdir(d)) == sorted(
        [os.path.basename(lines[0][0]), os.path.basename(lines[0][0])
         + ".log"])
    assert os.path.basename(lines[0][0]) == os.path.basename(
        nbuild.lib_path())


def obj_scene(d: str):
    """The bench-like scene (icosphere(3) on the ground box) loaded from
    OBJ files written to ``d``, and prepared with the median split."""
    sm = sr.SceneManager(root=d)
    for key, mesh, color in (("sphere", P.icosphere(3, 0.08), (0.8, 0.7, 0.6)),
                             ("ground", P.box(), (0.0, 1.0, 0.0))):
        path = os.path.join(d, f"{key}.obj")
        if not os.path.isfile(path):
            with open(path, "w") as f:
                f.write(P.obj_text(mesh))
        sm.load_obj_file(path, key=key)
        sm.set_color(key, color)
    sm.transform_triangles("sphere", P.SPHERE_POSE)
    sm.transform_triangles("ground", P.GROUND_POSE)
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=64, height=64,
                                             focal=P.bench_focal(64)),
        light=sr.LightConfig(enable_shadows=True))
    assert cfg.bvh.split == "median"
    return prepare(sm.build(), cfg, device="cpu"), cfg


def test_frame_native_equals_python(tmp_path, monkeypatch):
    d = str(tmp_path)
    light = torch.tensor(P.BENCH_LIGHT)
    prep, cfg = obj_scene(d)
    img = sr.render(prep, cfg, light)
    monkeypatch.setenv("SRT_NO_NATIVE", "1")
    pprep, _ = obj_scene(d)
    want = sr.render(pprep, cfg, light)
    assert torch.equal(img, want)
    bg = (img == torch.tensor(cfg.background, dtype=torch.uint8)).all(-1)
    assert 0.05 < float((~bg).float().mean()) < 0.99
