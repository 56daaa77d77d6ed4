"""PyTorch port: host scene stack vs the JAX package.

Config defaults, the copied numpy modules (transforms, OBJ loader, BVH), the
built Scene and the prepared arrays must equal the JAX package's, so both
packages render the same padded, BVH-ordered triangles.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch.accel import bvh as tbvh
from simple_raytracer_tpu_torch.accel.prepared import (from_jax_prepared,
                                                        kernel_tables, prepare)
from simple_raytracer_tpu_torch.scene import obj_loader as tobj
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.scene import transforms as tT
from simple_raytracer_tpu_torch.scene.scene import from_jax_arrays

from simple_raytracer_tpu import config as jconfig
from simple_raytracer_tpu.accel import bvh as jbvh
from simple_raytracer_tpu.accel.prepared import prepare as jprepare
from simple_raytracer_tpu.scene import obj_loader as jobj
from simple_raytracer_tpu.scene import transforms as jT

from _torch_parity import configs, jax_prepared_arrays, managers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax (and the JAX package)
    out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import simple_raytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('simple_raytracer_tpu.')"
        " or m == 'simple_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('modules', len([m for m in sys.modules"
        " if m.startswith('simple_raytracer_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("name", ["CameraConfig", "LightConfig",
                                  "ShadingConfig", "BVHConfig"])
def test_config_defaults_match_jax(name):
    ours = getattr(sr, name)()
    theirs = getattr(jconfig, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_render_config_shared_fields_match_jax():
    ours = dataclasses.asdict(sr.default_config())
    theirs = dataclasses.asdict(jconfig.default_config())
    shared = set(ours) & set(theirs) - {"kernel"}
    assert {"camera", "light", "shading", "bvh", "mode", "tile_px",
            "hit_tile", "shadow_tile", "cull_maxv", "background",
            "mt_eps"} <= shared
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}


def test_transforms_match_jax():
    a = math.radians(23.0)
    for fn, args in (("scale", (2.0, 3.0, 4.0)), ("rotate_x", (a,)),
                     ("rotate_y", (a,)), ("rotate_z", (a,)),
                     ("translate", ((1.0, -2.0, 3.0),)),
                     ("view_matrix", ((1.0, 2.0, 3.0), (a, -a, 0.5 * a)))):
        np.testing.assert_array_equal(getattr(tT, fn)(*args),
                                      getattr(jT, fn)(*args))
    v = np.random.default_rng(0).normal(size=(5, 3, 4)).astype(np.float32)
    m = tT.view_matrix((1.0, 2.0, 3.0), (a, a, a))
    np.testing.assert_array_equal(tT.apply_transform(m, v),
                                  jT.apply_transform(m, v))


def test_obj_loader_matches_jax(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("# quad and a triangle with relative indices\n"
                 "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                 "vn 0 0 1\n"
                 "f 1//1 2//1 3//1 4//1\n"
                 "f -3 -2 -1\n")
    ours = tobj.load_obj(str(p))
    theirs = jobj.load_obj(str(p))
    assert ours.num_triangles == theirs.num_triangles == 3
    for f in ("verts", "normals", "uvs", "tri_color", "tri_tex"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))


@pytest.mark.parametrize("split", ["median", "sah"])
def test_bvh_matches_jax(split):
    tris = P.icosphere(2, 0.1).verts[..., :3]
    ours = tbvh.build_bvh(tris, 8, split=split)
    theirs = jbvh.build_bvh(tris, 8, split=split)
    for f in ("node_min", "node_max", "skip", "leaf_first", "leaf_count",
              "perm"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    assert (ours.max_leaf, ours.depth) == (theirs.max_leaf, theirs.depth)


def test_procedural_meshes():
    for k in range(4):
        m = P.icosphere(k)
        assert m.num_triangles == 20 * 4 ** k
        r = np.linalg.norm(m.verts[..., :3], axis=-1)
        np.testing.assert_allclose(r, 1.0, atol=1e-6)
    bumpy = np.linalg.norm(P.icosphere(3, 0.1, seed=1).verts[..., :3],
                           axis=-1)
    assert 0.89 < bumpy.min() < 0.99 and 1.01 < bumpy.max() < 1.11
    b = P.box().verts[..., :3]
    e1, e2 = b[:, 1] - b[:, 0], b[:, 2] - b[:, 0]
    n = np.cross(e1, e2)
    assert b.shape == (12, 3, 3)
    np.testing.assert_allclose(0.5 * np.linalg.norm(n, axis=-1).sum(), 24.0)
    # outward winding: every face normal points away from the centre
    assert ((n * b.mean(axis=1)).sum(-1) > 0).all()


def test_scene_build_matches_jax():
    sm, jsm = managers()
    ours, theirs = sm.build(), jsm.build()
    for n in sr.Scene.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ours, n).numpy(),
                                      np.asarray(getattr(theirs, n)), n)
    assert ours.has_textures == theirs.has_textures
    back = from_jax_arrays({n: np.asarray(getattr(theirs, n))
                            for n in sr.Scene.ARRAY_FIELDS})
    for n in sr.Scene.ARRAY_FIELDS:
        assert torch.equal(getattr(back, n), getattr(ours, n)), n


@pytest.mark.parametrize("split", ["median", "sah"])
def test_prepare_matches_jax(split):
    sm, jsm = managers()
    cfg, jcfg = configs(split)
    prep = prepare(sm.build(), cfg, device="cpu")
    jprep = jprepare(jsm.build(), jcfg)
    arrays = jax_prepared_arrays(jprep)
    for n in sr.Scene.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(prep.scene, n).numpy(),
                                      arrays[n], n)
    for n in ("block_min", "block_max", "block_obj"):
        np.testing.assert_array_equal(getattr(prep, n).numpy(), arrays[n], n)
    assert prep.num_triangles == int(jprep.num_triangles)
    assert prep.num_blocks == int(jprep.num_blocks)
    fj = from_jax_prepared(arrays, num_triangles=prep.num_triangles,
                           device="cpu")
    for n in ("tri", "tri_attr", "block_obj"):
        assert torch.equal(getattr(fj, n), getattr(prep, n)), n


def test_kernel_tables_layout():
    sm, _ = managers(2)
    cfg, _ = configs()
    prep = prepare(sm.build(), cfg, device="cpu")
    v = prep.scene.verts[..., :3] / prep.scene.verts[..., 3:4]
    assert torch.equal(prep.tri[:, 0:3], v[:, 0])
    assert torch.equal(prep.tri[:, 3:6], v[:, 1] - v[:, 0])
    assert torch.equal(prep.tri[:, 6:9], v[:, 2] - v[:, 0])
    assert torch.equal(prep.tri_attr[:, :3], prep.scene.tri_normal)
    assert torch.equal(prep.tri_attr[:, 3].long(), prep.scene.tri_obj.long())
    # every block, hence every aligned window, holds one object
    to = prep.scene.tri_obj.reshape(prep.num_blocks, prep.block_size)
    assert ((to == prep.block_obj[:, None]) | (to == -1)).all()
    tri, attr = kernel_tables(prep.scene.verts.numpy(),
                              prep.scene.tri_normal.numpy(),
                              prep.scene.tri_obj.numpy())
    assert np.array_equal(tri, prep.tri.numpy())
    assert np.array_equal(attr, prep.tri_attr.numpy())
