"""The check for JAX compares whole top-level names, and the reference
imports nothing of the program."""

import ast
import os
import sys
import types

from rtbench import session, spec


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in session.JAX_NAMES:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "simple_raytracer_tpu_torch.x",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("j"))
    assert session.jax_modules() == []
    monkeypatch.setitem(sys.modules, "simple_raytracer_tpu.x",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("z"))
    assert session.jax_modules() == ["jax.numpy", "simple_raytracer_tpu.x"]


def imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_and_frozen_scenes_import_nothing_of_the_program():
    files = [os.path.join(spec.HERE, "reference", f)
             for f in os.listdir(os.path.join(spec.HERE, "reference"))
             if f.endswith(".py")]
    files.append(os.path.join(spec.HERE, "scenes", "procedural.py"))
    for path in files:
        bad = imported(path) & {"simple_raytracer_tpu_torch", "jax",
                                "simple_raytracer_tpu", "rtbench"}
        assert not bad, (path, bad)


def test_no_file_of_the_benchmark_imports_jax():
    for d, _, fs in os.walk(spec.HERE):
        for f in fs:
            if f.endswith(".py"):
                names = imported(os.path.join(d, f))
                assert not names & {"jax", "jaxlib", "flax",
                                    "simple_raytracer_tpu"}, f
