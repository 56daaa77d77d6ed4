"""run.py end to end: each cell rehearsed on the CPU at a tiny size on the
program's plain versions; every planted fault turns ``correct`` false; no
card, or no program, means a non-zero exit and no result line.  The cells
of ``later.json`` are rehearsed too, from a copy of the checkout whose
``BENCHMARK.json`` names them."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from rtbench import faults, spec

RUN = os.path.join(spec.HERE, "run.py")
BENCH = spec.read_json(spec.BENCHMARK)
ALL = spec.with_later(BENCH)
ONE = [w["name"] for w in ALL["workloads"] if w["chips"] == 1]
FOUR = [w["name"] for w in ALL["workloads"] if w["chips"] == 4]
NAMED = {w["name"] for w in BENCH["workloads"]}


def cell_of(name):
    return spec.resolve_in(ALL, name)


@pytest.fixture(scope="module")
def later_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json names the cells of later.json too."""
    root = tmp_path_factory.mktemp("later")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(ALL, f)
    shutil.copytree(spec.HERE, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(os.path.join(spec.ROOT, "simple_raytracer_tpu_torch"),
               root / "simple_raytracer_tpu_torch")
    return str(root)


def run(cell, *extra, seed=2147483659, seconds=1, cwd=None, root=None):
    """run.py on ``cell``; a cell the benchmark leaves out runs from
    ``root``, a checkout that names it."""
    if cell not in NAMED:
        assert root, f"{cell} runs from a checkout that names it"
    script = os.path.join(root or spec.ROOT, "rtbench", "run.py")
    p = subprocess.run([sys.executable, script, "--workload", cell, "--seed",
                        str(seed), "--seconds", str(seconds), *extra],
                       capture_output=True, text=True, timeout=300, cwd=cwd)
    return p


def result(p) -> dict:
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    tail = p.stderr.strip().splitlines()[-len(out["checks"]):]
    assert [t.split()[1].rstrip(":") for t in tail] == list(out["checks"])
    return out


@pytest.mark.parametrize("cell", ONE + FOUR)
def test_rehearsal_is_correct_and_reports_the_end_to_end_metrics(
        cell, later_root):
    out = result(run(cell, "--rehearse", "--trace", "0", root=later_root))
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"] for m in BENCH["end_to_end"]}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["count"] == cell_of(cell).chips
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", [ONE[0]] + FOUR)
def test_traced_rehearsal_reports_per_layer_metrics(cell, later_root):
    out = result(run(cell, "--rehearse", "--trace", "1", root=later_root))
    assert out["correct"] is True
    names = {m["name"] for m in cell_of(cell).per_layer}
    assert "prepare_s" in out["metrics"] and set(out["metrics"]) <= names
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ONE + FOUR
    for f in faults.applicable(cell_of(c).traffic)])
def test_a_planted_fault_fails_the_check(cell, fault, later_root):
    out = result(run(cell, "--rehearse", "--plant", fault, root=later_root))
    assert out["correct"] is False and out["failed"] > 0


@pytest.mark.parametrize("cell", ONE + FOUR)
def test_the_control_in_the_programs_place_fails_the_check(cell, later_root):
    out = result(run(cell, "--rehearse", "--plant", faults.CONTROL,
                     root=later_root))
    assert out["correct"] is False and out["failed"] > 0
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def test_control_reads_the_program_correct_and_the_control_not(later_root):
    p = subprocess.run([sys.executable,
                        os.path.join(later_root, "rtbench", "control.py"),
                        "--workload", FOUR[0], "--seeds", "5", "--rehearse",
                        "--seconds", "0.5", "--plants", "none", "control",
                        "nogather"], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert [x["plant"] for x in lines] == ["none", "control", "nogather"]
    assert [x["correct"] for x in lines] == [True, False, False]
    assert all(set(x["checks"]) == set(cell_of(FOUR[0]).limits)
               for x in lines)


def test_no_card_means_no_result(monkeypatch):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, RUN, "--workload", ONE[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                        ONE[0], "--seed", "1", "--seconds", "1",
                        "--rehearse"], capture_output=True, text=True,
                       timeout=120, cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_plant_needs_rehearse():
    p = run(ONE[0], "--plant", "half_lower")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = result(run(cell, "--trace", "0", seconds=2))
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
