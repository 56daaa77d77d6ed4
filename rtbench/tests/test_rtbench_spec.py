"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract as far as its own text can show."""

import json
import os
import re

import pytest

from rtbench import spec

BENCH = spec.read_json(spec.BENCHMARK)
ALL = spec.with_later(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LATER = [w["name"] for w in ALL["workloads"] if w["name"] not in CELLS]


@pytest.mark.parametrize("cell", CELLS + LATER)
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve_in(ALL, cell)
    assert c.chips in (1, 4)
    assert int(c.traffic["views_per_call"]) in (1, c.chips)
    assert (c.traffic["entry"] == "frames_parallel") == (c.chips > 1)
    assert c.config["scene"] and c.scene_builder().build
    from rtbench.session import CLASSES
    assert "bad_px_pct" in c.limits and set(c.limits) <= set(CLASSES)
    assert all(float(v) > 0 for v in c.limits.values())
    assert ("bad_shadow_px_pct" in c.limits) == bool(
        c.traffic["expect"]["shadow_in_view"])
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "rays_per_s", "frame_ms_p95"} <= names
    assert c.per_layer
    for m in c.per_layer:
        mod = spec.metric_module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])


def test_later_cells_and_their_metrics_stay_out_of_the_benchmark():
    later = spec.read_json(spec.LATER)
    assert set(later) == {"workloads", "per_layer"}
    assert LATER and len(LATER) == len(later["workloads"])
    named = {m["name"] for m in BENCH["per_layer"]}
    for m in later["per_layer"]:
        assert m["name"] not in named
        assert m["workloads"] and set(m["workloads"]) <= set(LATER)
    with pytest.raises(KeyError):
        spec.resolve(LATER[0])


def test_every_metric_and_config_has_its_file():
    for m in ALL["per_layer"]:
        assert os.path.isfile(os.path.join(spec.HERE, "metrics",
                                           m["name"] + ".py"))
    for c in BENCH["configs"]:
        cfg = spec.read_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg)


def test_names_units_and_lines_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    every = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in metrics]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in every)
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and "\n" not in m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
