"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names each cell ``<config>.<traffic>``; its configuration is
``configs/<config>.json`` (scene builder ``scenes/<scene>.py``), its
traffic ``traffic/<traffic>.json``, its limits ``limits/<cell>.json``, and
each per-layer metric ``metrics/<metric>.py``.  ``later.json`` holds, in
the same form, cells left out of the benchmark for now."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
# cells the benchmark leaves out for now, with the metrics only they report
# (PERF.md, Open questions): the tests still rehearse them
LATER = os.path.join(HERE, "later.json")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def scene_builder(self):
        return importlib.import_module(
            f"rtbench.scenes.{self.config['scene']}")


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(cell: str, benchmark: str = BENCHMARK) -> Cell:
    """The cell named ``cell`` with its files read; raises KeyError for a
    cell ``BENCHMARK.json`` does not name and OSError for a missing file."""
    return resolve_in(read_json(benchmark), cell, benchmark)


def resolve_in(bench: dict, cell: str, where: str = "the benchmark") -> Cell:
    """As ``resolve``, from the benchmark's entries ``bench``."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in {where}")
    w = work[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = read_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = read_json(os.path.join(HERE, "limits", cell + ".json"))
    return Cell(cell, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if reports(m, cell)],
                [m for m in bench["per_layer"] if reports(m, cell)])


def with_later(bench: dict) -> dict:
    """The benchmark's entries with the cells and metrics of LATER added."""
    later = read_json(LATER)
    return dict(bench, workloads=bench["workloads"] + later["workloads"],
                per_layer=bench["per_layer"] + later["per_layer"])


def metric_module(name: str):
    """``metrics/<name>.py``, loaded by its path (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
