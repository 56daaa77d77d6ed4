"""stages.py: the program's spans against a synthetic card slice (nested
spans, launch events joined to kernels by correlation id, idle gaps inside
and outside the planners' spans) give the hand-computed stage metrics; each
one-card cell, rehearsed on the CPU, reports ``plan_host_ms`` and
``bvh_build_s``."""

import json
import os
import subprocess
import sys

import pytest

from rtbench import session, spec, stages
from rtbench.spec import metric_module
from simple_raytracer_tpu_torch.utils.metrics import Span

BASE = 1_700_000_000_000_000_000


def ns(us):
    return BASE + int(us * 1000)


def span(name, a, b, parent, frame):
    return Span(name, ns(a), ns(b), parent, frame)


SPANS = [
    span("srt.frame", 0, 100, None, 0),
    span("srt.plan.primary", 10, 30, 0, 0),
    span("srt.k1", 30, 50, 0, 0),
    span("srt.shade", 60, 90, 0, 0),
    span("srt.plan.shadow", 62, 70, 3, 0),
    span("srt.anyhit", 70, 80, 3, 0),
    span("srt.frame", 100, 200, None, 6),
    span("srt.plan.primary", 110, 140, 6, 6),
    span("srt.k1", 140, 150, 6, 6),
]


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def synthetic(launches=True):
    # (correlation, launch at, kernel, start, duration)
    work = [(1, 12, "void at::native::where_kernel()", 15, 5),
            (2, 35, "void k1_walk_kernel<2>(int*)", 40, 30),
            (3, 64, "void at::native::mul_kernel()", 72, 3),
            (4, 75, "anyhit_items_kernel<4, true>", 76, 10),
            (5, 85, "void at::native::add_kernel()", 88, 2),
            (8, 95, "anyhit_schedule_kernel", 96, 1),
            (6, 115, "void at::native::where_kernel()", 118, 4),
            (7, 145, "void k1_walk_kernel<2>(int*)", 146, 20)]
    ev = [X("kernel", k, s, d, correlation=c) for c, _, k, s, d in work]
    if launches:
        ev += [X("cuda_runtime", "cudaLaunchKernel", t, 1, correlation=c)
               for c, t, _, _, _ in work]
    else:
        ev.append(X("cuda_runtime", "cudaMemcpyAsync", 12, 1))
    return ev + [X("gpu_memcpy", "Memcpy DtoH", 190, 5)]


def test_self_intervals_partition_the_spans():
    segs = stages.self_intervals(SPANS, BASE)
    assert segs[:9] == [(0, 10, "srt.frame"), (10, 30, "srt.plan.primary"),
                        (30, 50, "srt.k1"), (50, 60, "srt.frame"),
                        (60, 62, "srt.shade"), (62, 70, "srt.plan.shadow"),
                        (70, 80, "srt.anyhit"), (80, 90, "srt.shade"),
                        (90, 100, "srt.frame")]
    assert sum(b - a for a, b, _ in segs) == 200


def test_stage_metrics_on_a_synthetic_slice():
    st = stages.Stages(synthetic(), BASE, SPANS, calls=2)
    # the window runs from the first launch (12) to the copy's end (195)
    assert (st.trace.start, st.trace.end) == (12, 195)
    setup = [span("srt.prepare", 0, 5e6, None, None),
             span("srt.prepare.bvh", 1e6, 3.5e6, 0, None)]
    m = stages.stage_metrics(st, setup)
    # planners' self time: 20 + 8 + 30 us over 2 frames
    assert m["plan_host_ms"] == pytest.approx(0.029)
    # kernels launched inside a planner span: 5 + 3 + 4 us
    assert m["plan_device_ms"] == pytest.approx(0.006)
    # the shading's own launch (2 us); the any-hit walk inside it is not
    assert m["shade_device_ms"] == pytest.approx(0.001)
    # idle inside the planners: [12, 15) + [20, 30) + [110, 118) + [122, 140)
    assert m["idle_plan_pct"] == pytest.approx(100 * 39 / 183)
    assert m["bvh_build_s"] == pytest.approx(2.5)
    idle = metric_module("device_idle_pct").read(
        session.Context(st.trace, {}, 1, 1, 1, st.frames))
    assert idle == pytest.approx(100 * (183 - 80) / 183)
    assert m["idle_plan_pct"] <= idle
    walks = st.walks_in_spans()
    assert walks == {"kernels": 4, "inside": 3, "pct": 75.0}
    rows = st.by_span()
    assert rows["srt.k1"]["device_ms"] == pytest.approx(0.025)
    assert rows["srt.anyhit"]["device_ms"] == pytest.approx(0.005)
    assert rows["srt.frame"]["device_ms"] == pytest.approx(0.0005)
    assert rows[stages.OUTSIDE]["host_ms"] == 0
    assert sum(r["idle_pct"] for r in rows.values()) == pytest.approx(idle)


def test_without_launch_events_device_metrics_read_nothing():
    st = stages.Stages(synthetic(launches=False), BASE, SPANS, calls=2)
    m = stages.stage_metrics(st, [])
    assert m["plan_device_ms"] is None and m["shade_device_ms"] is None
    assert m["bvh_build_s"] is None and st.walks_in_spans() is None
    assert m["plan_host_ms"] == pytest.approx(0.029)


ONE = [w["name"] for w in spec.read_json(spec.BENCHMARK)["workloads"]
       if w["chips"] == 1]


@pytest.mark.parametrize("cell", ONE)
def test_rehearsal_reports_the_host_stage_metrics(cell):
    p = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "stages.py"), "--workload",
         cell, "--seed", "2147483659", "--rehearse"], capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    m = out["metrics"]
    assert m["plan_host_ms"] > 0 and 0 < m["bvh_build_s"] < m["prepare_s"]
    assert out["device"] == "cpu" and out["spans_per_frame"] >= 7
    cost = out["cost"]
    assert len(cost["off_p50_ms"]) == len(cost["on_p50_ms"])
    assert 0 < cost["span_us"]["off"] < cost["span_us"]["on"]
