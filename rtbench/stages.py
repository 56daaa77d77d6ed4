#!/usr/bin/env python3
"""Where a traced frame's host time and the card's idle time go, stage by
stage, from the program's own spans.

    python3 rtbench/stages.py --workload <config>.<traffic> --seed <n>

The program records named spans of its stages when asked
(``simple_raytracer_tpu_torch.utils.metrics``: ``recording``, spans
``srt.*``) on the Unix clock in nanoseconds; a ``torch.profiler`` Chrome
trace puts its events at ``baseTimeNanoseconds`` plus ``ts``
microseconds, so the spans land on the trace's clock.  Every host
interval, kernel launch and idle gap belongs to the innermost span
running at its time: a stage's numbers are its self time, and no two
stages count the same microsecond.

One process: the cell's scene, ``prepare`` (recorded), the warm-up of
``session.WARMUP_CALLS`` calls, then :data:`COST_WINDOWS` windows of
:data:`COST_CALLS` calls with recording off and on in turns (off, on, on,
off, ...: the cost of recording, as each window's median call), then
``session.TRACE_SKIP`` calls and a card slice of ``session.TRACE_CALLS``
calls traced with the card's activity alone (as ``run.py --trace 1``
traces its card slice), recorded.  The last line of standard output is
one JSON object: ``metrics`` (the stage metrics of :func:`stage_metrics`,
and the benchmark's readers of the same slice: ``device_idle_pct``,
``torch_ops_ms``, ``launches_per_frame``, ``k1_ms``, ``anyhit_ms``),
``by_span`` (host ms, device ms and the idle share of the window a frame,
by innermost span), ``walks_in_spans`` (the clock check: the share of the
K1-family and any-hit kernels whose launch lies inside an ``srt.k1`` or
``srt.anyhit`` span), ``cost`` (each window's median call, and what one
span costs the host off and on) and ``device``.  ``--rehearse`` runs the
cell at a tiny size on the CPU (host metrics only), with 2 windows of one
call.  The benchmark's runs do not run it.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtbench import run as rt  # noqa: E402  (its environment, card_line)
from rtbench.metrics import ANYHIT_KERNELS, K1_KERNELS  # noqa: E402
from rtbench.trace import Trace, covered, union  # noqa: E402

PLAN = "srt.plan."
SHADE = "srt.shade"
WALKS = ("srt.k1", "srt.anyhit")
BVH = "srt.prepare.bvh"
OUTSIDE = "outside any span"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the benchmark's readers of the same slice, beside the stage metrics
READERS = ("device_idle_pct", "torch_ops_ms", "launches_per_frame",
           "k1_ms", "anyhit_ms")
# the cost of recording: windows of calls, off and on in turns
COST_WINDOWS, COST_CALLS = 6, 30


def self_intervals(spans, base_ns: int) -> List[Tuple[float, float, str]]:
    """Each span's interval minus those of the spans it encloses, on the
    trace's clock (microseconds after ``base_ns``), sorted: (start, end,
    name).  ``spans`` are one thread's, each with the index of its
    enclosing span (``Span.parent``)."""
    children: Dict[int, list] = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    us = lambda ns: (ns - base_ns) / 1e3
    out = []
    for i, s in enumerate(spans):
        t = us(s.start_ns)
        for c in sorted(children.get(i, []), key=lambda c: c.start_ns):
            if us(c.start_ns) > t:
                out.append((t, us(c.start_ns), s.name))
            t = max(t, us(c.end_ns))
        if us(s.end_ns) > t:
            out.append((t, us(s.end_ns), s.name))
    return sorted(out)


class Stages:
    """A card slice's trace (``events``, ``base_ns``: its
    ``baseTimeNanoseconds``) read against the spans recorded over its
    ``calls`` calls of ``frames_per_call`` frames."""

    def __init__(self, events: List[dict], base_ns: int, spans,
                 calls: int, frames_per_call: int = 1):
        self.trace = Trace(events, calls, frames_per_call)
        self.frames = self.trace.frames
        self.segments = self_intervals(spans, base_ns)
        self._starts = [a for a, _, _ in self.segments]
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        kernels = {e["args"]["correlation"]: e for e in self.trace.kernels
                   if "correlation" in e.get("args", {})}
        # each kernel's launch: the runtime or driver call that shares its
        # correlation id, at that call's start
        self.launches = [(float(e["ts"]), kernels[e["args"]["correlation"]])
                         for e in xs if e.get("cat") in LAUNCH_CATS
                         and e.get("args", {}).get("correlation") in kernels]
        mapped = [((s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3,
                   s.name) for s in spans]
        self.walk_spans = union((a, b) for a, b, n in mapped if n in WALKS)

    def innermost(self, t: float) -> str:
        """The innermost span running at ``t`` (trace microseconds)."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return OUTSIDE

    def per_frame(self, us: float) -> Optional[float]:
        return us / 1e3 / self.frames if self.frames else None

    def host_ms(self, pick: Callable[[str], bool]) -> Optional[float]:
        """Host ms a frame whose innermost span ``pick`` takes."""
        return self.per_frame(sum(b - a for a, b, n in self.segments
                                  if pick(n)))

    def device_ms(self, pick: Callable[[str], bool]) -> Optional[float]:
        """Device ms a frame of the kernels launched where the innermost
        span is one ``pick`` takes; None without launch events."""
        if not self.launches:
            return None
        return self.per_frame(sum(float(k["dur"]) for t, k in self.launches
                                  if pick(self.innermost(t))))

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The window's stretches outside the union of the card's
        operations."""
        t = self.trace
        busy = union((max(float(e["ts"]), t.start),
                      min(float(e["ts"]) + float(e["dur"]), t.end))
                     for e in t.device)
        edges = [t.start, *(x for ab in busy for x in ab), t.end]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def idle_pct(self, pick: Callable[[str], bool]) -> Optional[float]:
        """100 x the part of the window in which the card is idle and the
        innermost span is one ``pick`` takes, over the window."""
        t = self.trace
        if t.window_us <= 0 or not t.device:
            return None
        picked = [(a, b) for a, b, n in self.segments if pick(n)]
        idle = sum(covered(picked, a, b) for a, b in self.idle_gaps())
        return 100.0 * idle / t.window_us

    def by_span(self) -> Dict[str, dict]:
        """Host ms, device ms a frame and the idle share of the window, by
        innermost span; ``OUTSIDE``: the window's time outside every
        span."""
        names = sorted({n for _, _, n in self.segments})
        out = {}
        for name in names:
            pick = name.__eq__
            out[name] = {"host_ms": self.host_ms(pick),
                         "device_ms": self.device_ms(pick),
                         "idle_pct": self.idle_pct(pick)}
        t = self.trace
        if t.window_us > 0 and t.device:
            inside = union((a, b) for a, b, _ in self.segments)
            outside = t.window_us - covered(inside, t.start, t.end)
            idle_out = sum((b - a) - covered(inside, a, b)
                           for a, b in self.idle_gaps())
            out[OUTSIDE] = {"host_ms": self.per_frame(outside),
                            "device_ms": self.device_ms(OUTSIDE.__eq__),
                            "idle_pct": 100.0 * idle_out / t.window_us}
        return out

    def walks_in_spans(self) -> Optional[dict]:
        """The clock check: of the K1-family and any-hit kernels with a
        launch event, how many were launched inside an ``srt.k1`` or
        ``srt.anyhit`` span."""
        rx = re.compile(K1_KERNELS + "|" + ANYHIT_KERNELS)
        walks = [t for t, k in self.launches if rx.search(k.get("name", ""))]
        if not walks:
            return None
        inside = sum(covered(self.walk_spans, t, t + 1e-3) > 0
                     for t in walks)
        return {"kernels": len(walks), "inside": int(inside),
                "pct": 100.0 * inside / len(walks)}


def stage_metrics(st: Stages, setup_spans) -> dict:
    """The five stage metrics: ``plan_host_ms``, ``plan_device_ms``,
    ``shade_device_ms``, ``idle_plan_pct`` (of the card slice ``st``) and
    ``bvh_build_s`` (of the set-up spans); a metric with nothing to read
    is None."""
    plan = lambda n: n.startswith(PLAN)
    bvh = [s for s in setup_spans if s.name == BVH]
    return {"plan_host_ms": st.host_ms(plan),
            "plan_device_ms": st.device_ms(plan),
            "shade_device_ms": st.device_ms(SHADE.__eq__),
            "idle_plan_pct": st.idle_pct(plan),
            "bvh_build_s": (sum(s.end_ns - s.start_ns for s in bvh) / 1e9
                            if bvh else None)}


def load_trace(path: str) -> Tuple[List[dict], int]:
    with open(path) as f:
        trace = json.load(f)
    return trace.get("traceEvents", []), int(trace.get("baseTimeNanoseconds",
                                                       0))


def span_us(pm, n: int = 20000) -> dict:
    """Microseconds one span costs the host, off and recording (no
    profiler running)."""
    out = {}
    for key in ("off", "on"):
        with pm.recording() if key == "on" else contextlib.nullcontext():
            t = time.perf_counter()
            for _ in range(n):
                with pm.span("srt.cost"):
                    pass
            out[key] = 1e6 * (time.perf_counter() - t) / n
    return out


def run_cell(cell, seed: int, cost_windows: int, cost_calls: int,
             device: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtbench import session
    from rtbench import traffic as tr
    from rtbench.scenes.port import to_port
    from rtbench.spec import metric_module
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.utils import metrics as pm

    config, traffic = cell.config, cell.traffic
    scene = cell.scene_builder().build(config, seed)
    cfg = session.program_config(config, traffic)
    port_scene = to_port(scene)
    t0 = time.perf_counter()
    with pm.recording() as setup:
        prep = prepare(port_scene, cfg, device=device)
        session.sync(device)
    prepare_s = time.perf_counter() - t0
    mesh = None
    if traffic["entry"] == "frames_parallel":
        from simple_raytracer_tpu_torch.dist import make_mesh
        mesh = make_mesh(1, ("pp",), device=device)
    light = tuple(float(x) for x in config["light"])
    entry = session.Entry(traffic["entry"], prep, cfg, light, mesh)
    views = tr.Views(traffic, config, seed)
    vpc = int(traffic["views_per_call"])
    c = -session.WARMUP_CALLS

    def call() -> float:
        nonlocal c
        a = time.perf_counter()
        entry([views(c * vpc + i) for i in range(vpc)], c)
        c += 1
        return 1e3 * (time.perf_counter() - a)

    for _ in range(session.WARMUP_CALLS):
        call()
    cost = {"off": [], "on": []}
    for w in range(cost_windows):
        on = w % 4 in (1, 2)
        with pm.recording() if on else contextlib.nullcontext():
            ms = [call() for _ in range(cost_calls)]
        cost["on" if on else "off"].append(statistics.median(ms))
    for _ in range(session.TRACE_SKIP):
        call()
    cuda = torch.device(device).type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    prof.start()
    with pm.recording() as rec:
        for _ in range(session.TRACE_CALLS):
            call()
        session.sync(device)
    prof.stop()
    fd, path = tempfile.mkstemp(prefix="rtbench_stages_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events, base = load_trace(path)
    finally:
        os.unlink(path)
    st = Stages(events, base, rec.spans, session.TRACE_CALLS, vpc)
    metrics = stage_metrics(st, setup.spans)
    ctx = session.Context(st.trace, {"prepare": prepare_s},
                          int(traffic["width"]) * int(traffic["height"]),
                          scene.num_triangles, int(traffic["light_samples"]),
                          st.frames)
    for name in READERS:
        metrics[name] = metric_module(name).read(ctx)
    metrics["prepare_s"] = prepare_s
    return {"workload": cell.name, "seed": seed, "metrics": metrics,
            "by_span": st.by_span(), "walks_in_spans": st.walks_in_spans(),
            "spans_per_frame": len(rec.spans) / max(1, st.frames),
            "cost": {"calls": cost_calls, "off_p50_ms": cost["off"],
                     "on_p50_ms": cost["on"], "span_us": span_us(pm)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rehearse", action="store_true",
                    help="a tiny size on the CPU")
    args = ap.parse_args(argv)
    from rtbench import spec, traffic
    cell = spec.resolve(args.workload)
    cost = (COST_WINDOWS, COST_CALLS)
    if args.rehearse:
        cost = (2, 1)
        cell.traffic, cell.config = traffic.rehearsal(cell.traffic,
                                                      cell.config)
        device, kind = "cpu", "cpu"
    else:
        import torch
        if not torch.cuda.is_available():
            print("rtbench: stages.py needs a CUDA card", file=sys.stderr)
            return 3
        device = "cuda:0"
        torch.cuda.set_device(device)
        kind = f"{torch.cuda.get_device_name(0)}; {rt.card_line()}"
    out = run_cell(cell, args.seed, *cost, device)
    out["device"] = kind
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
