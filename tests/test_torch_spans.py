"""PyTorch port, the program's spans (``utils/metrics.py``: ``span``,
``recording``, ``profile_trace``) and ``busy_share``, on the CPU through
the tiled path's plain kernels.

* off (outside ``recording``), ``span`` is one shared object that records
  nothing;
* a frame renders the same image with recording on and off, and the
  registry's counters (``metrics.counts``) move alike;
* on, each stage's span is recorded where it runs in each branch of the
  tiled frame (the planners, the walks, the shading, the finish), nested
  under ``srt.frame`` with its parent and frame set, one frame id per
  frame; ``prepare`` records ``srt.prepare`` and ``srt.prepare.bvh``;
* under ``torch.profiler`` each span, mapped through the trace's
  ``baseTimeNanoseconds``, lies within 50 us of the ``user_annotation``
  of the same name, and ``render --profile DIR`` writes a trace holding
  the frame's spans;
* ``busy_share`` counts overlapping kernels, copies and fills once.
"""

import json
import os

import pytest
import torch

import simple_raytracer_tpu_torch as sr
from simple_raytracer_tpu_torch import cli
from simple_raytracer_tpu_torch.accel.prepared import prepare
from simple_raytracer_tpu_torch.driver import animation
from simple_raytracer_tpu_torch.kernels import tiled
from simple_raytracer_tpu_torch.scene import procedural as P
from simple_raytracer_tpu_torch.utils import metrics

TILE = 64 * 64
CAM = sr.CameraConfig(width=96, height=64, focal=P.bench_focal(64))
# the stages each branch of the frame runs, and the span that encloses each
# stage's span (the frame, or the shading, which runs the shadow query)
IN_FRAME = ("srt.plan.primary", "srt.k1", "srt.shade", "srt.finish")
SHADOW_IN_SHADE = {"srt.plan.shadow": "srt.shade",
                   "srt.anyhit": "srt.shade"}
SHADOW_IN_FRAME = {"srt.plan.shadow": "srt.frame",
                   "srt.anyhit": "srt.frame"}
BRANCHES = {
    "fused": (P.sphere_on_ground, {}, SHADOW_IN_FRAME),
    "fused_textured": (P.textured_on_ground, {}, SHADOW_IN_FRAME),
    "soft": (P.sphere_on_ground, dict(light=sr.LightConfig(num_samples=4)),
             SHADOW_IN_SHADE),
    "gather": (P.sphere_on_ground,
               dict(kernel=sr.KernelConfig(groups=4, groups_ah=4)),
               SHADOW_IN_SHADE),
    "paged": (P.sphere_on_ground, dict(tiled_impl="paged"),
              SHADOW_IN_SHADE),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """The prepared scenes by builder, and the spans their ``prepare``
    recorded."""
    out = {}
    for build in (P.sphere_on_ground, P.textured_on_ground):
        cfg = sr.default_config().replace(mode="tiled", camera=CAM)
        with metrics.recording() as rec:
            prep = prepare(build(sr.SceneManager(), 2).build(), cfg,
                           device="cpu")
        out[build] = (prep, rec.spans)
    return out


def _chain(spans, i):
    """Names from span i out to the outermost span."""
    out = []
    while i is not None:
        out.append(spans[i].name)
        i = spans[i].parent
    return out


def _check_nesting(spans):
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns, s
        if s.parent is not None:
            p = spans[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns \
                and s.end_ns <= p.end_ns, (s, p)


def test_span_off_is_one_shared_noop():
    a, b = metrics.span("srt.frame"), metrics.span("srt.k1")
    assert a is b
    with a, b:
        pass
    with metrics.recording() as rec:
        with metrics.span("srt.k1"):
            pass
    assert metrics.span("srt.k1") is a
    with metrics.span("srt.k1"):
        pass
    assert [s.name for s in rec.spans] == ["srt.k1"]


def test_prepare_records_the_bvh_build(scenes):
    for _prep, spans in scenes.values():
        assert [(s.name, s.parent, s.frame) for s in spans] == [
            ("srt.prepare", None, None), ("srt.prepare.bvh", 0, None)]
        _check_nesting(spans)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_stages_recorded_in_every_branch(scenes, branch):
    build, extra, shadow = BRANCHES[branch]
    prep = scenes[build][0]
    cfg = sr.default_config().replace(mode="tiled", camera=CAM, **extra)
    assert tiled.frame_branch(prep, cfg, TILE) == branch.split("_")[0]
    before = metrics.counts()
    off = sr.render(prep, cfg, P.BENCH_LIGHT)
    mid = metrics.counts()
    with metrics.recording() as rec:
        on = sr.render(prep, cfg, P.BENCH_LIGHT)
    after = metrics.counts()
    assert torch.equal(off, on)
    assert {k: v - before.get(k, 0) for k, v in mid.items()} == \
        {k: v - mid.get(k, 0) for k, v in after.items()}
    spans = rec.spans
    _check_nesting(spans)
    assert spans[0].name == "srt.frame" and spans[0].parent is None
    assert {s.frame for s in spans} == {0}
    names = {s.name for s in spans}
    assert names == {"srt.frame", *IN_FRAME, *shadow}
    if branch == "fused_textured":
        assert sum(s.name == "srt.shade" for s in spans) == 2
    for i, s in enumerate(spans):
        chain = _chain(spans, i)
        assert chain[-1] == "srt.frame"
        if s.name in shadow:
            assert chain[1] == shadow[s.name], chain
        elif s.name != "srt.frame":
            assert chain[1] == "srt.frame", chain


def test_each_frame_of_a_batch_has_its_own_id(scenes):
    prep = scenes[P.sphere_on_ground][0]
    cfg = sr.default_config().replace(mode="tiled", camera=CAM)
    views = torch.eye(4).expand(2, 4, 4).clone()
    views[1, 0, 3] = 0.5
    with metrics.recording() as rec:
        animation.frames_batched(prep, cfg, views, P.BENCH_LIGHT,
                                 device="cpu")
    frames = [i for i, s in enumerate(rec.spans)
              if s.name == "srt.frame" and s.parent is None]
    assert len(frames) == 2
    assert [s.frame for s in rec.spans] == [
        frames[0] if i < frames[1] else frames[1]
        for i in range(len(rec.spans))]


def _annotations(path):
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    out = {}
    for e in sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("srt.")),
                    key=lambda e: float(e["ts"])):
        a = base + float(e["ts"]) * 1e3
        out.setdefault(e["name"], []).append((a, a + float(e["dur"]) * 1e3))
    return out


def test_spans_lie_on_the_profiler_clock(scenes, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    prep = scenes[P.sphere_on_ground][0]
    cfg = sr.default_config().replace(mode="tiled", camera=CAM)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the profiler's first annotation and operator run slow
        with record_function("warm-up"):
            torch.ones(8).add_(1)
        with metrics.recording() as rec:
            sr.render(prep, cfg, P.BENCH_LIGHT)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ann = _annotations(path)
    seen = {}
    for s in rec.spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        a, b = ann[s.name][k]
        assert abs(s.start_ns - a) <= 50e3 and abs(s.end_ns - b) <= 50e3, \
            (s, a, b)
    assert seen == {n: len(v) for n, v in ann.items()}


def test_cli_profile_trace_holds_the_spans(tmp_path):
    root = tmp_path / "assets"
    root.mkdir()
    (root / "cube.obj").write_text(P.obj_text(P.box()))
    d = str(tmp_path / "trace")
    assert cli.main(["render", "--scene", "one_cube", "--root", str(root),
                     "--mode", "tiled", "--width", "60", "--height", "40",
                     "--device", "cpu", "--profile", d,
                     "--out", str(tmp_path / "f.png")]) == 0
    ann = _annotations(os.path.join(d, metrics.TRACE_FILE))
    assert {"srt.prepare", "srt.prepare.bvh", "srt.frame",
            "srt.plan.primary", "srt.k1", "srt.finish"} <= set(ann)


def test_busy_share_counts_overlaps_once(tmp_path):
    def x(cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur}
    events = [x("cpu_op", 0.0, 40.0), x("kernel", 0.0, 10.0),
              x("kernel", 2.0, 10.0), x("gpu_memcpy", 20.0, 5.0),
              x("gpu_memset", 22.0, 1.0)]
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    share = metrics.busy_share(path)
    assert share["kernels"] == 2 and share["kernel_ms"] == pytest.approx(
        0.020)
    assert share["window_ms"] == pytest.approx(0.040)
    assert share["busy_ms"] == pytest.approx(0.017)
    assert share["busy_share"] == pytest.approx(17.0 / 40.0)
