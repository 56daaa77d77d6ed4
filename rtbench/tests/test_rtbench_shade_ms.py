"""The shading kernel's metric (``shade_ms``) on a synthetic trace: the
device ms a frame of csrc/shade.cu's ``shade_kernel``, by name, and
nothing where the trace has no such kernel (a program without it)."""

import re

import pytest

from rtbench import session, spec
from rtbench.metrics import program_kernels
from rtbench.spec import metric_module
from rtbench.trace import FRAME_SPAN, Trace


def X(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


KERNEL = ("void (anonymous namespace)::shade_kernel<true, true, true, "
          "true>((anonymous namespace)::ShadeArgs)")


def test_shade_ms_reads_a_synthetic_trace():
    events = [
        X("user_annotation", FRAME_SPAN, 0, 1000),
        X("user_annotation", FRAME_SPAN, 1000, 1000),
        X("kernel", KERNEL, 100, 40, tid=7),
        X("kernel", KERNEL, 1100, 60, tid=7),
        X("kernel", "my_shade_kernel_x", 1300, 50, tid=7),
        X("kernel", "void at::native::elementwise_kernel<128, 2>()", 1500,
          30, tid=7),
    ]
    t = Trace(events, calls=2)
    ctx = session.Context(t, {}, 600 * 400, 81932, 16, t.frames)
    mod = metric_module("shade_ms")
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == ("ms", "shading",
                                                "rays_per_s")
    assert mod.read(ctx) == pytest.approx(0.05)
    # the kernel is the program's, so torch_ops_ms leaves it out
    assert re.search(program_kernels(), KERNEL)
    assert metric_module("torch_ops_ms").read(ctx) == pytest.approx(0.04)
    none = session.Context(Trace(events[:2] + events[4:], calls=2), {}, 1,
                           1, 16, 2)
    assert mod.read(none) is None
    assert mod.read(session.Context(None, {}, 1, 1, 16, 0)) is None


def test_shade_ms_lists_the_soft_cells():
    bench = spec.read_json(spec.BENCHMARK)
    entry, = [m for m in bench["per_layer"] if m["name"] == "shade_ms"]
    assert entry["workloads"] == ["textured6.soft600", "dense6.soft600"]
    assert entry["source"] == "device_trace"
