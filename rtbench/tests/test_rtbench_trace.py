"""The trace reader on a synthetic trace: overlapping kernels on two
streams count once, the idle gaps take the host operation running in them,
and the readers pick their kernels by name."""

import re

import pytest

from rtbench import roofline, session
from rtbench.metrics import ANYHIT_KERNELS, K1_KERNELS, program_kernels
from rtbench.spec import metric_module
from rtbench.trace import FRAME_SPAN, Trace, union


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def synthetic():
    return [
        X("user_annotation", FRAME_SPAN, 0, 100),
        X("user_annotation", FRAME_SPAN, 100, 100),
        # host: an aten op that launches one kernel; ctypes launches two
        X("cpu_op", "aten::add", 5, 10),
        X("cuda_runtime", "cudaLaunchKernel", 6, 2, correlation=1),
        X("cuda_runtime", "cudaLaunchKernel", 30, 2, correlation=2),
        X("cuda_runtime", "cudaLaunchKernel", 120, 2, correlation=3),
        X("cpu_op", "aten::nonzero", 150, 40),
        # device: two overlapping kernels on two streams, a copy
        X("kernel", "void at::native::add_kernel()", 10, 20, tid=7,
          correlation=1),
        X("kernel", "void k1_walk_kernel<2>(int*)", 20, 30, tid=8,
          correlation=2),
        X("kernel", "anyhit_items_kernel<4, true>", 120, 10, tid=7,
          correlation=3),
        X("gpu_memcpy", "Memcpy DtoH", 190, 10, tid=7),
        X("kernel", "late", 500, 10, tid=7),
    ]


def test_union_merges_overlaps():
    assert union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]


def test_busy_counts_overlap_once_and_idle_gaps_carry_the_host_op():
    t = Trace(synthetic(), calls=2)
    assert (t.calls, t.frames, t.window_us) == (2, 2, 200)
    assert t.busy_us() == 40 + 10 + 10      # [10, 50) once, 120-130, copy
    assert t.kernel_us(K1_KERNELS) == 30
    assert t.kernel_us(ANYHIT_KERNELS) == 10
    assert t.kernel_us(exclude=K1_KERNELS) == 30
    gaps = dict(t.idle_gaps())
    assert gaps["aten::nonzero"] == pytest.approx(60e-6)   # 130-190
    assert sum(gaps.values()) == pytest.approx(140e-6)
    ops = dict(t.device_ops())
    assert ops["void k1_walk_kernel<2>(int*)"] == pytest.approx(30e-6)


def test_without_host_spans_the_window_runs_from_launch_to_last_op():
    events = [e for e in synthetic() if e["cat"] not in ("user_annotation",
                                                        "cpu_op")]
    t = Trace(events, calls=2)
    assert (t.start, t.end) == (6, 510)
    assert t.busy_us() == 70


def test_metric_readers_on_the_synthetic_trace():
    t = Trace(synthetic(), calls=2)
    ctx = session.Context(t, {"prepare": 1.5}, 1000, 100, 1, t.frames)
    read = lambda n: metric_module(n).read(ctx)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 60 / 200))
    assert read("k1_ms") == pytest.approx(0.015)
    assert read("anyhit_ms") == pytest.approx(0.005)
    assert read("torch_ops_ms") == pytest.approx(0.010)
    assert read("launches_per_frame") == 1.5
    assert read("gather_ms") is None
    assert read("prepare_s") == 1.5
    least = roofline.least_ms(roofline.nearest_bytes(100, 1000))
    assert read("k1_roofline_pct") == pytest.approx(100 * least / 0.015)


def test_readers_find_nothing_without_a_trace():
    ctx = session.Context(None, {}, 1000, 100, 1, 0)
    for n in ("device_idle_pct", "k1_ms", "k1_roofline_pct", "anyhit_ms",
              "anyhit_roofline_pct", "torch_ops_ms", "launches_per_frame",
              "gather_ms"):
        assert metric_module(n).read(ctx) is None


@pytest.mark.parametrize("name", [
    "void k1_epilogue_kernel<1>(int const*, int)", "rays_walk_kernel<8>",
    "anyhit_items_kernel<4, true>", "prepass_items_kernel<2>",
    "attr_gather_kernel", "fixed_probe_kernel(float const*)"])
def test_the_program_kernels_are_read_from_its_sources(name):
    assert re.search(program_kernels(), name)


@pytest.mark.parametrize("name", ["void at::native::add_kernel()",
                                  "my_schedule_kernel_x", "ncclKernel"])
def test_other_kernels_are_not_the_programs(name):
    assert not re.search(program_kernels(), name)
