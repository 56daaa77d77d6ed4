"""Structured metrics, spans and traces (JAX ``utils/metrics.py``).

The reference's only instrumentation is one chrono timer printed to stdout
(simple_raytracer.cpp:781-791).  Here: a JSONL metrics sink with timers;
:func:`span`, the program's named spans of a frame and of set-up, recorded
in memory inside :func:`recording` and free outside it; and
:func:`profile_trace`, a ``torch.profiler`` scope that records the spans
and writes a Chrome trace (host ops and spans, and the card's kernels where
a CUDA device is present).  :func:`busy_share` reads such a trace back: the
card's busy share of the traced window.  :func:`count`, :func:`counts` and
:func:`reset_counts` keep the program's counters: what ran, by name
(``module.function.what``: the calls kernels/table.py makes by role, the
launches some wrappers report, the BVH walks' steps).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

TRACE_FILE = "trace.json"
# the span of one frame: every span inside it carries its index
FRAME_SPAN = "srt.frame"
# the card's operations in a Chrome trace: kernels, copies, fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# the program's counters, by key (count, counts, reset_counts)
_counts: Dict[str, int] = {}


def count(key: str, n: int = 1, peak: bool = False) -> None:
    """Add ``n`` to the counter ``key``; with ``peak``, keep the larger of
    the counter and ``n`` instead (the most one call took)."""
    old = _counts.get(key, 0)
    _counts[key] = max(old, n) if peak else old + n


def counts(prefix: str = "") -> Dict[str, int]:
    """A snapshot of the counters whose keys start with ``prefix``."""
    return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Zero the counters whose keys start with ``prefix`` (all of them by
    default)."""
    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]


class Metrics:
    """Append-only JSONL metrics writer that also echoes to stdout."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def emit(self, **record) -> None:
        record.setdefault("ts", round(time.time(), 3))
        line = json.dumps(record)
        if self.echo:
            print(line, flush=True)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    @contextlib.contextmanager
    def timer(self, event: str, **extra):
        t0 = time.time()
        yield
        self.emit(event=event, seconds=round(time.time() - t0, 4), **extra)


class Span(NamedTuple):
    """One recorded span: its ends on the Unix clock in nanoseconds (the
    clock of ``torch.profiler``'s Chrome trace: ``ts`` in microseconds
    after ``baseTimeNanoseconds``), the index of the span that encloses it
    and that of the :data:`FRAME_SPAN` it lies in (None outside any
    frame)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    frame: Optional[int]


class Recorder:
    """The spans of one :func:`recording` scope, in the order they
    opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self._stack: List[int] = []

    def open(self, name: str, start_ns: int) -> int:
        i = len(self.spans)
        parent = self._stack[-1] if self._stack else None
        frame = i if name == FRAME_SPAN else (
            None if parent is None else self.spans[parent].frame)
        self.spans.append(Span(name, start_ns, -1, parent, frame))
        self._stack.append(i)
        return i

    def close(self, i: int, end_ns: int) -> None:
        self.spans[i] = self.spans[i]._replace(end_ns=end_ns)
        self._stack.pop()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Span:
    """A span being recorded, with ``torch.profiler``'s ``record_function``
    of the same name (a ``user_annotation`` of a Chrome trace).  Under a
    profiler that records host operators, entering and leaving an
    annotation takes tens of microseconds; the profiler stamps its start
    midway through the entry and its end at the end of the exit, and so
    does the span."""

    __slots__ = ("rec", "name", "index", "annotation")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        from torch.profiler import record_function
        t0 = time.time_ns()
        self.annotation = record_function(self.name)
        self.annotation.__enter__()
        self.index = self.rec.open(self.name, (t0 + time.time_ns()) // 2)
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        self.rec.close(self.index, time.time_ns())
        return False


_NO_SPAN = _NoSpan()
# the recorder of the innermost recording() scope; None: spans are off
_recorder: Optional[Recorder] = None


def span(name: str):
    """A context manager over one stage of the program (``srt.*``).  Off,
    outside :func:`recording`, it is one shared object that does nothing;
    on, it appends one :class:`Span` to the recorder."""
    rec = _recorder
    return _NO_SPAN if rec is None else _Span(rec, name)


@contextlib.contextmanager
def recording():
    """Turn spans on for the scope; yields the :class:`Recorder`, which
    keeps its spans after the scope.  A scope inside another records into
    the outer one's recorder."""
    global _recorder
    outer = _recorder
    rec = outer or Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler scope over CPU and (where present) CUDA activity that
    records the program's spans and writes a Chrome trace to
    ``log_dir``/trace.json; no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"# profiler trace written to {path}", file=sys.stderr)


def busy_share(trace_path: str) -> dict:
    """The card's share of a Chrome trace's window, from the first event's
    start to the last event's end: the union of its operations' intervals
    (kernels, copies and fills; overlapping ones count once) over the
    window.  Returns kernels (count), kernel_ms (their summed durations),
    busy_ms (the union), window_ms and busy_share."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min((float(e["ts"]) for e in events), default=0.0)
    end = max((float(e["ts"]) + float(e["dur"]) for e in events),
              default=0.0)
    busy_us, reach = 0.0, start
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("cat") in DEVICE_CATS):
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    window_us = end - start
    return {"kernels": len(kernels),
            "kernel_ms": sum(float(e["dur"]) for e in kernels) / 1e3,
            "busy_ms": busy_us / 1e3, "window_ms": window_us / 1e3,
            "busy_share": busy_us / window_us if window_us > 0 else 0.0}
