"""Structured metrics and traces (JAX ``utils/metrics.py``).

The reference's only instrumentation is one chrono timer printed to stdout
(simple_raytracer.cpp:781-791).  Here: a JSONL metrics sink with timers,
and :func:`profile_trace`, a ``torch.profiler`` scope that writes a Chrome
trace (host ops, and the card's kernels where a CUDA device is present).
:func:`busy_share` reads such a trace back: the card's summed kernel time
over the traced window.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

TRACE_FILE = "trace.json"


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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler scope over CPU and (where present) CUDA activity that
    writes a Chrome trace to ``log_dir``/trace.json; no-op when log_dir is
    None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"# profiler trace written to {path}", file=sys.stderr)


def busy_share(trace_path: str) -> dict:
    """The card's share of a Chrome trace's window: the summed duration of
    its CUDA kernels (events of category "kernel") over the window from the
    first event's start to the last event's end.  Returns kernels (count),
    kernel_ms, window_ms and busy_share."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min((float(e["ts"]) for e in events), default=0.0)
    end = max((float(e["ts"]) + float(e["dur"]) for e in events),
              default=0.0)
    kernel_us = sum(float(e["dur"]) for e in kernels)
    window_us = end - start
    return {"kernels": len(kernels), "kernel_ms": kernel_us / 1e3,
            "window_ms": window_us / 1e3,
            "busy_share": kernel_us / window_us if window_us > 0 else 0.0}
