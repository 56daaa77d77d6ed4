"""Read a ``torch.profiler`` Chrome trace of the traced frames into what
the per-layer metrics take: the device's operations, the host's operations
and the benchmark's frame spans, on one clock (microseconds).

The window is the traced frames' span, from the first frame's start to the
last frame's end (without host spans: from the slice's first launch to
the end of its last device operation).  The device is busy where any of
its operations (kernels, copies, fills) runs; overlapping operations count
once.
"""

from __future__ import annotations

import collections
import json
import re
from typing import List, Optional, Tuple

FRAME_SPAN = "rtbench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host operations that name an idle gap: operators and spans
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 160


def union(intervals) -> List[Tuple[float, float]]:
    """Merged [start, end) intervals of any (start, end) pairs."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi)."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in union(intervals))


class Trace:
    """The events of one traced slice of ``calls`` entry calls, each of
    which renders ``frames_per_call`` frames on this process's card."""

    def __init__(self, events: List[dict], calls: int,
                 frames_per_call: int = 1):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("tid"))
                       for e in xs if e.get("cat") == "user_annotation"
                       and e.get("name") == FRAME_SPAN)
        self.calls = calls
        self.frames = calls * frames_per_call
        if spans:
            self.start, self.end = spans[0][0], spans[-1][1]
            self.main_tid = spans[0][2]
        else:
            # no host spans (the card's activity alone): the slice runs
            # from its first launch to the end of its last operation
            ends = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in xs if e.get("cat") in DEVICE_CATS
                    or e.get("cat") == "cuda_runtime"]
            self.start = min((a for a, _ in ends), default=0.0)
            self.end = max((b for _, b in ends), default=0.0)
            self.main_tid = None
        inside = lambda e: (float(e["ts"]) < self.end
                            and float(e["ts"]) + float(e["dur"]) > self.start)
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and inside(e)]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in xs if e.get("cat") in HOST_CATS
                     and e.get("tid") == self.main_tid and inside(e)
                     and e.get("name") != FRAME_SPAN]

    @classmethod
    def load(cls, path: str, calls: int, frames_per_call: int = 1
             ) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []), calls,
                       frames_per_call)

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        return covered(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in self.device), self.start, self.end)

    def kernel_us(self, pattern: Optional[str] = None,
                  exclude: Optional[str] = None) -> float:
        """Summed time of the kernels whose name matches ``pattern`` (a
        regular expression; None: every kernel) and not ``exclude``."""
        rx = re.compile(pattern) if pattern else None
        ex = re.compile(exclude) if exclude else None
        return sum(float(e["dur"]) for e in self.kernels
                   if (rx is None or rx.search(e.get("name", "")))
                   and (ex is None or not ex.search(e.get("name", ""))))

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, in seconds."""
        by_name = collections.Counter()
        for e in self.device:
            by_name[str(e.get("name", ""))[:NAME_CHARS]] += float(e["dur"])
        return [[n, us / 1e6] for n, us in by_name.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The card's idle gaps, summed by the innermost PyTorch operator
        (or span) running on the host at each gap's midpoint, the longest
        first, in seconds."""
        busy = union((max(float(e["ts"]), self.start),
                      min(float(e["ts"]) + float(e["dur"]), self.end))
                     for e in self.device)
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.end:
            gaps.append((t, self.end))
        # one thread's operations nest: sweep them with a stack
        host = sorted(((float(e["ts"]), -(float(e["ts"]) + float(e["dur"])),
                        str(e.get("name", ""))[:NAME_CHARS])
                       for e in self.host))
        idle = collections.Counter()
        stack, j = [], 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2.0
            while j < len(host) and host[j][0] <= mid:
                while stack and -stack[-1][1] < host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and -stack[-1][1] < mid:
                stack.pop()
            idle[stack[-1][2] if stack else "host, outside any op"] += b - a
        return [[n, us / 1e6] for n, us in idle.most_common(top)]
