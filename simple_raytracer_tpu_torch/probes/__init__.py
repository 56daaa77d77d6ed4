"""Microbenchmarks of the port's kernels on the card.

Counterparts of the JAX package's Pallas probes under ``scripts/``, each a
Hopper kernel of its own with a plain PyTorch version beside it:

* :mod:`.fixed` (``csrc/probe_fixed.cu``): the parts of K1's fixed cost per
  tile (``scripts/fixed_probe.py``, ``fixed_probe2.py``,
  ``fixed_probe3.py``): block IO, the feature build, the best-hit keep, the
  stores, the grid, and K1 itself on plans cut to one window and to none;
* :mod:`.attr` (``csrc/probe_attr.cu``): the winner's attribute fetch by id
  (``scripts/attr_probe.py``, ``scripts/attr_fetch_probe.py``).

No frame runs them.  Each module's wrappers launch its kernels on CUDA
tensors; kernels/table.py runs the plain versions for CPU tensors
(roles ``fixed``, ``attr_gather``, ``attr_window``).  Its ``main()`` times them
on a card (``python -m simple_raytracer_tpu_torch.probes.fixed`` or
``.attr``) and raises on a host with none.
"""

from __future__ import annotations

import time

import torch

# device cycles to spin per timed call before the timed calls start (about
# 0.5 ms at the H100's clock): the host queues every call meanwhile
SLEEP_CYCLES = 1_000_000
# bytes written before each call timed cold: over twice the H100's 50 MB
# L2, so the call finds its inputs in device memory
FLUSH_BYTES = 128 << 20


def require_cuda() -> None:
    """Raise RuntimeError unless a CUDA device is present: the probes time
    a card, and a CPU number is no device number."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time a CUDA device; none is present")


def device_ms(fn, frames: int, flush: bool = False):
    """(Mean device time in ms of ``fn`` over ``frames`` calls after a
    warm-up call, host ms per call).  The device first spins while the
    host queues every call, so the CUDA events time the calls back to back
    on the device and not the host's pace: a probe's kernel takes a few µs,
    less than its wrapper's host work.  With ``flush`` each call is timed
    cold: a write of FLUSH_BYTES before it, outside its own pair of
    events, evicts its inputs from the L2, so a probe that moves less than
    the L2 holds is timed against device memory, as its bound counts it."""
    if flush:
        # the buffer first, then a flushed warm-up: the caching allocator
        # settles (no allocation from the device) before the timed calls
        buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                          device=torch.cuda.current_device())
        for _ in range(2):
            buf.zero_()
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(frames)]
        torch.cuda._sleep(SLEEP_CYCLES * frames)
        host = 0.0
        for a, b in events:
            buf.zero_()
            a.record()
            t0 = time.perf_counter()
            fn()
            host += time.perf_counter() - t0
            b.record()
        torch.cuda.synchronize()
        return (sum(a.elapsed_time(b) for a, b in events) / frames,
                host * 1e3 / frames)
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES * frames)
    a.record()
    t0 = time.perf_counter()
    for _ in range(frames):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / frames
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / frames, host_ms


def record(probe: str, times, tiles: int, lanes: int, **extra) -> dict:
    """One probe's timing from :func:`device_ms`'s ``times``: device ms
    per frame, µs per tile, ns per lane, and the host's µs per call."""
    ms, host_ms = times
    return {"probe": probe, "ms": ms, "us_per_tile": ms * 1e3 / tiles,
            "ns_per_lane": ms * 1e6 / lanes, "host_us_per_call": host_ms * 1e3,
            "tiles": tiles, "lanes": lanes, **extra}


def line(r: dict) -> str:
    """The scripts' printed line for a :func:`record`."""
    return (f"[{r['probe']}] n={r['tiles']} {r['ms']:7.4f} ms/frame "
            f"({r['us_per_tile']:.4f} us/tile, {r['ns_per_lane']:.5f} "
            f"ns/lane; host {r['host_us_per_call']:.1f} us/call)")
