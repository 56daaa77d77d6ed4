"""Device ms per call of NCCL's kernels on the first process: the frames'
all-gather of ``frames_parallel`` (dist/sharding.py::Axis.all_gather)."""

from rtbench.metrics import NCCL_KERNELS

UNIT, LAYER, MOVES = "ms", "distribution", "rays_per_s"


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    us = ctx.trace.kernel_us(NCCL_KERNELS)
    return us / 1e3 / ctx.trace.calls if us else None
