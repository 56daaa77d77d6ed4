"""Kernels launched per frame on the traced card (every kernel, the
program's own, PyTorch's and NCCL's): a count that repeats, which falls
when the PyTorch ops of the planners, the integrator and the finish are
merged."""

UNIT, LAYER, MOVES = "launches", "PyTorch ops", "rays_per_s"


def read(ctx):
    if ctx.trace is None or ctx.frames_traced == 0 or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.frames_traced
