"""Device ms per frame of the kernels PyTorch's operators launch (the
planners of kernels/plan.py, render/integrator.py, the finish): every
kernel but the program's own (the ``__global__`` functions of its csrc/)
and NCCL's."""

from rtbench.metrics import NCCL_KERNELS, per_frame_ms, program_kernels

UNIT, LAYER, MOVES = "ms", "PyTorch ops", "rays_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(exclude=program_kernels() + "|" + NCCL_KERNELS)
    return per_frame_ms(ctx, us) if us else None
