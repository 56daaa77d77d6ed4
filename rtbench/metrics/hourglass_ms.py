"""Device ms per frame of the hourglass planner kernel (kernels/plan.py ->
csrc/plan.cu's plan_hourglass_kernel: the fold plans of soft shadows on
scenes over 131,072 triangles)."""

from rtbench.metrics import per_frame_ms

UNIT, LAYER, MOVES = "ms", "planner", "rays_per_s"
HOURGLASS_KERNEL = r"(?<![A-Za-z0-9_])plan_hourglass_kernel(?![A-Za-z0-9_])"


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(HOURGLASS_KERNEL)
    return per_frame_ms(ctx, us) if us else None
