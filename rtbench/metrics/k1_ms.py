"""Device ms per frame of K1 and the nearest walks over rays
(kernels/nearest.py -> csrc/nearest.cu)."""

from rtbench.metrics import K1_KERNELS, per_frame_ms

UNIT, LAYER, MOVES = "ms", "K1 nearest walk", "rays_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(K1_KERNELS)
    return per_frame_ms(ctx, us) if us else None
