"""Device ms per frame of the any-hit walks (kernels/anyhit.py ->
csrc/anyhit.cu: K2 from t, K2' over the folded shadow rays)."""

from rtbench.metrics import ANYHIT_KERNELS, per_frame_ms

UNIT, LAYER, MOVES = "ms", "any-hit walk", "rays_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(ANYHIT_KERNELS)
    return per_frame_ms(ctx, us) if us else None
