"""The any-hit walk's share of its roofline: the least time of the frame's
compulsory any-hit traffic (rtbench/roofline.py) over anyhit_ms."""

from rtbench import roofline
from rtbench.metrics import ANYHIT_KERNELS, per_frame_ms

UNIT, LAYER, MOVES = "%", "any-hit walk", "rays_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    ms = per_frame_ms(ctx, ctx.trace.kernel_us(ANYHIT_KERNELS))
    if not ms:
        return None
    least = roofline.least_ms(roofline.anyhit_bytes(
        ctx.triangles, ctx.rays_per_frame, ctx.light_samples))
    return 100.0 * least / ms
