"""K1's share of its roofline: the least time of the frame's compulsory
nearest-walk traffic (rtbench/roofline.py) over k1_ms."""

from rtbench import roofline
from rtbench.metrics import K1_KERNELS, per_frame_ms

UNIT, LAYER, MOVES = "%", "K1 nearest walk", "rays_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    ms = per_frame_ms(ctx, ctx.trace.kernel_us(K1_KERNELS))
    if not ms:
        return None
    least = roofline.least_ms(roofline.nearest_bytes(ctx.triangles,
                                                     ctx.rays_per_frame))
    return 100.0 * least / ms
