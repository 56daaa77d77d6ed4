"""The hourglass planner kernel's share of its roofline: the least time of
a frame's hourglass fold plan, counted from the frame's and the scene's
shapes alone, over hourglass_ms.

The fold plans each tile of 1,024 shadow rays (a kernel tile of 1,024 / S
hit points, each with its S light samples) against every 32-triangle
block: ceil(W H S / 1,024) x ceil(T / 32) (tile, block) pairs.  A pair is
OPS_PER_PAIR f32 operations (the hourglass test, plan.py::
visibility_hourglass): for each of its 2 branches (t in [0, 1], t >= 1),
3 axes and 2 lines, a difference, a division, the margin's absolute value,
add and multiply, the widened bound and a minimum or maximum (7); the 2
branches' comparisons; their combine's minimum, clamp and finiteness test
(3); and the own-object comparison.  The bytes: each block's box and
object id and each tile's two boxes read once, one bit written for each
pair.  The least time is the larger of the operations at F32_OPS_PER_S and
the bytes at roofline.HBM_BYTES_PER_S."""

import math

from rtbench import roofline
from rtbench.metrics import per_frame_ms
from rtbench.metrics.hourglass_ms import HOURGLASS_KERNEL

UNIT, LAYER, MOVES = "%", "planner", "rays_per_s"
# NVIDIA H100 SXM5 (NVIDIA's data sheet): f32 outside the tensor cores
F32_OPS_PER_S = 67e12
FOLD_RAYS, BLOCK_TRIANGLES = 1024, 32
OPS_PER_PAIR = 2 * 3 * 2 * 7 + 2 + 3 + 1
BLOCK_BYTES, TILE_BYTES = 28, 48


def least_ms(pixels: int, samples: int, triangles: int) -> float:
    """The least time of one frame's hourglass fold plan."""
    tiles = math.ceil(pixels * samples / FOLD_RAYS)
    blocks = math.ceil(triangles / BLOCK_TRIANGLES)
    pairs = tiles * blocks
    ops_ms = pairs * OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    nbytes = blocks * BLOCK_BYTES + tiles * TILE_BYTES + pairs / 8.0
    return max(ops_ms, roofline.least_ms(nbytes))


def read(ctx):
    if ctx.trace is None:
        return None
    ms = per_frame_ms(ctx, ctx.trace.kernel_us(HOURGLASS_KERNEL))
    if not ms:
        return None
    least = least_ms(ctx.rays_per_frame, ctx.light_samples, ctx.triangles)
    return 100.0 * least / ms
