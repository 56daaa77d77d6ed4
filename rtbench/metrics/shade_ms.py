"""Device ms per frame of the shading kernel (render/integrator.py ->
csrc/shade.cu's shade_kernel: the hits' Phong over the light samples, the
shadow dim and the tone map, on the frames that shade by triangle id)."""

from rtbench.metrics import per_frame_ms

UNIT, LAYER, MOVES = "ms", "shading", "rays_per_s"
SHADE_KERNEL = r"(?<![A-Za-z0-9_])shade_kernel(?![A-Za-z0-9_])"


def read(ctx):
    if ctx.trace is None:
        return None
    us = ctx.trace.kernel_us(SHADE_KERNEL)
    return per_frame_ms(ctx, us) if us else None
