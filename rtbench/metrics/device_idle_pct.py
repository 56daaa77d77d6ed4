"""The card's idle share of the traced frames: 100 x (1 - the union of its
operations' intervals (kernels, copies, fills) over the window from the
first traced frame's start to the last one's end).  The first process's
card where a cell runs several."""

UNIT, LAYER, MOVES = "%", "device", "rays_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
