"""Host seconds of the program's ``accel.prepared.prepare`` in set-up (the
BVH build, reorder, pad, blocks, tables, and the copy to the card), from
the benchmark's span around that public call."""

UNIT, LAYER, MOVES = "s", "host load and prepare", "setup_s"


def read(ctx):
    return ctx.spans.get("prepare")
