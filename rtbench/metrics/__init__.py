"""Per-layer metrics, one file each, found by name (``spec.metric_module``).

Each file sets UNIT, LAYER (as PERF.md's list of layers names it) and
MOVES (the end-to-end metric it should move), and defines
``read(ctx) -> float | None``.  ``ctx`` (``session.Context``) holds the
trace of the traced frames (``trace.Trace``, or None), the benchmark's own
spans (seconds by name) and the frame's shapes.  A reader that finds
nothing to read returns None, and the line leaves the metric out.
"""

import glob
import os
import re

# the kernels of the program's csrc/nearest.cu and csrc/anyhit.cu
K1_KERNELS = (r"(?<![A-Za-z0-9_])(schedule_kernel|k1_walk_kernel|"
              r"k1_epilogue_kernel|rays_walk_kernel|rays_decode_kernel)"
              r"(?![A-Za-z0-9_])")
ANYHIT_KERNELS = (r"(?<![A-Za-z0-9_])(anyhit_schedule_kernel|"
                  r"anyhit_items_kernel)(?![A-Za-z0-9_])")
NCCL_KERNELS = r"[Nn][Cc][Cc][Ll]"
# a kernel the program builds: `__global__ void [__launch_bounds__(...)] name(`
GLOBAL_FN = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                       r"\([^)]*\)\s+)?([A-Za-z_][A-Za-z0-9_]*)\s*\(")


def program_kernels() -> str:
    """A pattern of every kernel the program builds from its csrc/: the
    ``__global__`` functions of ``simple_raytracer_tpu_torch/csrc/*.cu``,
    read as text, and those of K1_KERNELS and ANYHIT_KERNELS."""
    from rtbench.spec import ROOT
    names = set()
    for path in glob.glob(os.path.join(ROOT, "simple_raytracer_tpu_torch",
                                       "csrc", "*.cu")):
        with open(path) as f:
            names.update(GLOBAL_FN.findall(f.read()))
    found = (r"(?<![A-Za-z0-9_])(" + "|".join(sorted(names))
             + r")(?![A-Za-z0-9_])") if names else None
    return "|".join(p for p in (found, K1_KERNELS, ANYHIT_KERNELS) if p)


def per_frame_ms(ctx, us: float):
    """Microseconds over the traced frames -> ms per frame, or None
    without a trace or a frame."""
    if ctx.trace is None or ctx.frames_traced == 0:
        return None
    return us / 1e3 / ctx.frames_traced
