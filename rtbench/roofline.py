"""Peaks and compulsory traffic, for the kernels' roofline shares.

The least time a kernel's work can take is its compulsory traffic at the
card's peak memory bandwidth: each input read once and each output written
once, counted from the scene and the frame's shapes alone, never from the
program's plans, so the count is the same whatever implements the walk.
"""

# NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
# one triangle as a walk reads it: three vertices of three float32
TRIANGLE_BYTES = 36
# the nearest walk's answer per primary ray: t (float32) and id (int32)
NEAREST_RAY_BYTES = 8


def nearest_bytes(triangles: int, rays: int) -> float:
    """K1: every triangle read once, t and id written for every ray."""
    return TRIANGLE_BYTES * triangles + NEAREST_RAY_BYTES * rays


def anyhit_bytes(triangles: int, rays: int, samples: int) -> float:
    """The any-hit walk: every triangle read once, one bit written for
    every primary ray and light sample."""
    return TRIANGLE_BYTES * triangles + rays * samples / 8.0


def least_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3
