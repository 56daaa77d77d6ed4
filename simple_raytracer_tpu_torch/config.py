"""Configuration for the PyTorch/CUDA raytracer.

The reference (leonlang/simple_raytracer) has no config system: every knob is a
hardcoded constant or a comment-toggled code block (see SURVEY.md §5).  This
module exposes each of those constants as a field, citing where the value lives
in the reference (`simple_raytracer.cpp` / `Object.cpp`).  The reference-facing
dataclasses carry the same fields and defaults as the JAX package's
(simple_raytracer_tpu/config.py), so one set of values configures both.

:class:`KernelConfig` holds what the hand-written CUDA kernels read and the
switches that choose the tiled frame's branch; the JAX package's
environment-variable switches of the same meaning are its fields here.  The
port reads no environment variable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera at the view-space origin.

    Reference: primary ray dir = (i, j, focal) for i in [-W/2, W/2),
    j in [-H/2, H/2); directions NOT normalized (simple_raytracer.cpp:505-525).
    """

    width: int = 600            # simple_raytracer.cpp:773
    height: int = 400           # simple_raytracer.cpp:773
    focal: float = 400.0        # simple_raytracer.cpp:506
    normalize_dirs: bool = False  # reference never normalizes primary dirs


@dataclasses.dataclass(frozen=True)
class LightConfig:
    """Point light + soft-shadow sampling parameters."""

    position: Tuple[float, float, float] = (500.0, -300.0, -200.0)  # :776
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)             # :433
    # Number of jittered light samples; reference main() uses 1 (:445) but the
    # code comments call out "36 Shadows are a good value" (:444).
    num_samples: int = 1
    # Cumulative per-sample jitter: +3.0 added to x, y, z in rotation (:372-382).
    jitter_step: float = 3.0
    # Shadowed samples are dimmed by /5, NOT zeroed (:369).
    shadow_dim: float = 5.0
    # Reference shadow rays have no max-t: occluders BEYOND the light still
    # cast shadow (simple_raytracer.cpp:321-342).  True reproduces that quirk.
    shadow_no_max_t: bool = True
    enable_shadows: bool = True   # :385-386 comment toggle


@dataclasses.dataclass(frozen=True)
class ShadingConfig:
    """Phong illumination + tone-mapping parameters (simple_raytracer.cpp:144-200,
    :389-398)."""

    # Diffuse uses abs(n.l): double-sided shading (:174-178).
    double_sided_diffuse: bool = True
    # The reference multiplies the specular term by an extra max(n.l, 0) factor
    # (after the abs fold) (:196).
    specular_nl_factor: bool = True
    # Flat geometric normals are the active path; smooth vertex-normal
    # interpolation exists but is commented out (:162-164).
    smooth_normals: bool = False
    # Reinhard variant: c / (c + reinhard_offset); 0.5 active, 0.1/1.0/4.0
    # commented (:390-393).
    reinhard_offset: float = 0.5
    gamma: float = 1.1            # :396-398 (2.2 commented out)
    tonemap_enabled: bool = True
    # The reference quantizes shaded color with int(c*255) (truncation) (:447-449).
    quantize_truncate: bool = True


@dataclasses.dataclass(frozen=True)
class BVHConfig:
    """BVH build parameters (Object.cpp:225-284)."""

    leaf_size: int = 8            # triangleSizeStop, Object.cpp:261
    # 'median' reproduces the reference's sort-by-pointOne median split
    # (Object.cpp:240-255).  'sah' is the surface-area-heuristic improvement.
    split: str = "median"
    # Cull granularity: leaf triangles are reordered contiguously and grouped
    # into fixed-size blocks with AABBs (kernels/plan.py).
    block_size: int = 32
    # Each object's triangle range is padded to a multiple of page_tris, so
    # every aligned window of up to page_tris // block_size blocks holds one
    # object (the any-hit kernel's per-block self-object skip relies on it).
    page_tris: int = 128


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """What the CUDA kernels read, and which branch of the tiled frame runs
    (kernels/tiled.py::frame_branch).

    A window is ``window_blocks`` consecutive cull blocks: the unit of the
    plan, of the kernels' shared-memory staging and of the front-to-back
    break.  The widths are the JAX package's (WINDOW_BLOCKS 2 for the
    nearest walk, whose break rewards short windows; 4 for the any-hit walk,
    which has no ordering gain), so the two packages walk the same plans.
    The JAX field ``threads`` has no counterpart: every walk runs as work
    items in CTAs of its own.  K1's walk runs CTAs of 256 threads x 2
    rays over 512-ray slices and its epilogue blocks of 256 threads; the
    any-hit walk (K2 from t; K2′, K5, K7 over explicit rays), the walks
    over explicit rays of the nearest pass (K1's rays mode, K4, K6) and K3
    run CTAs of 256 threads over slices of up to 512 rays (csrc/nearest.cu,
    csrc/anyhit.cu, csrc/prepass.cu).

    The branch switches carry the JAX ``KernelConfig`` fields and
    environment switches of the same meaning:

    * ``attr_fetch`` (JAX ``attr_fetch``): K1 fetches the winner's
      attributes; False sends every frame to the gather branch, which
      shades from records gathered by triangle id;
    * ``fused_phong`` (JAX ``fused_phong``): one-sample flat frames shade
      in K1; False takes the fetch + records path (textured or
      smooth-normal scenes: the gather branch);
    * ``fused_shadow`` (JAX ``fused_shadow``): the hard shadow rebuilds its
      rays from K1's t (K2); False takes the legacy explicit-ray shadow;
    * ``prepass`` (JAX ``SRT_TILED_PREPASS``): the nearest walk is the
      exact two-pass one, the bf16 classification walk K3 then K1 over the
      flagged windows only;
    * ``groups`` / ``groups_ah`` (JAX ``SRT_TILED_GROUPS`` /
      ``SRT_TILED_GROUPS_AH``): split each nearest / occlusion ray tile
      into that many sub-groups that skip the plan entries their own rays
      cannot reach (K4 / K5); clamped to 1..4, 1 is off.

    ``maxv_big`` (JAX ``maxv_big``) is the list-mode window cap of dense
    scenes, whose plans are 1,024 entries wide
    (kernels/plan.py::effective_cull_maxv).
    """

    window_blocks: int = 2
    window_blocks_ah: int = 4
    attr_fetch: bool = True
    fused_phong: bool = True
    fused_shadow: bool = True
    prepass: bool = False
    groups: int = 1
    groups_ah: int = 1
    maxv_big: int = 1000

    @property
    def nearest_groups(self) -> int:
        """Sub-groups of a nearest tile (JAX tiled_t._groups_for)."""
        return max(1, min(4, int(self.groups)))

    @property
    def anyhit_groups(self) -> int:
        """Sub-groups of an occlusion tile (JAX tiled_t._groups_for_ah)."""
        return max(1, min(4, int(self.groups_ah)))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render configuration."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    light: LightConfig = dataclasses.field(default_factory=LightConfig)
    shading: ShadingConfig = dataclasses.field(default_factory=ShadingConfig)
    bvh: BVHConfig = dataclasses.field(default_factory=BVHConfig)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)

    # 'bruteforce' — all ray x triangle pairs in plain PyTorch (the exact
    #                oracle; render/renderer.py)
    # 'bvh'        — the stackless flattened-BVH walk in plain PyTorch,
    #                batched over rays (accel/traverse.py)
    # 'tiled'      — per-tile cull plans + the hand-written CUDA kernels
    #                (kernels/tiled.py)
    mode: str = "bruteforce"

    # Pixel tile edge for the tiled path (tile = tile_px * tile_px rays).
    # 0 = adaptive on scene density (kernels.plan.effective_tile_px): 64 for
    # scenes of <= 131072 triangles, 32 above.
    tile_px: int = 0

    # Nearest-pass ray-tile size; 0, or any value of at least the pixel
    # tile, = the full pixel tile (kernels/tiled.py::_hit_tile).  A sub-tile
    # (a divisor of the tile, a multiple of 128 rays) walks the explicit
    # primary rays in chunks of that many: a flat frame takes K1's fetch
    # mode over them (the "soft" branch), other scenes the gather or paged
    # branch; the shadow pass keeps its own tile (shadow_tile).
    hit_tile: int = 0

    # Shadow-pass ray-tile size; 0 = adaptive (kernels.plan.shadow_tile):
    # the full pixel tile for scenes of <= 131072 triangles, 256 rays above.
    shadow_tile: int = 0

    # Tiled-path kernel layout (kernels/tiled.py::frame_branch): None or
    # "sublane" walks windows of KernelConfig.window_blocks blocks with
    # K1/K2 (the fused, legacy and soft branches); "paged" walks pages of
    # BVHConfig.page_tris triangles with K6/K7 and shades through the
    # record gather (any scene kind).  Any other name raises ValueError.
    tiled_impl: str = None

    # Tiled-path cull-list capacity: tiles with <= cull_maxv visible windows
    # get an exact front-to-back list; heavier tiles walk the covering
    # contiguous window range (no early break).  <= 0: every plan is
    # range-only (kernels/plan.py::cull_ranges) and the frame gathers.
    cull_maxv: int = 248

    # Rays per chunk of the bvh and bruteforce modes (bounds the per-ray
    # scratch of the leaf-window gathers and the ray x triangle passes).
    # 0 = a single chunk.
    ray_chunk: int = 131072

    # Background for pixels with no hit OR hits shading to exactly (0,0,0):
    # light blue 173,216,230 (simple_raytracer.cpp:476-487).
    background: Tuple[int, int, int] = (173, 216, 230)

    # Möller–Trumbore determinant epsilon (simple_raytracer.cpp:57).
    mt_eps: float = 1e-12

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class AnimationConfig:
    """Turntable animation (simple_raytracer.cpp:530-551)."""

    start_deg: float = 0.0
    stop_deg: float = 360.0
    step_deg: float = 10.0         # 36 frames
    orbit_radius: float = 50.0     # :546
    camera_y: float = -50.0        # :551
    pitch_deg: float = 30.0        # :551
    yaw_offset_deg: float = 90.0   # :551 (angle + 90)


def default_config() -> RenderConfig:
    return RenderConfig()
