#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA raytracer on one NVIDIA GPU.

    python3 chip_smoke.py [--root ASSETS]

Drives the port's paths through ``render_radiance(mode="tiled")`` followed
by ``finalize_image``, on these frames (and, in phase 12, its training
through ``make_train_step``):

* **bench**: a mesh of bunny scale on a ground slab at 1920x1080, one hard
  shadow, flat Phong, a SAH BVH (the fused branch: K1 with fused Phong, K2
  from t).  The mesh is a displaced icosphere of 81,920 triangles
  (scene/procedural.py); with ``--root`` naming the reference's asset
  directory (the JAX CLI's ``--root``) it is the Stanford bunny of
  ``bench.py`` instead, from ASSETS/obj/stanford-bunny.obj on
  ASSETS/cube.obj;
* **shadow bench**: the bench's scene, light and camera at focal 1080, the
  reference's field of view (600x400 at focal 400,
  simple_raytracer.cpp:506) at 1080 rows, where the mesh's shadow on the
  ground is in view: the fused branch with K2 walking deep shadow plans;
* **soft**: ``bench.py::run_soft_shadow``'s frame: the same mesh and light
  at 600x400, focal 400, 16 light samples (K1 in its fetch mode, then K2′
  over the folded shadow rays);
* **dense**: ``procedural.dense_on_ground`` (163,852 triangles) at 600x400,
  focal 400, one hard shadow (32-pixel tiles; K1 with fused Phong, then the
  legacy hard shadow through K2′ in 256-ray tiles);
* **paged bench, paged textured, paged dense**: ``tiled_impl="paged"`` (K6
  over the primary rays' page plan, K7 over page plans of the shadow rays,
  then the record gather and the integrator): the bench frame; the
  textured, smooth-normal ``procedural.textured_on_ground(6)`` at 600x400,
  focal 400, 16 light samples; and the dense frame;
* **gather textured, gather grouped, prepass bench**: the sublane gather
  branch (the nearest walk of ``kernels/nearest.py::hits``, the shadow
  front end over windows, then the record gather and the integrator): the
  textured frame above on the default layout (K1's fetch mode, its
  attribute rows dropped, then K2′ over the fold); the same with
  ``KernelConfig(groups=4, groups_ah=4)`` (K4 in 1,024-ray groups, K5 in
  256-ray groups of the 1,024-ray fold); and the
  bench frame with ``KernelConfig(prepass=True)`` (K3, K1 over the refined
  plan's 64-triangle windows, K2′ for the hard shadow);
* **textured bench, smooth bench, complex**: one-sample frames of textured
  or smooth-normal scenes on the default layout (the fused frame with K1 in
  its textured or smooth mode): ``procedural.textured_on_ground(6)`` with
  flat shading (K1's textured mode, the texel finish, K2) and
  ``procedural.smooth_on_ground(6)`` with smooth normals (K1's smooth mode,
  K2), both at the bench camera; and the complex scene of
  ``bench.py::run_complex`` at 600x400, focal 400, one hard shadow (K1's
  textured mode at 32-pixel tiles, the texel finish, then the legacy hard
  shadow through K2′ in 256-ray tiles).  Its stand-in is
  ``procedural.dense_textured_on_ground`` (the dense frame's spheres and
  ground, the ground and the second sphere textured); with ``--root`` it is
  ``scene/catalog.py::complex_scene`` on the 36 turntable views of
  ``bench.py::run_complex``;
* **bruteforce, bruteforce soft textured, BVH, turntable**: the modes in
  plain PyTorch (``mode="bruteforce"``, ``"bvh"``) and the command line
  that selects them: ``catalog.six_spheres`` on stand-in assets written to
  a temporary directory (sphere.obj ``procedural.icosphere(3)`` at radius
  2.5, cube.obj ``procedural.box()``) at the CLI's defaults, 600x400, focal
  400, one hard shadow, the reference's frame; ``procedural
  .textured_on_ground(3)`` at 600x400, focal 400, 4 light samples; the
  bench's scene, pose and light in BVH mode at ``__graft_entry__.py``'s
  256x192 (focal ``procedural.bench_focal(192)``); the turntable of
  ``python -m simple_raytracer_tpu_torch animate``;
* **sub-tile, normalized, range-only, paged range-only**: the tiled
  configurations whose rays K1 cannot rebuild from the pixels or whose
  plans hold no lists: the shadow bench with ``hit_tile=1024`` and with
  ``normalize_dirs`` (the soft branch: K1's fetch mode over the explicit
  rays, then K2′), with ``cull_maxv=0`` (the gather branch over range-only
  plans: K1's rays walk, K2′), and the bench's scene at 600x400, focal
  400, paged with ``cull_maxv=0`` (K6 and K7 over page ranges).

Phases, each of which must pass:

1. device and toolchain: the card's name and power limit, torch, CUDA, nvcc;
2. build the kernels from simple_raytracer_tpu_torch/csrc/, one nvcc per
   source, all at once;
3. bench, then shadow bench: hold K1 and K2 against their plain PyTorch
   versions on the arguments the frame gives them on the card, at the
   frame's shapes (K2's found equal on every lane; on the shadow bench
   more than 1,000 shadowed hit lanes and a tile with a non-empty shadow
   plan), and on a small scene whose shadow falls in view;
4. bench, shadow bench: render through the public entry points, with the
   kernels' launch counters reset just before: coverage in (0.05, 0.99),
   K1 launched once, in its flat mode, K2 once, no other kernel, and the
   image within 1 of the plain versions' image on >= 99.9% of pixels;
5. bench, shadow bench: time 20 view-varied frames (as bench.py does), each
   kernel alone, and each stage of the frame alone;
6. soft and dense, each: the frame's K1 and K2′ against their plain
   versions on the frame's arguments (K2′ found equal on every lane, >
   1,000 shadowed hit lanes); the frame through the public entry
   points with the counters reset just before (the kernels of its branch
   launched, no other); the image within 1 of the plain versions' image on
   >= 99.9% of pixels; 32 view-varied frames timed (bench.py:174-183), each
   kernel and its plain version, and each stage;
7. the three paged frames, each: K6 and K7 against their plain versions on
   the frame's arguments (t and idx bit for bit, found equal on every lane,
   > 1,000 shadowed hit lanes in the textured and dense frames), the plans'
   windows per tile;
   the frame through the public entry points with the counters reset just
   before (K6 and K7 launched, no sublane kernel); the image within 1 of
   the plain versions' image on >= 99.9% of pixels; 20 (bench) or 32
   view-varied frames timed, each kernel and its plain version, and each
   stage;
8. the three gather frames, each: its kernels against their plain versions
   on the frame's arguments (as in 7; K3's flags equal on every plan
   position to its plain model of the work items; the prepass frame's (t,
   idx) equal to its unrefined walk's, with the windows per tile before and
   after the refine; a ``K3 schedule`` line and K3's span sweep, below);
   the frame through
   the public entry points with the counters reset just before (the
   branch's kernels launched, no other); the image within 1 of the plain
   versions' image on >= 99.9% of pixels; 32 (textured) or 20 (bench)
   view-varied frames timed, each kernel and its plain version, and each
   stage;
9. the textured bench, smooth bench and complex frames, each: K1 in its
   mode against its plain version on the frame's arguments (t, idx and the
   bounds rows as in 3; obj and tex id equal, dw, sw, texu, texv or rgb
   within 1e-4 on the rays whose idx agrees), its shadow kernel against its
   plain version (as in 3 or 6; > 1,000 shadowed hit lanes and > 10,000
   textured hit rays in the complex frame); the frame through the public
   entry points with the counters reset just before (K1 launched once, in
   its mode, its shadow kernel, no other); the image within 1 of the plain
   versions' image on >= 99.9% of pixels; 20 (bench), 32 (stand-in) or 36
   (turntable) frames timed, each kernel and its plain version, and each
   stage (the texel finish alone where there is one);
10. the probes (simple_raytracer_tpu_torch/probes/, the counterparts of
   the TPU probes under scripts/), through their entry points with every
   count reset just before and read just after: ``probes.fixed.run`` times
   each fixed-cost variant of ``fixed_probe_kernel`` on the bench frame's
   510 tiles of 4,096 lanes, then K1 on the bench plan, on the plan cut to
   one entry per tile and on the plan cut to none; ``probes.attr.run``
   times ``attr_gather_kernel`` (8,100 tiles of 256 rays) and
   ``attr_window_kernel`` (510 tiles x 10 windows x 4,096 rays, NB =
   2,172), 8 frames each after one warm-up.  Every variant and both fetch
   kernels then equal their plain versions exactly on the same inputs (t
   and rows equal, idx equal on every lane), K1's points pass phase 3's
   check; the plain versions and, where one PyTorch call computes the same
   function (io: ``o[..., 0] + 1``; attr_gather: ``F.embedding`` over the
   table with a zero row for misses), that call are timed.  The probes and
   their library calls are timed on the device, queued behind a spin while
   the host queues them (``probes.device_ms``), since each takes less
   device time than its call takes on the host, and each call cold: a 128
   MB write before it, outside its timed interval, evicts the L2 (K1's
   points are timed back to back).  A probe's
   bound is its bytes (the inputs it reads and its outputs, once each; the
   fetch kernels' table rows that some ray needs) over 3.35 TB/s, or its
   few f32 operations over 67 TFLOP/s where larger;
11. the plain PyTorch modes and the command line, each frame through the
   public entry points with every count reset just before and read just
   after (no kernel of ``csrc/`` launched; coverage in (0.05, 0.99), finite
   radiance of the frame's shape), 3 frames timed (host clock ending in a
   synchronize), the card's peak allocated memory: the bruteforce
   reference frame, also rendered by ``python -m simple_raytracer_tpu_torch
   render --mode bruteforce`` in a subprocess (its BMP equal to the
   in-process image), held to the tiled and the BVH frame of the same scene
   (within 1 on >= 99.9% of pixels, equal on >= 98%: the JAX package's
   bars); the bruteforce soft textured frame held to the tiled gather frame
   at those bars (the pixels that differ counted); the BVH flagship frame
   held to the tiled frame at those bars, with the walk's lockstep steps and
   the BVH's nodes; ``animate --step-deg 120 --fmt bmp`` writing three
   frames, then, run again, none (resume); ``render --mode tiled --profile
   DIR`` writing a Chrome trace with kernels in it, and
   ``utils.metrics.profile_trace`` around 3 frames of the bench: the card's
   busy share of that traced window (the union of its kernels, copies and
   fills over the window);
12. training (``make_train_step``, ``diff/render.py``): the **train
   bench**, one SGD step of the bench's scene at 1920x1080, focal 1080 (the
   shadow bench's view, its shadow in view), tiled: the explicit rays'
   plan, K1's rays walk, the shadow plan, K2′, the recompute and shading,
   the backward (autograd), the update.  5 steps from obj_color x 0.7 at
   lr 1e-3 with the counts reset just before the first and read just after
   it (K1's rays walk once, K2′ once, no other kernel; losses finite and
   falling); K1's rays walk and K2′ against their plain versions on the
   step's arguments (t, idx and found bit for bit, > 1,000 shadowed hit
   lanes); the step's winners through ``nearest.hits`` on the CUDA walks
   and on the plain ones equal on every ray; the step on the plain walks
   (``table.plain()``): the loss within rtol 1e-6, each gradient within
   1e-4 of its field's largest magnitude (the backward's scatter-adds sum
   in any order); the ``remat`` step (the walks launched twice) with the
   same 5 losses; 10 steps timed (host clock ending in a synchronize), the
   step's parts timed alone (CUDA events) and the peak allocated memory;
   the tiled gradients against the bruteforce ones at 256x192 (rtol 2e-4,
   atol 1e-5, the JAX package's bars); ``python -m
   simple_raytracer_tpu_torch train`` on the stand-in six spheres, 5 steps
   with a checkpoint every 2, then 7 steps that resume at step 5; the
   texture fit (``examples/fit_texture.py``: 30 Adam steps at 48x36 that
   cut the loss by more than 5x);
13. the sub-tile, normalized, range-only and paged range-only frames, each:
   its nearest walk (K1's fetch mode over rays, K1's rays mode, K6) and its
   any-hit walk (K2′, K7) against their plain versions on the frame's
   arguments, bit for bit (t, idx, the fetched attribute rows; found on
   every lane; > 1,000 shadowed hit lanes on the shadow bench); the
   sub-tile frame's (t, idx) equal on every lane to the fetch mode over
   the same rays in whole tiles, the range-only frames' to the walk of the
   same rays over list plans; the frame through the public entry points
   with the counts reset just before (its branch's two kernels launched,
   no other); the image within 1 of the plain versions' image on >= 99.9%
   of pixels (the plain walks already run on the same arguments are
   reused); 20 (sub-tile, normalized) or 3 (range-only) view-varied frames
   timed, each kernel and its plain version.  K1's fused flat mode is held
   to its plain version, and to its list walk on every lane, over the
   range-only frame's primary plan, as a scene of more than 65,536
   windows plans it.  The range-only walks print their ``schedule`` lines
   without the span sweeps.
15. the native host code (simple_raytracer_tpu_torch/native/: the C++ OBJ
   scan and median BVH build), on the card's host: g++ builds the library
   (it must: a failed build fails the run), then the bench's meshes (the
   icosphere(6) and the ground box written with ``procedural.obj_text``, or
   with ``--root`` the bunny file itself and cube.obj) and the dense
   scene's (its two spheres and the box, 163,852 triangles) are loaded
   with ``load_obj`` natively and with ``SRT_NO_NATIVE=1``, and their BVHs
   built by ``build_bvh(split="median")`` natively and with
   ``use_native=False`` (the native scan and build must run on each file,
   not defer): every array of the ``MeshData`` and the ``FlatBVHHost``
   equal, each path's host seconds printed with the card's line and the
   host CPU's model; then each scene is loaded and prepared on the card
   with the default median split, natively and without; the natively
   prepared 1920x1080 bench frame's two kernels are held to their plain
   versions on the arguments it gives them (the bench's mesh: K1 and K2,
   the fused branch, as phase 3 holds them; the dense scene, over 131,072
   triangles: K1 and K2′, the legacy hard shadow, as phase 6 does); and
   the frame is rendered through ``render`` from both: equal on every
   pixel, those two kernels launched and no other.
16. the planner kernels (csrc/plan.cu, ``plan.cull``'s CUDA route): each
   plan of one bench frame, one shadow-bench frame, one soft frame and one
   dense soft frame (``procedural.dense_textured_on_ground``, 163,852
   triangles, the default median BVH, 600x400, focal 400, 16 light
   samples: the gather branch at 32-pixel tiles, its fold over 131,072
   triangles planned by the hourglass test) (the primary plan with the
   apex test, the hard-shadow plan with the light-apex test and ``excl``,
   the fold plan with ``excl``, the dense fold's by
   ``plan_hourglass_kernel``) is captured, built by the kernel and by the
   plain planner (``plan.cull_plain``): equal on every word, two plans a
   frame on the card (the dense soft frame's fold counted in
   ``plan.cull_cuda.hourglass_plans``) and none plain, and the frame equal
   on every pixel to the frame of the plain planner; then each plan timed
   alone (``queued_ms``: the card's time and the host's), in its call
   (CUDA events), and the plain planner's call, with its bound
   (``planner_bound``).  The launches it prints are
   ``plan.cull_cuda.launches``, counted at the launch.  The frame's
   bounds (the ``camera``, ``tile_bounds`` and ``shadow_bounds`` roles of
   kernels/table.py: csrc/plan.cu's ``camera_kernel``,
   ``tile_bounds_kernel``, ``shadow_bounds_kernel``) are captured too: on
   the card once each (the hard-shadow bounds in the fused frames only), a
   launch each, none plain, each equal to its plain twin to the bit, then
   timed as the plans are (``bounds vs plain`` lines, bound
   ``bounds_bound``); the plain reference frame takes the twins.
17. the shading kernel (csrc/shade.cu, ``integrator.shade``'s CUDA route)
   on one frame of each soft cell's scene (the gather textured frame's
   smooth, textured ``textured_on_ground(6)``, and phase 16's dense soft
   frame), both at 600x400, focal 400, 16 light samples: the frame with
   the counts reset just before (one ``integrator.shade_cuda`` call and
   launch, no ``shade_plain`` call); its uint8 image and radiance against
   the frame shaded by the plain integrator (the ``shade`` role of
   kernels/table.py overridden to ``shade_plain``); the kernel's arguments
   captured (``shade_launch``: the rays, t, ids, light samples and shadow
   flags), the kernel alone timed on the
   card (``queued_ms``) with its bound (``shade_bound``: bytes), and the
   plain integrator on the same hits and flags (its card and host ms), the
   two radiances equal to the bit.  The launches it prints are
   ``shade_cuda.launches`` over one ``render`` with the counts reset just
   before; the frame's radiance (``render_radiance``) equals the plain
   route's to the bit on every hit pixel.

Every frame through ``render_checked`` (phases 3-9 and 13) and phase 15's
frames print ``plans``: the plans the frame built on the card
(``plan.cull_cuda.plans``), the planner kernel's launches, and the plans
built in plain PyTorch (``plan.cull_plain.plans``: phase 13's range-only
frames), and of the card's plans those of the hourglass test
(``plan.cull_cuda.hourglass_plans``).  The counts are one snapshot of the
program's registry (utils/metrics.py, :func:`read_counts`): the calls
kernels/table.py made by role and the launches the wrappers report.  The
plain image each of those frames is held to renders with every role of
the table plain (``table.plain()``): no kernel of csrc/, the planner and
the shading included.

Every frame that runs K1 (phases 3, 6, 8, 9, 15, and 10's cut plans) holds
K1's t and idx to the plain walk in K1's slices bit for bit, and prints a
``K1 schedule`` line: the schedule's rows on the card against its plain
version (``nearest.work_rows``: the same (tile, span) rows, walk
lengths never growing), the items, slices per tile, spans of the longest
range row, the walk's CTAs per SM and registers, the windows each slice
needed, and K1's time split into schedule + key fill, walk and epilogue,
with K1's time at other range and list spans (``K1_RANGE_SPANS``,
``K1_LIST_SPANS``).

Every frame that runs a walk over explicit rays (K1's rays mode, K4, K6:
``nearest_rays``; K2′, K5, K7: ``anyhit_rays``; phases 6-9) holds the
nearest walk's t and idx to the plain walk in its slices and spans bit for
bit, and the any-hit walk's found on every lane, and prints a ``schedule``
line for it (``rays_schedule``): the card's schedule against
``nearest.work_rows``, items, slices per tile, the longest span, CTAs per
SM, registers and spills, the windows each slice needed, the walk's time
split into schedule, walk and (nearest) key decode, and its time at other
range and list spans (``RAYS_RANGE_SPANS``, ``RAYS_LIST_SPANS``).  Every
fused frame (bench, shadow bench, textured bench, smooth bench, and
phase 3's small scene) prints the same ``K2 schedule`` line for K2, the
same walk over the shadow rays it rebuilds from t.

The prepass frame prints a ``K3 schedule`` line (``k3_schedule``): K3's
schedule on the card against its plain version (``prepass.work_rows``:
no rows for range rows longer than the plan's entries), items, slices per
tile, the longest span, the walk's CTAs per SM and registers, schedule and
walk ms; and K3's span sweep: for each (range span, list span) of
``K3_RANGE_SPANS`` x ``K3_LIST_SPANS``, K3's ms, the refined plan's
windows (total and most a tile), the nearest walk's ms over it and the sum
of the two, the refined walk equal to the unrefined walk bit for bit at
every pair.

Each kernel's entry in the kernels line carries its bound: the larger of
its operations over the peak rate of their type and its bytes over 3.35
TB/s, both counted on the work the frame needs (K3: every ray of the tile
against every triangle of each window it walks).  The operations are f32,
at 67 TFLOP/s, except K3's bf16 products and their sums, which the tensor
cores could take at 989 TFLOP/s beside the f32 ones: the operations' time
is the larger of the two.  A nearest test over rays that share one origin
counts the origin terms once per triangle.  The ray-triangle tests are
those of the rays of pixels inside the image (for the shadow walks, of
their hit points) while each ray still needed them: until its best t lay
below the next entry's bound, or until it found an occluder, as the plain
walk records them.  The bytes are the plan, the triangle rows (and object ids)
of the windows the walk staged, the rays of the counted lanes in tiles
with a non-empty plan, the small tables, the attribute rows of the
distinct winning triangles (K1: tri_attr's 16 bytes, and the 48-byte map
row in its textured and smooth modes), each read once, and the outputs,
each written once.  An entry whose time beats its bound by more than 5%
(``SHARE_MAX``) fails the run: its bound would be wrong.

Prints one JSON line per phase result, then the kernels line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, with no result line, when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
FRAMES = 20
# the soft and dense frames (bench.py:138-189): 600x400, focal 400
OCC_WIDTH, OCC_HEIGHT, OCC_FOCAL = 600, 400, 400.0
OCC_FRAMES = 32
SOFT_SAMPLES = 16
SHADOWED_MIN = 1000
# the shadow bench: the bench's scene at the reference's field of view
# (600x400 at focal 400, simple_raytracer.cpp:506: the focal is the image
# height), scaled to 1080 rows as bench.py:317 scales its own; the mesh's
# shadow on the ground is in view
SHADOW_FOCAL = 1080.0
TEXTURED_MIN = 10000     # textured hit rays of the complex frame
# queued_ms's spin, in the card's cycles (~20 ms at 1.98 GHz)
SPIN_CYCLES = 40_000_000
# kernel vs plain version on the card (ISSUE tolerances: equal expressions,
# contraction off, so only the transcendental functions round apart)
T_RTOL, T_ATOL = 1e-5, 1e-6
RGB_ATOL = 1e-4
IDX_MIN = 0.9999
IMAGE_MIN = 0.999
# the bound of a kernel (NVIDIA H100 SXM data sheet: f32 outside the tensor
# cores, dense bf16 on the tensor cores, HBM3), and the f32 additions,
# subtractions, multiplications and
# divisions of one ray-triangle test: the full Möller–Trumbore with its
# division (pvec 9, det 5, tvec 3, u 5, qvec 9, v 5, t 5, 1/det 1, u v t 3,
# u + v 1), the same with the origin terms hoisted per triangle (K1: one
# origin), and the division-free occlusion predicate (the products by det
# in place of 1/det and u v t)
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
OPS_NEAREST = 46
OPS_NEAREST_ONE_ORIGIN = 29
OPS_OCCLUDES = 45
# K3's test of one ray-triangle pair: the four ten-term sums of bf16
# products (40 products, 36 additions: a tensor-core contraction), then in
# f32 the sign fold 4, the interval ends 8, the confident and maybe margins
# 3 + 3, t_hi's division 1 and the candidate's product 1
OPS_PREPASS_BF16 = 76
OPS_PREPASS_F32 = 20
GROUPS = 4
# K1's range and list spans timed beside the port's (nearest.K1_RANGE_SPAN,
# K1_LIST_SPAN; 1023 entries keep every list whole)
K1_RANGE_SPANS = (4, 8, 16, 32, 64)
K1_LIST_SPANS = (16, 32, 64, 128, 1023)
# phase 10: frames timed per probe (the scripts' --frames 8), and each
# fixed-cost variant's f32 operations per lane (the ray rebuild 6 products
# and 6 sums where all of d is needed, 2 + 2 for dx alone; o x d 6 + 3;
# the sums of its rows; the keep's 10 comparisons)
PROBE_FRAMES = 8
PROBE_F32_OPS = {"io": 1, "feat": 19, "feat3": 3, "acc": 19, "noin": 19,
                 "noout": 1, "none": 5, "none2": 5, "feat_i": 31,
                 "empty": 2, "write": 2, "grid1": 2, "grid1f": 31}
SRC = "simple_raytracer_tpu_torch/csrc/"
# K1's three launches (csrc/nearest.cu), timed as one; the walks over
# explicit rays: nearest (K1's rays mode, K4, K6) three launches, any-hit
# (K2′, K5, K7) two
K1_NAME = "schedule_kernel + k1_walk_kernel + k1_epilogue_kernel"
RAYS_NAME = "schedule_kernel + rays_walk_kernel + rays_decode_kernel"
ANYHIT_NAME = "anyhit_schedule_kernel + anyhit_items_kernel"
K2_NAME = ANYHIT_NAME + " (from t)"
K3_NAME = "prepass_schedule_kernel + prepass_items_kernel"
# K3's span sweep on the prepass bench: range spans (windows) x list spans
# (entries); 1023 keeps every row whole
K3_RANGE_SPANS = (4, 8, 16, 32, 1023)
K3_LIST_SPANS = (4, 8, 16, 32, 64, 1023)
# the walks over explicit rays timed at other range spans (windows) and list
# spans (entries) beside the port's (nearest.rays_spans, anyhit.rays_spans)
RAYS_RANGE_SPANS = (2, 4, 8, 16, 32)
RAYS_LIST_SPANS = (1, 2, 4, 8, 16, 32, 64)
# no kernel may beat its bound by more than the timing's noise
SHARE_MAX = 1.05
# phase 11: frames timed per plain-mode frame; the stand-in sphere.obj's
# radius (the six spheres stand 6 apart); the soft textured frame's light
# samples and mesh; __graft_entry__.py's BVH frame; the CLI's subprocesses'
# time limit (seconds)
MODE_FRAMES = 3
SPHERE_RADIUS = 2.5
TEX_SAMPLES = 4
TEX_SUBDIV = 3
FLAGSHIP_WIDTH, FLAGSHIP_HEIGHT = 256, 192
CLI_TIMEOUT = 240
# phase 12: the train bench's steps from obj_color x TRAIN_COLOR at lr
# TRAIN_LR, the steps timed; the kernel step's gradients against the plain
# step's, each field within GRAD_REL of its largest magnitude (the same
# winners, so only the order of the backward's scatter-adds differs); the
# tiled gradients against the bruteforce ones at the JAX package's bars
# (tests/test_grad.py); the texture fit's frame and steps
TRAIN_STEPS = 5
TRAIN_TIMED = 10
TRAIN_LR = 1e-3
TRAIN_COLOR = 0.7
GRAD_REL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
FIT_WIDTH, FIT_HEIGHT, FIT_STEPS = 48, 36, 30
# phase 13: the sub-tile frame's hit_tile (a quarter of the 4,096-ray
# tile), the range-only frames' timed frames (each walks every window of
# its covering range: most of a second at 1080p), and the reference walks'
# list capacity (RenderConfig.cull_maxv's default)
SUB_TILE = 1024
RANGE_FRAMES = 3
LIST_MAXV = 248
K1_FETCH_RAYS_NAME = "K1 fetch over rays: " + RAYS_NAME + "<kFetch>"
# phase 14: the ring's geometry shards on the one card (through the local
# schedule: NCCL takes one process per card), its ray tile and list
# capacity (dist/ring.py's defaults, JAX ring.py:132), the DP frames timed,
# the composed steps, and the ring frame's bars against the unsharded frame
# (JAX's own ring bar: equal on >= 99.5% of pixels)
RING_SHARDS = 4
RING_TILE, RING_MAXV = 256, 64
DIST_FRAMES = 3
COMPOSED_STEPS = 3
RING_EQUAL_MIN = 0.995
# the walks' roles of kernels/table.py: every kernel of a frame but the
# planner's and the shading's
WALKS = ("nearest_shaded", "nearest_attrs", "nearest_rays",
         "nearest_rays_attrs", "nearest_grouped", "prepass", "anyhit_from_t",
         "anyhit", "anyhit_grouped", "nearest_pages", "anyhit_pages")
# phase 15: the kernels each scene's bench frame launches, by branch
NATIVE_ROLES = {"fused": ("nearest_shaded", "anyhit_from_t"),
                "legacy": ("nearest_shaded", "anyhit")}
# phase 16: the planner's f32 operations per (tile, block) pair: the
# interval test's three axes (2 differences, 4 divisions, 3 minima and 3
# maxima, 4 comparisons, 1 clamp), the axes' 4 combines and the 3 final
# comparisons; 4 comparisons more with an apex test (the rect overlap), 1
# with excl; and per block, with an apex test, its 8 corners' 3 differences,
# 3 dot products (5 each), 2 divisions and 4 extrema, and the rect's
# widening (4 x 4); the calls timed
OPS_PLAN_PAIR = 58
OPS_PLAN_APEX = 4
OPS_PLAN_EXCL = 1
OPS_PLAN_BLOCK = 8 * (3 + 15 + 2 + 4) + 16
# the hourglass test instead of the interval test: its 2 branches x 3 axes
# x 2 lines (a difference, a division, the margin's |x|, add and multiply,
# the widened bound and a minimum or maximum: 7 each), the 2 branches'
# comparisons and the 3 of their combine (a minimum, a clamp, a finiteness
# test)
OPS_PLAN_HOURGLASS = 2 * 3 * 2 * 7 + 2 + 3
PLAN_REPS = 200
PLAN_NAME = "plan_blocks_kernel + plan_tiles_kernel"
PLAN_HOURGLASS_NAME = "plan_hourglass_kernel"
# phase 16: the planners' bounds (kernels/table.py's roles) and their
# kernels; their f32 operations: a block's 6 extrema for the camera row's
# shadow frame; a primary corner's direction (12), its row of the corner
# sum (3), its 3 projections (15), 2 divisions, its clamp and comparison
# and 10 extrema; a shadow tile's 6 differences, 6 selections and 4
# comparisons
BOUNDS_KERNELS = {"camera": "camera_kernel",
                  "tile_bounds": "tile_bounds_kernel",
                  "shadow_bounds": "shadow_bounds_kernel"}
OPS_CAMERA_BLOCK = 6
OPS_BOUNDS_CORNER = 12 + 3 + 15 + 2 + 2 + 10
OPS_SHADOW_TILE = 6 + 6 + 4
# phase 17: the shading kernel's calls timed, and its compulsory bytes: a
# ray's o, d, t, id and radiance; a hit triangle's vertices, normals (vertex
# or flat), texel coordinates, object and texture ids; a texel
SHADE_REPS = 50
SHADE_NAME = "shade_kernel"
SHADE_RAY_BYTES = 12 + 12 + 4 + 4 + 12
SHADE_TEXEL_BYTES = 12


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_scene(sr, root):
    """The bench's scene (bench.py:299-313) from the asset directory
    ``root``, or, without one, its procedural stand-in."""
    from simple_raytracer_tpu_torch.scene import procedural as P
    from simple_raytracer_tpu_torch.scene import transforms as T
    if root is None:
        return (P.sphere_on_ground(sr.SceneManager(), 6).build(),
                "procedural icosphere(6) + box ground")
    bunny = os.path.join(root, "obj", "stanford-bunny.obj")
    require(os.path.isfile(bunny), f"no {bunny}")
    sm = sr.SceneManager(root=root)
    sm.load_obj_file(bunny, key="bunny")
    sm.set_color("bunny", (0.8, 0.7, 0.6))
    sm.transform_triangles("bunny", T.translate((0.0, -5.5, 60.0))
                           @ T.rotate_y(3.14159265)
                           @ T.scale(50.0, 50.0, 50.0))
    sm.load_obj_file(os.path.join(root, "cube.obj"), key="ground")
    sm.set_color("ground", (0.0, 1.0, 0.0))
    sm.transform_triangles("ground", P.GROUND_POSE)
    return sm.build(), f"reference OBJ {bunny}"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def queued_ms(fn, reps: int) -> tuple:
    """(device ms, host ms) of one run of ``fn``, the mean over ``reps``
    runs queued behind a spin of the card (``torch.cuda._sleep``, ~20 ms):
    the host queues every run before the card reaches the first, so the
    events time the card's work alone, the gaps between launches included,
    and the host's clock times the calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host


def plan_stats(plan) -> dict:
    """Windows each tile walks at most (its list or its range); the tiles
    that walk a range (no early break), and those that walk nothing."""
    import torch
    cnt = torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1]).float()
    return {"windows_per_tile_mean": float(cnt.mean()),
            "windows_per_tile_max": int(cnt.max()),
            "list_mode_tiles": float((plan[:, 3] == 1).float().mean()),
            "range_mode_tiles": int(((plan[:, 3] != 1) & (cnt > 0)).sum()),
            "empty_tiles": int((cnt == 0).sum()),
            "tiles": int(plan.shape[0])}


def nbytes(*xs) -> int:
    """Bytes of the tensors among ``xs`` (nested tuples included)."""
    import torch
    n = 0
    for x in xs:
        if isinstance(x, (tuple, list)):
            n += nbytes(*x)
        elif torch.is_tensor(x):
            n += x.numel() * x.element_size()
    return n


def frame_lanes(px0, py0, tile_px: int, width: int, height: int):
    """[n, tile_px**2] bool: the lanes of the tiles with pixel origins px0,
    py0 [n] (relative to the image centre) that lie inside the image."""
    import torch
    lane = torch.arange(tile_px * tile_px, device=px0.device)
    px = px0[:, None] + lane % tile_px + width // 2
    py = py0[:, None] + lane // tile_px + height // 2
    return (px < width) & (py < height)


def bound(walk, lanes, ops_per_pair: int, plan, window_bytes: int,
          lane_bytes: int, out, fixed=(), extra: int = 0,
          bf16_ops_per_pair: int = 0) -> dict:
    """The least time the card could take for a walk's work on the frame:
    the larger of its operations' time and its bytes over the memory rate.
    A test is ``ops_per_pair`` f32 operations and ``bf16_ops_per_pair`` bf16
    tensor-core ones; the two units run side by side, so the operations
    take the larger of the two times.  ``walk`` = (tests per lane [n, M],
    staged windows) from
    the plain walk (:func:`plain_walk`); counts the tests of the lanes
    ``lanes`` [n, M] and, as bytes, the plan, ``window_bytes`` for each
    staged window, ``lane_bytes`` for each counted lane of a tile with a
    non-empty plan, the tensors ``fixed`` and ``extra`` bytes read once,
    and the outputs ``out`` written once."""
    import torch
    lane_pairs, staged = walk
    pairs = int(lane_pairs[lanes].sum())
    cnt = torch.where(plan[:, 3] == 1, plan[:, 2], plan[:, 1])
    ray_lanes = int((lanes & (cnt > 0)[:, None]).sum())
    ops, bf16_ops = pairs * ops_per_pair, pairs * bf16_ops_per_pair
    moved = (nbytes(plan, out, *fixed) + extra + ray_lanes * lane_bytes
             + int(staged.sum()) * window_bytes)
    t_ops = max(ops / F32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": pairs, "f32_ops": ops, "bf16_ops": bf16_ops,
            "bytes": moved, "windows_staged": int(staged.sum())}


def nearest_ops(o) -> int:
    """Operations of one nearest test over the rays ``o`` [..., 3]: the
    origin terms are one per triangle when every ray shares the first ray's
    origin (primary rays), else one per test."""
    flat = o.reshape(-1, 3)
    return (OPS_NEAREST_ONE_ORIGIN if bool((flat == flat[0]).all())
            else OPS_NEAREST)


def window_bytes(tri, window_tris: int, block_size: int = 0) -> int:
    """Bytes of one window: its triangle rows, and with ``block_size`` its
    blocks' object ids."""
    return (window_tris * tri.shape[1] * tri.element_size()
            + (window_tris // block_size * 4 if block_size else 0))


def winner_bytes(idx, tri_attr) -> int:
    """Bytes of the attribute rows of the distinct winning triangles."""
    import torch
    return int(torch.unique(idx[idx >= 0]).numel()) * tri_attr.shape[1] \
        * tri_attr.element_size()


def entry(name: str, source: str, replaces: str, frame: str, launches: int,
          max_abs_err: float, ms: float, plain_ms: float, bnd: dict,
          library_ms=None, **extra) -> dict:
    """One kernel's record of the kernels line.  ``library_ms`` is the time
    of one PyTorch call that computes the same function, where there is
    one; none walks a cull plan, so it is null for K1-K7.  A share of the
    bound over SHARE_MAX fails: the bound would be wrong, not the kernel
    fast."""
    share = bnd["bound_ms"] / ms
    require(share <= SHARE_MAX, f"{name} ({frame}): {ms} ms is "
                                f"{share:.3f} of its bound {bnd['bound_ms']}")
    return {"name": name, "route": "cuda", "source": SRC + source,
            "replaces": replaces, **extra, "frame": frame,
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
            "bound_by": bnd["bound_by"], "share": share,
            "library_ms": library_ms}


def plain_walk(plain, args):
    """Run the plain version ``plain`` on ``args``; returns (its result,
    its walk's record: the tests each lane needed [n, M], the windows
    staged)."""
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    nearest.walk_plain.lane_pairs = anyhit.walk_plain.lane_pairs = None
    out = plain(*args)
    w = (nearest.walk_plain if nearest.walk_plain.lane_pairs is not None
         else anyhit.walk_plain)
    return out, (w.lane_pairs, w.staged)


def frame_args(prep, cfg, light, cam_spec, rays=None) -> dict:
    """The arguments the frame gives each walk on its first call, by role
    (kernels/table.py)."""
    from simple_raytracer_tpu_torch.kernels import table
    from simple_raytracer_tpu_torch.kernels.tiled import render_flat_tiled
    stores = {role: [] for role in WALKS}
    with table.using({role: table.spy(role, stores[role]) for role in WALKS}):
        render_flat_tiled(prep, cfg, light, cam_spec, rays=rays)
    return {role: st[0] for role, st in stores.items() if st}


def check_k1_shaded(k1, label: str, size, plain=None,
                    sweep: bool = True) -> dict:
    """K1 (a fused mode: flat, textured or smooth) vs its plain version
    (``plain``, default ``tiled_nearest_shaded_plain``) on the arguments
    ``k1``, in an image of ``size`` = (width, height): t, idx, obj, the
    shading rows (rgb, or dw, sw, texu, texv, obj, tex id) within RGB_ATOL
    on the rays whose idx agrees, obj and tex id equal there, and the
    bounds rows; then its ``K1 schedule`` line (``sweep``: with the span
    sweeps)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest
    mode, amap = k1[10], k1[11]
    out = nearest.tiled_nearest_shaded(*k1)
    kt, ki, ko, ks, kb = out
    (pt, pi, po, ps, pb), walk = plain_walk(
        plain or nearest.tiled_nearest_shaded_plain, k1)
    torch.cuda.synchronize()
    hk, hp = torch.isfinite(kt), torch.isfinite(pt)
    both = hk & hp
    t_err = (kt[both] - pt[both]).abs()
    t_ok = bool((t_err <= T_ATOL + T_RTOL * pt[both].abs()).all())
    same = ki == pi
    idx_frac = float(same.float().mean())
    sf = same.reshape(-1)
    shade_err = float((ks[sf] - ps[sf]).abs().max()) if bool(sf.any()) \
        else 0.0
    obj_ok = bool((ko[same] == po[same]).all())
    if mode == nearest.TEXTURED:         # obj and tex id columns
        obj_ok = obj_ok and bool(torch.equal(ks[sf, 4:], ps[sf, 4:]))
    fin = torch.isfinite(pb) & torch.isfinite(kb)
    b_ok = bool((torch.isfinite(pb) == torch.isfinite(kb)).all()
                and torch.allclose(kb[fin], pb[fin], rtol=1e-5, atol=1e-4))
    # each input read once: the winners' tri_attr rows and, in the textured
    # and smooth modes, their 48-byte map rows
    winners = winner_bytes(ki, k1[2]) + (0 if amap is None
                                         else winner_bytes(ki, amap))
    exact = bool(torch.equal(kt, pt) and torch.equal(ki, pi))
    res = {"check": f"K1 vs plain ({label})", "mode": mode,
           "slices": nearest.k1_slices(kt.shape[1]),
           "tiles": int(kt.shape[0]), "hit_rays": int(hk.sum()),
           "hit_mask_equal": float((hk == hp).float().mean()),
           "t_max_abs_err": float(t_err.max()) if t_err.numel() else 0.0,
           "t_within_tol": t_ok, "t_idx_equal": exact, "idx_equal": idx_frac,
           "shade_max_abs_err": shade_err, "obj_equal": obj_ok,
           "bounds_allclose": b_ok, "plan": plan_stats(k1[0]),
           **bound(walk, frame_lanes(k1[0][:, 4], k1[0][:, 5], k1[5], *size),
                   OPS_NEAREST_ONE_ORIGIN, k1[0], window_bytes(k1[1], k1[6]),
                   0, out, (k1[3], k1[4]), winners)}
    if mode == nearest.TEXTURED:
        res["textured_hit_rays"] = int((hk.reshape(-1) & (ks[:, 5] >= 0))
                                       .sum())
    emit(**res)
    require(t_ok and bool((hk == hp).all()), f"K1 t differs ({label})")
    require(idx_frac >= IDX_MIN, f"K1 idx equal on {idx_frac} ({label})")
    require(exact, f"K1 t, idx not bit for bit the plain walk's ({label})")
    require(shade_err <= RGB_ATOL and obj_ok, f"K1 shading differs ({label})")
    require(b_ok, f"K1 bounds rows differ ({label})")
    k1_schedule(k1, label, walk, sweep=sweep)
    return res


def schedule_stats(plan, sched, n_windows: int, range_span: int,
                   list_span: int, need) -> dict:
    """A walk's schedule ``sched`` on the card against its plain version
    (``nearest.work_rows`` at these spans: the same (tile, span) rows, walk
    lengths never growing), the plan's rows, and ``need`` [slices], the
    windows each slice needed."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest
    rows, length = nearest.work_rows(plan, n_windows, range_span, list_span)
    n_rows = int(sched[1])
    got = sched[2:2 + 2 * n_rows].reshape(-1, 2).long()
    key = (got[:, 0] << 20) + got[:, 1]
    same = n_rows == rows.shape[0] and torch.equal(
        key.sort().values, ((rows[:, 0].long() << 20) + rows[:, 1]).sort()
        .values)
    glen = nearest.row_lengths(plan, got, n_windows, range_span, list_span)
    rng_cnt = torch.minimum(plan[:, 1], (n_windows - plan[:, 0]).clamp_min(0))
    lst_cnt = torch.where(plan[:, 3] == 1, plan[:, 2], 0)
    is_rng = (plan[:, 3] != 1) & (rng_cnt > 0)
    need = need[need > 0].float()
    return {"rows_equal_plain": same,
            "longest_first": bool((glen[1:] <= glen[:-1]).all()),
            "rows": n_rows, "range_span": range_span, "list_span": list_span,
            "list_rows": int((lst_cnt > 0).sum()),
            "longest_list": int(lst_cnt.max()) if lst_cnt.numel() else 0,
            "range_rows": int(is_rng.sum()),
            "longest_range_row_spans": int(
                (-(-rng_cnt[is_rng] // range_span)).max())
            if bool(is_rng.any()) else 0,
            "longest_item_windows": int(length[0]) if rows.shape[0] else 0,
            "slice_windows_needed": {
                "slices": int(need.numel()),
                "p50": float(need.quantile(0.5)) if need.numel() else 0.0,
                "p90": float(need.quantile(0.9)) if need.numel() else 0.0,
                "max": int(need.max()) if need.numel() else 0,
                "sum": int(need.sum())}}


def k1_schedule(k1, label: str, walk, fetch: bool = False,
                sweep: bool = True) -> dict:
    """K1's work items on the arguments ``k1`` (its fused modes', or with
    ``fetch`` the fetch mode's): the schedule on the card against its
    plain version (the same (tile, span) rows, walk lengths never growing),
    the walk's shape on this card (CTAs per SM, registers), the windows
    each slice needed (from the plain walk's record ``walk``), and K1's
    time split by launch (CUDA events around repeated launches: the
    schedule + key fill alone, the walk as schedule + walk less the
    schedule alone, the epilogue alone on the last keys), and with
    ``sweep`` K1 at other range and list spans (without, each launch is
    timed over 2 runs: a range-only plan's walk takes most of a second)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest
    if fetch:
        plan, tri, tri_attr, cam, tpx, wt, eps = k1[:7]
        extra = {}
    else:
        plan, tri, tri_attr, mat, cam, tpx, wt, eps, ds, snl = k1[:10]
        extra = dict(mode=k1[10], mat=mat, attr_map=k1[11], double_sided=ds,
                     specular_nl=snl)

    def call(**spans):
        return nearest.k1_call(plan, tri, tri_attr, cam, tpx, wt, eps,
                               **spans, **extra)
    launch, _outs, sched = call()
    launch()
    torch.cuda.synchronize()
    slices = nearest.k1_slices(tpx * tpx)
    shape = nearest.k1_shape(wt)
    need = walk[0].reshape(plan.shape[0] * slices, -1).amax(dim=1) // wt
    stats = schedule_stats(plan, sched, tri.shape[0] // wt,
                           nearest.K1_RANGE_SPAN, nearest.K1_LIST_SPAN, need)
    reps = 20 if sweep else 2
    fill = cuda_ms(lambda: launch(1), reps)
    fill_walk = cuda_ms(lambda: launch(3), reps)
    epilogue = cuda_ms(lambda: launch(4), reps)
    whole = cuda_ms(lambda: launch(), reps)
    by_range = {str(sp): cuda_ms(call(range_span=sp)[0], 10)
                for sp in (K1_RANGE_SPANS if sweep else ())}
    by_list = {str(sp): cuda_ms(call(list_span=sp)[0], 10)
               for sp in (K1_LIST_SPANS if sweep else ())}
    res = {"check": f"K1 schedule ({label})",
           "items": stats["rows"] * slices, "slices_per_tile": slices,
           "slice_rays": shape["slice_rays"], **stats,
           "ctas_per_sm": shape["ctas_per_sm"], "sms": shape["sms"],
           "walk_threads": shape["threads"],
           "registers": shape["registers"], "fill_ms": fill,
           "walk_ms": fill_walk - fill, "epilogue_ms": epilogue,
           "k1_ms": whole, "k1_ms_by_range_span": by_range,
           "k1_ms_by_list_span": by_list}
    emit(**res)
    require(stats["rows_equal_plain"] and stats["longest_first"],
            f"K1 schedule differs from its plain version ({label})")
    require(shape["slice_rays"] == nearest.K1_SLICE,
            f"K1 slices of {shape['slice_rays']} rays, the port's "
            f"{nearest.K1_SLICE}")
    return res


def spill_lines(*keys) -> list:
    """The ``-Xptxas -v`` lines on the spills of each compiled kernel whose
    entry name holds every one of ``keys``, from the build's log."""
    from simple_raytracer_tpu_torch.kernels import build
    out, inside = [], False
    for ln in build.build()["log"].splitlines():
        if "Compiling entry function" in ln:
            inside = all(k in ln for k in keys)
        elif inside and "spill" in ln:
            out.append(ln.strip())
    return out


def rays_schedule(args, label: str, walk, what: str, groups: int = 1,
                  occlusion: bool = False, from_t: bool = False,
                  sweep: bool = True) -> dict:
    """The work items of a walk over explicit rays on its wrapper's
    arguments ``args`` (the nearest walk's, or with ``occlusion`` the
    any-hit walk's; with ``from_t`` K2's, the any-hit walk over rays
    rebuilt from t): the schedule on the card against its plain version
    (``nearest.work_rows``), items, slices, the longest span, the walk's
    CTAs per SM, registers and spills, the windows each slice needed (from
    the plain walk's record ``walk``), and the walk's time split by launch
    (the schedule alone, the walk as schedule + walk less the schedule,
    and the nearest walk's key decode alone), and with ``sweep`` at other
    range and list spans (without, each launch is timed over 2 runs); for
    K2 also its wrapper's call, and the card's and the host's time of it
    and of each launch apart (``queued_ms``)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    if from_t:
        plan, tri, bobj, t, obj, cam, tpx, wt, bs, eps, nmt = args[:11]

        def call(**spans):
            return anyhit.anyhit_from_t_call(plan, tri, bobj, t, obj, cam,
                                             tpx, wt, bs, eps, nmt, **spans)
        n, m = t.shape
        shape = anyhit.rays_shape(wt, bs, m, from_t=True)
        rs, ls = anyhit.rays_spans(wt)
        spills = spill_lines("anyhit_items_kernel", "RaysFromT")
    elif occlusion:
        plan, tri, bobj, o, d, so, wt, bs, eps, nmt = args[:10]

        def call(**spans):
            return anyhit.anyhit_rays_call(plan, tri, bobj, o, d, so, wt, bs,
                                           eps, nmt, groups, **spans)
        n, m = o.shape[:2]
        shape = anyhit.rays_shape(wt, bs, m, groups)
        rs, ls = anyhit.rays_spans(wt)
        spills = spill_lines("anyhit_items_kernel", "RaysIn")
    else:
        plan, tri, o, d, wt, eps = args[:6]

        def call(**spans):
            return nearest.rays_call(plan, tri, o, d, wt, eps, groups,
                                     **spans)
        n, m = o.shape[:2]
        shape = nearest.rays_shape(wt, m, groups)
        rs, ls = nearest.rays_spans(wt)
        spills = spill_lines("rays_walk_kernel")
    launch, _out, sched = call()
    launch()
    torch.cuda.synchronize()
    slices, sr = nearest.rays_slices(m, groups), nearest.slice_rays(m, groups)
    # each lane's slice: slices of sr lanes inside each sub-group
    glanes = m // groups
    lane = torch.arange(m, device=plan.device)
    sl = lane // glanes * (slices // groups) + lane % glanes // sr
    need = torch.zeros((n, slices), dtype=torch.int64, device=plan.device)
    need.scatter_reduce_(1, sl.expand(n, m), walk[0] // wt, "amax")
    stats = schedule_stats(plan, sched, tri.shape[0] // wt, rs, ls, need)
    reps = 20 if sweep else 2
    fill = cuda_ms(lambda: launch(1), reps)
    fill_walk = cuda_ms(lambda: launch(3), reps)
    whole = cuda_ms(launch, reps)
    res = {"check": f"{what} schedule ({label})",
           "items": stats["rows"] * slices, "rays_per_tile": m,
           "groups": groups, "slices_per_tile": slices,
           "slice_rays": shape["slice_rays"], "window_tris": wt, **stats,
           "ctas_per_sm": shape["ctas_per_sm"], "sms": shape["sms"],
           "walk_threads": shape["threads"],
           "registers": shape["registers"], "spills": spills,
           "schedule_ms": fill, "walk_ms": fill_walk - fill, "ms": whole,
           "ms_by_range_span": {str(sp): cuda_ms(call(range_span=sp)[0], 10)
                                for sp in (RAYS_RANGE_SPANS if sweep
                                           else ())},
           "ms_by_list_span": {str(sp): cuda_ms(call(list_span=sp)[0], 10)
                               for sp in (RAYS_LIST_SPANS if sweep else ())}}
    if not (occlusion or from_t):
        res["decode_ms"] = cuda_ms(lambda: launch(4), reps)
    if from_t:
        # the wrapper's call as the kernels line times it, then the card's
        # time and the host's apart: which of them K2's two launches cost
        def k2_call():
            return anyhit.tiled_anyhit_from_t(*args)
        fill_dev = queued_ms(lambda: launch(1), 20)[0]
        res.update(call_ms=cuda_ms(k2_call, 20),
                   **dict(zip(("call_device_ms", "call_host_ms"),
                              queued_ms(k2_call, 20))),
                   schedule_device_ms=fill_dev,
                   walk_device_ms=queued_ms(lambda: launch(3), 20)[0]
                   - fill_dev)
    emit(**res)
    require(stats["rows_equal_plain"] and stats["longest_first"],
            f"{what} schedule differs from its plain version ({label})")
    require(shape["slice_rays"] == sr,
            f"{what} slices of {shape['slice_rays']} rays, the port's {sr}")
    return res


def check_k2(k2, label: str, size) -> dict:
    """K2 (any-hit from t) vs its plain version on the arguments ``k2``:
    found equal on every lane (an OR is exact in any order of the work
    items), reported on the lanes of hits inside the image; then its
    ``K2 schedule`` line."""
    import torch
    from simple_raytracer_tpu_torch.kernels import anyhit
    kf = anyhit.tiled_anyhit_from_t(*k2)
    pf, walk = plain_walk(anyhit.tiled_anyhit_from_t_plain, k2)
    torch.cuda.synchronize()
    hit = torch.isfinite(k2[3])
    lanes = hit & frame_lanes(k2[0][:, 4], k2[0][:, 5], k2[6], *size)
    f_frac = float((kf[lanes] == pf[lanes]).float().mean()) \
        if bool(lanes.any()) else 1.0
    res = {"check": f"K2 vs plain ({label})", "hit_rays": int(hit.sum()),
           "shadowed_rays": int((kf & hit).sum()),
           "shadowed_hit_lanes": int((kf & lanes).sum()),
           "found_equal": f_frac, "found_differ": int((kf != pf).sum()),
           "found_equal_every_lane": bool(torch.equal(kf, pf)),
           "found_max_abs_err": float((kf.int() - pf.int()).abs().max()),
           "miss_lanes_found": bool(kf[~hit].all()),
           "plan": plan_stats(k2[0]),
           **bound(walk, lanes, OPS_OCCLUDES, k2[0],
                   window_bytes(k2[1], k2[7], k2[8]), 8, kf, (k2[5],))}
    emit(**res)
    require(res["found_equal_every_lane"] and res["miss_lanes_found"],
            f"K2 found differs from the plain walk's ({label})")
    rays_schedule(k2, label, walk, "K2", from_t=True)
    return res


def compare_kernels(prep, cfg, light, cam_spec, label: str, time_it: bool):
    """K1 and K2 vs their plain versions on the card, on the arguments the
    fused frame gives them."""
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    args = frame_args(prep, cfg, light, cam_spec)
    k1, k2 = args["nearest_shaded"], args["anyhit_from_t"]
    size = cam_spec[2:4]
    k1_res = check_k1_shaded(k1, label, size)
    k2_res = check_k2(k2, label, size)
    times = {}
    if time_it:
        times = {"k1_ms": cuda_ms(lambda: nearest.tiled_nearest_shaded(*k1),
                                  20),
                 "k1_plain_ms": cuda_ms(
                     lambda: nearest.tiled_nearest_shaded_plain(*k1), 2),
                 "k2_ms": cuda_ms(lambda: anyhit.tiled_anyhit_from_t(*k2),
                                  20),
                 "k2_plain_ms": cuda_ms(
                     lambda: anyhit.tiled_anyhit_from_t_plain(*k2), 2)}
        emit(check=f"kernel times ({label})", **times)
    return k1_res, k2_res, times


def reset_counts() -> None:
    """Zero the program's counters (utils/metrics.py's registry)."""
    from simple_raytracer_tpu_torch.utils import metrics
    metrics.reset_counts()


def read_counts() -> dict:
    """One snapshot of the registry since :func:`reset_counts`, read as:
    ``launches``, the walks' launches by role, as their CUDA wrappers count
    them (kernels/table.py);
    ``k1_modes``, K1's calls by attribute mode; ``plans``, the plans built
    by csrc/plan.cu, those of them by its hourglass kernel, its launches,
    and the plans built in plain PyTorch; ``shading``, csrc/shade.cu's
    calls and launches and the plain integrator's calls."""
    from simple_raytracer_tpu_torch.kernels import nearest, table
    from simple_raytracer_tpu_torch.utils import metrics
    now = metrics.counts()
    cuda, plain = table.calls(), table.calls(twin=True)
    launched = table.launches()
    mode = "nearest.tiled_nearest_shaded.mode_launches."
    return {"launches": {r: launched[r] for r in WALKS},
            "k1_modes": {m: now.get(f"{mode}{m}", 0) for m in nearest.MODES},
            "plans": {"card": cuda["plan"],
                      "hourglass": now.get("plan.cull_cuda.hourglass_plans",
                                           0),
                      "launches": launched["plan"],
                      "plain": plain["plan"]},
            "shading": {"cuda": cuda["shade"],
                        "launches": launched["shade"],
                        "plain": plain["shade"]}}


# the shading's counts a frame by branch: the gather and paged frames shade
# by winner id on the card, the soft frame its fetched records in plain
# PyTorch, the fused and legacy frames inside K1
SHADING_BY_BRANCH = {"gather": {"cuda": 1, "launches": 1, "plain": 0},
                     "paged": {"cuda": 1, "launches": 1, "plain": 0},
                     "soft": {"cuda": 0, "launches": 0, "plain": 1},
                     "fused": {"cuda": 0, "launches": 0, "plain": 0},
                     "legacy": {"cuda": 0, "launches": 0, "plain": 0}}


def image_vs_plain(sr, prep, cfg, light, img, label: str,
                   view=None, plains=None) -> dict:
    """The frame (seen through ``view``, a view matrix or None) with every
    role of kernels/table.py plain (``table.plain()``: no kernel of csrc/,
    planner and shading included; ``plains`` by role in place of some
    twins), on the card, against ``img`` (within 1 on >= IMAGE_MIN of
    pixels)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import plan as pl, table
    from simple_raytracer_tpu_torch.kernels.tiled import (render_flat_tiled,
                                                          wants_rays)
    from simple_raytracer_tpu_torch.ops.camera import (primary_rays_tiled,
                                                       untile_image)
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    cam = cfg.camera
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    rays = None
    if wants_rays(prep, cfg, tpx * tpx):
        o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx,
                                        cam.focal, cam.normalize_dirs,
                                        view_matrix=view, device=prep.device)
        rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    with table.using({**table.plain(), **(plains or {})}):
        prad, phit = render_flat_tiled(
            prep, cfg, light, (view, cam.focal, cam.width, cam.height, tpx),
            rays=rays)
    tx, ty = -(-cam.width // tpx), -(-cam.height // tpx)
    pimg = finalize_image(
        untile_image(prad, cam.width, cam.height, tpx, tx, ty),
        untile_image(phit, cam.width, cam.height, tpx, tx, ty), cfg)
    diff = (img.int() - pimg.int()).abs().amax(dim=-1)
    within1 = float((diff <= 1).float().mean())
    require(within1 >= IMAGE_MIN, f"image vs plain ({label}): {within1} "
                                  f"within 1")
    return {"image_within_1_of_plain": within1,
            "image_equal_to_plain": float((diff == 0).float().mean())}


def render_checked(sr, prep, cfg, light, label: str, roles,
                   view=None, plains=None) -> dict:
    """The frame (seen through ``view``) through the public entry points,
    with the counters reset just before and read just after: every walk of
    ``roles`` launched and no other; coverage in
    (0.05, 0.99), the frame's shape and finite radiance; the image within 1
    of the plain versions' image (``plains``: see :func:`image_vs_plain`).
    Emits and returns the ``render`` line, with K1's launches by attribute
    mode."""
    import torch
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels.tiled import frame_branch
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    cam = cfg.camera
    reset_counts()
    rad, hit = sr.render_radiance(prep, cfg, light, view_matrix=view)
    img = finalize_image(rad, hit, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    launches, shading = counts["launches"], counts["shading"]
    require(all(launches[r] > 0 for r in roles)
            and all(n == 0 for r, n in launches.items() if r not in roles),
            f"{label} launched {launches}, not exactly {roles}")
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    branch = frame_branch(prep, cfg, tpx * tpx)
    require(shading == SHADING_BY_BRANCH[branch],
            f"{label}: the {branch} frame shaded {shading}, not "
            f"{SHADING_BY_BRANCH[branch]}")
    bg = (img == torch.tensor(cfg.background, dtype=torch.uint8,
                              device=prep.device)).all(dim=-1)
    coverage = float((~bg).float().mean())
    require(0.05 < coverage < 0.99, f"implausible coverage {coverage}")
    require(tuple(img.shape) == (cam.height, cam.width, 3)
            and bool(torch.isfinite(rad).all()), f"bad radiance ({label})")
    res = {"phase": f"render ({label})", "branch": branch,
           "coverage": coverage, **counts,
           **image_vs_plain(sr, prep, cfg, light, img, label, view, plains)}
    emit(**res)
    return res


def frames_ms(sr, prep, cfg, shots, label: str) -> float:
    """Host ms per frame over the frames of ``shots`` [(view matrix,
    light)], ending in a synchronize."""
    import torch
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    torch.cuda.synchronize()
    t0 = time.time()
    acc = torch.zeros((), dtype=torch.int64, device=prep.device)
    for V, light in shots:
        r, h = sr.render_radiance(prep, cfg, light, view_matrix=V)
        acc += finalize_image(r, h, cfg).to(torch.int64).sum()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / len(shots)
    require(int(acc) > 0, f"timed frames rendered nothing ({label})")
    return ms


def view_varied_ms(sr, prep, cfg, light, frames: int, label: str) -> float:
    """Host ms per frame over ``frames`` frames, the view moved 1e-5 and
    the light 1e-4 further each frame (bench.py:353-358, :174-183)."""
    import torch
    eye = torch.eye(4, dtype=torch.float32, device=prep.device)
    shots = []
    for i in range(frames):
        V = eye.clone()
        V[0, 3] += i * 1e-5
        shots.append((V, light + i * 1e-4))
    return frames_ms(sr, prep, cfg, shots, label)


def fused_frame(sr, prep, cfg, light, label: str, gpu: str,
                frames: int) -> tuple:
    """A flat one-sample frame of the fused branch (K1 in mode 0, K2 from
    t; phases 3-5): K1 and K2 against their plain versions on the frame's
    arguments, with their ``K1 schedule`` and ``K2 schedule`` lines; the
    frame through the public entry points with the counts reset just
    before (K1 once, in mode 0, K2 once, no other) and its image against
    the plain versions'; ``frames`` view-varied frames timed, each kernel
    and its plain version, and each stage alone.  Returns (the
    kernels-line entries, K2's check line)."""
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels.tiled import frame_branch
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    cam = cfg.camera
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    require(frame_branch(prep, cfg, tpx * tpx) == "fused"
            and nearest.attr_mode(prep, cfg) == nearest.FLAT,
            f"{label} does not take the fused branch in K1's flat mode")
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    k1_res, k2_res, times = compare_kernels(prep, cfg, light, cam_spec,
                                            label, time_it=True)
    render = render_checked(sr, prep, cfg, light, label,
                            ("nearest_shaded", "anyhit_from_t"))
    launches = render["launches"]
    require(launches["nearest_shaded"] == 1
            and launches["anyhit_from_t"] == 1
            and render["k1_modes"] == {m: int(m == nearest.FLAT)
                                       for m in nearest.MODES},
            f"{label}: launches {launches}, K1 by mode {render['k1_modes']}")
    ms_frame = view_varied_ms(sr, prep, cfg, light, frames, label)
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    fcam = pl.camera(prep, cam_spec, light)
    t, _i, obj, _rgb, bounds = nearest.hits_shaded(prep, cfg, light,
                                                   cam_spec, maxv, cam=fcam)
    stages = {
        "plan_and_k1_ms": cuda_ms(lambda: nearest.hits_shaded(
            prep, cfg, light, cam_spec, maxv), 10),
        "shadow_plan_and_k2_ms": cuda_ms(lambda: anyhit.anyhit_from_t(
            prep, cfg, t, obj, bounds, fcam, cam_spec, maxv), 10),
        "frame_ms": cuda_ms(lambda: finalize_image(
            *sr.render_radiance(prep, cfg, light), cfg), 10)}
    emit(phase=f"timing ({label})", width=cam.width, height=cam.height,
         focal=cam.focal, frames=frames, ms_per_frame=ms_frame,
         rays_per_s=cam.width * cam.height * 1e3 / ms_frame, gpu=gpu,
         **times, **stages)
    return [
        entry(K1_NAME, "nearest.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:855", label,
              launches["nearest_shaded"], k1_res["t_max_abs_err"],
              times["k1_ms"], times["k1_plain_ms"], k1_res),
        entry(K2_NAME, "anyhit.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:1374", label,
              launches["anyhit_from_t"], k2_res["found_max_abs_err"],
              times["k2_ms"], times["k2_plain_ms"], k2_res,
              via="tiled_anyhit_from_t (tiled_t.py:1878)")], k2_res


def check_found(kernel, plain, args, pts, S: int, what: str, label: str,
                shadowed_min=None) -> dict:
    """An any-hit walk over explicit rays (K2′, K5 or K7) against its plain
    version on ``args``: found equal on every lane, bit for bit (an OR is
    exact in any order of the work items); reported on the lanes whose
    point is a hit of the primary pass inside the image (``pts``, in the
    primary rays' order); the shadow tiles hold ts points x S samples,
    sample-major, in that order.  With ``shadowed_min``, more than that
    many hit lanes must be shadowed.  Returns (its check line, the plain
    walk's record)."""
    import torch
    kf = kernel(*args)
    pf, walk = plain_walk(plain, args)
    torch.cuda.synchronize()
    n2, m = kf.shape
    hit = pts.reshape(-1)
    ts = m // S
    hit = torch.cat([hit, hit.new_zeros(n2 * ts - hit.shape[0])])
    lanes = hit.reshape(n2, 1, ts).expand(n2, S, ts).reshape(n2, m)
    f_frac = float((kf[lanes] == pf[lanes]).float().mean())
    shadowed = int((kf & lanes).sum())
    res = {"check": f"{what} vs plain ({label})", "tiles": n2,
           "rays_per_tile": m, "hit_lanes": int(lanes.sum()),
           "shadowed_hit_lanes": shadowed, "found_equal": f_frac,
           "found_differ": int((kf[lanes] != pf[lanes]).sum()),
           "found_equal_every_lane": bool(torch.equal(kf, pf)),
           "found_max_abs_err": float((kf[lanes].int() - pf[lanes].int())
                                      .abs().max()),
           "plan": plan_stats(args[0]),
           **bound(walk, lanes, OPS_OCCLUDES, args[0],
                   window_bytes(args[1], args[6], args[7]), 28, kf)}
    emit(**res)
    require(res["found_equal_every_lane"],
            f"{what} found differs from the plain walk's ({label})")
    if shadowed_min is not None:
        require(shadowed > shadowed_min,
                f"{what} shadowed {shadowed} ({label})")
    return res, walk


def check_nearest(kernel, plain, args, inside, what: str, label: str,
                  ops: int, win_bytes: int, lane_bytes: int, fixed=(),
                  winners=None, exact: bool = False):
    """A nearest walk whose results begin with (t, idx) (K1's fetch and
    rays modes, K4, K6) against its plain version on ``args``; counts the
    lanes ``inside``, and with ``winners`` (the attribute table) the rows
    of the winning triangles; with ``exact``, t and idx must equal the
    plain version's bit for bit.  Returns (its check line, t, idx, the
    plain walk's record)."""
    import torch
    kout = kernel(*args)
    pout, walk = plain_walk(plain, args)
    kt, ki, pt, pi = kout[0], kout[1], pout[0], pout[1]
    torch.cuda.synchronize()
    hk, hp = torch.isfinite(kt), torch.isfinite(pt)
    both = hk & hp
    t_err = (kt[both] - pt[both]).abs()
    t_ok = bool((t_err <= T_ATOL + T_RTOL * pt[both].abs()).all())
    idx_frac = float((ki == pi).float().mean())
    plan = args[0]
    res = {"check": f"{what} vs plain ({label})", "tiles": int(kt.shape[0]),
           "rays_per_tile": int(kt.shape[1]), "hit_rays": int(hk.sum()),
           "hit_mask_equal": float((hk == hp).float().mean()),
           "t_max_abs_err": float(t_err.max()) if t_err.numel() else 0.0,
           "t_within_tol": t_ok,
           "t_idx_equal": bool(torch.equal(kt, pt) and torch.equal(ki, pi)),
           "idx_equal": idx_frac,
           "idx_differ": int((ki != pi).sum()), "plan": plan_stats(plan),
           **bound(walk, inside, ops, plan, win_bytes, lane_bytes, kout,
                   fixed, 0 if winners is None
                   else winner_bytes(ki, winners))}
    emit(**res)
    require(t_ok and bool((hk == hp).all()), f"{what} t differs ({label})")
    require(idx_frac >= IDX_MIN, f"{what} idx equal on {idx_frac} ({label})")
    require(res["t_idx_equal"] or not exact,
            f"{what} t, idx not bit for bit the plain walk's ({label})")
    return res, kt, ki, walk


def occlusion_frame(sr, prep, cfg, light, label: str, gpu: str) -> dict:
    """The soft or dense frame: its K1 and K2′ against their plain versions,
    the frame through the public entry points with the counts read around
    it, the plain image, and the times.  Returns the kernels-line entries."""
    import torch
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels import tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    dev = prep.device
    cam = cfg.camera
    S = cfg.light.num_samples
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    tile = tpx * tpx
    branch = tiled.frame_branch(prep, cfg, tile)
    k1_role = "nearest_attrs" if branch == "soft" else "nearest_shaded"
    require(branch == ("soft" if S > 1 else "legacy"),
            f"{label} takes the {branch} branch")
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx, cam.focal,
                                    device=dev)
    rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    args = frame_args(prep, cfg, light, cam_spec, rays)
    k1, k2r = args[k1_role], args["anyhit"]

    # K1 vs plain
    size = (cam.width, cam.height)
    inside = frame_lanes(k1[0][:, 4], k1[0][:, 5], tpx, *size)
    if k1_role == "nearest_shaded":
        k1_res = check_k1_shaded(k1, label, size)
        kt = nearest.tiled_nearest_shaded(*k1)[0]
        k1_err = k1_res["t_max_abs_err"]
        k1_bound = k1_res
    else:
        kt, ki, ka = nearest.tiled_nearest_attrs(*k1)
        (pt, pi, pa), walk = plain_walk(nearest.tiled_nearest_attrs_plain,
                                        k1)
        k1_bound = bound(walk, inside, OPS_NEAREST_ONE_ORIGIN, k1[0],
                         window_bytes(k1[1], k1[5]), 0, (kt, ki, ka),
                         (k1[3],), winner_bytes(ki, k1[2]))
        torch.cuda.synchronize()
        hk, hp = torch.isfinite(kt), torch.isfinite(pt)
        both = hk & hp
        t_err = (kt[both] - pt[both]).abs()
        t_ok = bool((t_err <= T_ATOL + T_RTOL * pt[both].abs()).all())
        same = (ki == pi).reshape(-1)
        idx_frac = float(same.float().mean())
        n_err = float((ka[same, :3] - pa[same, :3]).abs().max())
        obj_ok = bool((ka[same, 3] == pa[same, 3]).all())
        k1_err = float(t_err.max()) if t_err.numel() else 0.0
        exact = bool(torch.equal(kt, pt) and torch.equal(ki, pi))
        emit(check=f"K1 fetch mode vs plain ({label})",
             slices=nearest.k1_slices(kt.shape[1]),
             tiles=int(kt.shape[0]), hit_rays=int(hk.sum()),
             hit_mask_equal=float((hk == hp).float().mean()),
             t_max_abs_err=k1_err, t_within_tol=t_ok, t_idx_equal=exact,
             idx_equal=idx_frac, normal_max_abs_err=n_err, obj_equal=obj_ok,
             plan=plan_stats(k1[0]), **k1_bound)
        require(t_ok and bool((hk == hp).all()), f"K1 t differs ({label})")
        require(idx_frac >= IDX_MIN, f"K1 idx equal on {idx_frac} ({label})")
        require(exact, f"K1 t, idx not bit for bit the plain walk's "
                       f"({label})")
        require(n_err <= 1e-6 and obj_ok, f"K1 attrs differ ({label})")
        k1_schedule(k1, label, walk, fetch=True)

    # K2′ vs plain, on the lanes whose point is a hit
    k2_res, k2_walk = check_found(anyhit.tiled_anyhit,
                                  anyhit.tiled_anyhit_plain, k2r,
                                  torch.isfinite(kt) & inside, S, "K2'",
                                  label, SHADOWED_MIN)
    rays_schedule(k2r, label, k2_walk, "K2'", occlusion=True)
    k2_err = k2_res["found_max_abs_err"]

    launches = render_checked(sr, prep, cfg, light, label,
                              (k1_role, "anyhit"))["launches"]
    ms_frame = view_varied_ms(sr, prep, cfg, light, OCC_FRAMES, label)

    # each kernel and its plain version, and each stage alone
    k1_fn = getattr(nearest, "tiled_" + k1_role)
    k1_plain = getattr(nearest, "tiled_" + k1_role + "_plain")
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    stage1 = (nearest.hits_attrs if branch == "soft" else
              lambda *a: nearest.hits_shaded(a[0], a[1], light, *a[2:]))
    o2, d2, self2 = k2r[3], k2r[4], k2r[5]
    m = o2.shape[1]
    excl = tiled._pure_excl(self2)
    times = {
        "k1_ms": cuda_ms(lambda: k1_fn(*k1), 20),
        "k1_plain_ms": cuda_ms(lambda: k1_plain(*k1), 2),
        "k2r_ms": cuda_ms(lambda: anyhit.tiled_anyhit(*k2r), 20),
        "k2r_plain_ms": cuda_ms(lambda: anyhit.tiled_anyhit_plain(*k2r), 2),
        "plan_and_k1_ms": cuda_ms(lambda: stage1(prep, cfg, cam_spec, maxv),
                                  10),
        "shadow_plan_ms": cuda_ms(lambda: pl.cull_occl(
            prep, o2.reshape(-1, 3), d2.reshape(-1, 3), m, maxv,
            cfg.kernel.window_blocks_ah, excl, apex_rev=S == 1), 10),
        "frame_ms": cuda_ms(lambda: finalize_image(
            *sr.render_radiance(prep, cfg, light), cfg), 10)}
    emit(phase=f"timing ({label})", width=cam.width, height=cam.height,
         samples=S, frames=OCC_FRAMES, ms_per_frame=ms_frame,
         rays_per_s=cam.width * cam.height * 1e3 / ms_frame, gpu=gpu,
         **times)
    k1_entry = entry(
        K1_NAME + (" (fetch mode)" if branch == "soft" else ""),
        "nearest.cu",
        "simple_raytracer_tpu/kernels/tiled_t.py:855", label,
        launches[k1_role], k1_err, times["k1_ms"], times["k1_plain_ms"],
        k1_bound)
    k2_entry = entry(
        ANYHIT_NAME, "anyhit.cu",
        "simple_raytracer_tpu/kernels/tiled_t.py:1374", label,
        launches["anyhit"], k2_err, times["k2r_ms"], times["k2r_plain_ms"],
        k2_res, via="tiled_anyhit_t (tiled_t.py:1815)")
    return [k1_entry, k2_entry]


def paged_frame(sr, prep, cfg, light, label: str, gpu: str, frames: int,
                shadowed_min=None) -> list:
    """A frame of the paged branch: K6 and K7 against their plain versions
    on the frame's arguments, the frame through the public entry points
    with the counts read around it, the plain image, and the times.
    Returns the kernels-line entries."""
    import torch
    from simple_raytracer_tpu_torch.kernels import paged
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels import tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    from simple_raytracer_tpu_torch.render import integrator
    dev = prep.device
    cam = cfg.camera
    S = cfg.light.num_samples
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    tile = tpx * tpx
    branch = tiled.frame_branch(prep, cfg, tile)
    require(branch == "paged", f"{label} takes the {branch} branch")
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx, cam.focal,
                                    device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    args = frame_args(prep, cfg, light, cam_spec, (o, d))
    k6, k7 = args["nearest_pages"], args["anyhit_pages"]

    # K6 vs plain
    inside = frame_lanes(*pl.tile_origins(k6[0].shape[0],
                                          -(-cam.width // tpx), tpx,
                                          cam.width, cam.height, dev),
                         tpx, cam.width, cam.height)
    k6_res, kt, ki, k6_walk = check_nearest(
        paged.tiled_nearest, paged.tiled_nearest_plain, k6, inside, "K6",
        label, nearest_ops(k6[2]), window_bytes(k6[1], k6[4]), 24,
        exact=True)
    rays_schedule(k6, label, k6_walk, "K6")

    # K7 vs plain, on the lanes whose point is a hit
    k7_res, k7_walk = check_found(paged.tiled_anyhit,
                                  paged.tiled_anyhit_plain, k7,
                                  torch.isfinite(kt) & inside, S, "K7",
                                  label, shadowed_min)
    rays_schedule(k7, label, k7_walk, "K7", occlusion=True)

    launches = render_checked(sr, prep, cfg, light, label,
                              ("nearest_pages", "anyhit_pages"))["launches"]
    ms_frame = view_varied_ms(sr, prep, cfg, light, frames, label)

    # each kernel and its plain version, and each stage alone
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    t, idx = kt.reshape(-1), ki.reshape(-1)
    m = k7[3].shape[1]
    excl = tiled._pure_excl(k7[5])
    times = {
        "k6_ms": cuda_ms(lambda: paged.tiled_nearest(*k6), 20),
        "k6_plain_ms": cuda_ms(lambda: paged.tiled_nearest_plain(*k6), 2),
        "k7_ms": cuda_ms(lambda: paged.tiled_anyhit(*k7), 20),
        "k7_plain_ms": cuda_ms(lambda: paged.tiled_anyhit_plain(*k7), 2),
        "plan_ms": cuda_ms(lambda: paged.cull(prep, cfg, o, d, tile, maxv,
                                              apex=True), 10),
        "plan_and_k6_ms": cuda_ms(lambda: paged.hits(
            prep, cfg, o, d, tile, maxv, apex=True), 10),
        "shadow_plan_ms": cuda_ms(lambda: paged.cull_occl(
            prep, cfg, k7[3].reshape(-1, 3), k7[4].reshape(-1, 3), m, maxv,
            excl, apex_rev=S == 1), 10),
        "gather_and_shade_ms": cuda_ms(lambda: integrator.shade(
            prep.scene, cfg, o, d, t, idx, light, None), 10),
        "frame_ms": cuda_ms(lambda: integrator.finalize_image(
            *sr.render_radiance(prep, cfg, light), cfg), 10)}
    emit(phase=f"timing ({label})", width=cam.width, height=cam.height,
         samples=S, frames=frames, ms_per_frame=ms_frame,
         rays_per_s=cam.width * cam.height * 1e3 / ms_frame, gpu=gpu,
         **times)
    return [
        entry(RAYS_NAME + " (pages)", "nearest.cu",
              "simple_raytracer_tpu/kernels/tiled.py:815", label,
              launches["nearest_pages"], k6_res["t_max_abs_err"],
              times["k6_ms"], times["k6_plain_ms"], k6_res,
              via="tiled_nearest (tiled.py:1047)"),
        entry(ANYHIT_NAME + " (page windows)", "anyhit.cu",
              "simple_raytracer_tpu/kernels/tiled.py:905", label,
              launches["anyhit_pages"], k7_res["found_max_abs_err"],
              times["k7_ms"], times["k7_plain_ms"], k7_res,
              via="tiled_anyhit (tiled.py:1090)")]


def check_prepass(k3, inside, label: str) -> tuple:
    """K3 against its plain version, the model of its work items, on the
    arguments ``k3``: flags equal on every plan position.  Returns (the
    check's record, the plain model's walk record)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import prepass
    kf = prepass.tiled_prepass(*k3)
    pf = prepass.tiled_prepass_plain(*k3)
    walk = (prepass.tiled_prepass_plain.lane_pairs,
            prepass.tiled_prepass_plain.staged)
    torch.cuda.synchronize()
    equal = float((kf == pf).float().mean())
    plan, gram, wt = k3[0], k3[1], k3[4]
    res = {"check": f"K3 vs plain ({label})", "tiles": int(kf.shape[0]),
           "positions": int(kf.numel()), "flags_equal": equal,
           "flags_differ": int((kf != pf).sum()),
           "flags_max_abs_err": float((kf.int() - pf.int()).abs().max()),
           "flagged": int(kf.sum()),
           "plan": plan_stats(plan),
           **bound(walk, inside, OPS_PREPASS_F32, plan,
                   wt * gram.shape[1] * gram.element_size(), 24, kf,
                   bf16_ops_per_pair=OPS_PREPASS_BF16)}
    emit(**res)
    require(equal == 1.0, f"K3 flags equal on {equal} ({label})")
    return res, walk


def k3_schedule(k3, kn, near_fn, unrefined, label: str, walk) -> dict:
    """K3's work items on its arguments ``k3``: the schedule on the card
    against its plain version (``prepass.work_rows``), items, slices, the
    longest span, the walk's CTAs per SM and registers, the windows each
    slice walked (from the plain model's record ``walk``), K3's time split
    into the schedule (with the flags' zeroing) and the walk; then the span
    sweep: K3 at each pair of K3_RANGE_SPANS x K3_LIST_SPANS, the plan
    refined by its flags, and the nearest walk ``near_fn`` over it (the
    rest of its arguments ``kn``), whose (t, idx) must equal ``unrefined``
    bit for bit at every pair."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest, prepass
    plan, gram, o, d, wt, eps = k3[:6]
    n, m = o.shape[:2]
    n_windows = gram.shape[0] // wt

    def call(**spans):
        return prepass.prepass_call(plan, gram, o, d, wt, eps, **spans)
    launch, _flags, sched = call()
    launch()
    torch.cuda.synchronize()
    slices, sr = nearest.rays_slices(m), nearest.slice_rays(m)
    shape = prepass.prepass_shape(wt, m)
    sl = torch.arange(m, device=plan.device) // sr
    need = torch.zeros((n, slices), dtype=torch.int64, device=plan.device)
    need.scatter_reduce_(1, sl.expand(n, m), walk[0] // wt, "amax")
    stats = schedule_stats(prepass.walked_plan(plan), sched, n_windows,
                           prepass.PREPASS_RANGE_SPAN,
                           prepass.PREPASS_LIST_SPAN, need)
    sched_ms = cuda_ms(lambda: launch(1), 20)
    whole = cuda_ms(launch, 20)
    sweep, exact = [], True
    for rs in K3_RANGE_SPANS:
        for ls in K3_LIST_SPANS:
            run, flags, _ = call(range_span=rs, list_span=ls)
            k3_ms = cuda_ms(run, 10)
            ref = prepass.refine_plan(plan, flags)
            t, idx = near_fn(ref, *kn[1:])
            same = bool(torch.equal(t, unrefined[0])
                        and torch.equal(idx, unrefined[1]))
            exact = exact and same
            walk_ms = cuda_ms(lambda: near_fn(ref, *kn[1:]), 10)
            cnt = torch.where(ref[:, 3] == 1, ref[:, 2], ref[:, 1])
            sweep.append({"range_span": rs, "list_span": ls, "k3_ms": k3_ms,
                          "refined_windows": int(cnt.sum()),
                          "refined_windows_max": int(cnt.max()),
                          "refined_walk_ms": walk_ms,
                          "sum_ms": k3_ms + walk_ms, "exact": same})
    best = min(sweep, key=lambda r: r["sum_ms"])
    res = {"check": f"K3 schedule ({label})",
           "items": stats["rows"] * slices, "rays_per_tile": m,
           "slices_per_tile": slices, "slice_rays": shape["slice_rays"],
           "window_tris": wt, **stats, "ctas_per_sm": shape["ctas_per_sm"],
           "sms": shape["sms"], "walk_threads": shape["threads"],
           "registers": shape["registers"], "schedule_ms": sched_ms,
           "walk_ms": whole - sched_ms, "ms": whole,
           "sweep_best": {k: best[k] for k in ("range_span", "list_span",
                                               "sum_ms")}}
    emit(**res)
    for row in sweep:
        emit(check=f"K3 span sweep ({label})", **row)
    require(stats["rows_equal_plain"] and stats["longest_first"],
            f"K3 schedule differs from its plain version ({label})")
    require(shape["slice_rays"] == sr,
            f"K3 slices of {shape['slice_rays']} rays, the port's {sr}")
    require(exact, f"a refined walk of the K3 span sweep differs ({label})")
    return res


def gather_frame(sr, prep, cfg, light, label: str, gpu: str, frames: int,
                 shadowed_min=None) -> list:
    """A frame of the sublane gather branch: its nearest walk (K1's fetch
    mode, K3 + K1 over the refined plan, or K4) and its occlusion walk (K2′
    or K5) against their plain versions on the frame's arguments, the frame
    through the public entry points with the counts read around it, the
    plain image, and the times.  Returns the kernels-line entries."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest, prepass
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels import table
    from simple_raytracer_tpu_torch.kernels import tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    dev = prep.device
    cam = cfg.camera
    kc = cfg.kernel
    S = cfg.light.num_samples
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    tile = tpx * tpx
    branch = tiled.frame_branch(prep, cfg, tile)
    require(branch == "gather", f"{label} takes the {branch} branch")
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx, cam.focal,
                                    device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    args = frame_args(prep, cfg, light, cam_spec, (o, d))
    if kc.prepass:
        near = ("nearest_rays", "K1 rays mode",
                RAYS_NAME + " (refined plan)",
                "simple_raytracer_tpu/kernels/tiled_t.py:855",
                "tiled_nearest_t over explicit rays (tiled_t.py:1616)")
    elif kc.nearest_groups > 1:
        near = ("nearest_grouped", "K4", RAYS_NAME + " (sub-groups)",
                "simple_raytracer_tpu/kernels/tiled_t.py:1145",
                "tiled_nearest_t, groups > 1 (tiled_t.py:1616)")
    else:
        near = ("nearest_attrs", "K1 fetch mode",
                K1_NAME + " (fetch mode)",
                "simple_raytracer_tpu/kernels/tiled_t.py:855",
                "tiled_nearest_t with cam (tiled_t.py:1616)")
    shadow = (("anyhit_grouped", "K5", ANYHIT_NAME + " (sub-groups)",
               "simple_raytracer_tpu/kernels/tiled_t.py:1509",
               "tiled_anyhit_t, groups > 1 (tiled_t.py:1815)")
              if kc.anyhit_groups > 1 else
              ("anyhit", "K2'", ANYHIT_NAME,
               "simple_raytracer_tpu/kernels/tiled_t.py:1374",
               "tiled_anyhit_t (tiled_t.py:1815)"))
    roles = (("prepass",) if kc.prepass else ()) + (near[0], shadow[0])
    kn, ks = args[near[0]], args[shadow[0]]
    near_fn, near_plain = table.roles()[near[0]][:2]
    sh_fn, sh_plain = table.roles()[shadow[0]][:2]
    inside = frame_lanes(*pl.tile_origins(kn[0].shape[0],
                                          -(-cam.width // tpx), tpx,
                                          cam.width, cam.height, dev),
                         tpx, cam.width, cam.height)
    entries, times = [], {}

    # K3 vs plain, and the refined walk against the unrefined one
    if kc.prepass:
        k3 = args["prepass"]
        k3_res, k3_walk = check_prepass(k3, inside, label)
        rt, ri = near_fn(*kn)
        ut, ui = near_fn(k3[0], *kn[1:])
        torch.cuda.synchronize()
        exact = bool(torch.equal(rt, ut) and torch.equal(ri, ui))
        emit(check=f"refined walk vs unrefined walk ({label})",
             t_idx_equal=exact, windows_before=plan_stats(k3[0]),
             windows_after=plan_stats(kn[0]))
        require(exact, f"the refined walk differs ({label})")
        k3_schedule(k3, kn, near_fn, (ut, ui), label, k3_walk)
        times["k3_ms"] = cuda_ms(lambda: prepass.tiled_prepass(*k3), 10)
        times["k3_plain_ms"] = cuda_ms(
            lambda: prepass.tiled_prepass_plain(*k3), 2)
        times["unrefined_ms"] = cuda_ms(lambda: near_fn(k3[0], *kn[1:]), 10)

    # the nearest walk vs plain: K1's fetch mode reads the camera constants
    # and the winners' attribute rows where the others read rays
    if near[0] == "nearest_attrs":
        near_res, kt, _ki, walk = check_nearest(
            near_fn, near_plain, kn, inside, near[1], label,
            OPS_NEAREST_ONE_ORIGIN, window_bytes(kn[1], kn[5]), 0, (kn[3],),
            kn[2], exact=True)
        k1_schedule(kn, label, walk, fetch=True)
    else:
        near_res, kt, _ki, near_walk = check_nearest(
            near_fn, near_plain, kn, inside, near[1], label,
            nearest_ops(kn[2]), window_bytes(kn[1], kn[4]), 24, exact=True)
        rays_schedule(kn, label, near_walk, near[1], kc.nearest_groups
                      if near[0] == "nearest_grouped" else 1)

    # the occlusion walk vs plain, on the lanes whose point is a hit
    sh_res, sh_walk = check_found(sh_fn, sh_plain, ks,
                                  torch.isfinite(kt) & inside, S, shadow[1],
                                  label, shadowed_min)
    rays_schedule(ks, label, sh_walk, shadow[1], kc.anyhit_groups,
                  occlusion=True)

    launches = render_checked(sr, prep, cfg, light, label, roles)["launches"]
    ms_frame = view_varied_ms(sr, prep, cfg, light, frames, label)

    # each kernel and its plain version, and each stage alone
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks, kc.window_blocks)
    times.update({
        "nearest_ms": cuda_ms(lambda: near_fn(*kn), 10),
        "nearest_plain_ms": cuda_ms(lambda: near_plain(*kn), 2),
        "shadow_ms": cuda_ms(lambda: sh_fn(*ks), 10),
        "shadow_plain_ms": cuda_ms(lambda: sh_plain(*ks), 2),
        "hits_ms": cuda_ms(lambda: nearest.hits(
            prep, cfg, o, d, tile, maxv, apex=True, cam_spec=cam_spec), 10),
        "frame_ms": cuda_ms(lambda: finalize_image(
            *sr.render_radiance(prep, cfg, light), cfg), 10)})
    emit(phase=f"timing ({label})", width=cam.width, height=cam.height,
         samples=S, frames=frames, ms_per_frame=ms_frame,
         rays_per_s=cam.width * cam.height * 1e3 / ms_frame, gpu=gpu,
         **times)
    if kc.prepass:
        entries.append(entry(
            K3_NAME, "prepass.cu",
            "simple_raytracer_tpu/kernels/tiled_t.py:1249", label,
            launches["prepass"], k3_res["flags_max_abs_err"],
            times["k3_ms"], times["k3_plain_ms"], k3_res,
            via="tiled_prepass_t (tiled_t.py:1741)"))
    return entries + [
        entry(near[2], "nearest.cu", near[3], label, launches[near[0]],
              near_res["t_max_abs_err"], times["nearest_ms"],
              times["nearest_plain_ms"], near_res, via=near[4]),
        entry(shadow[2], "anyhit.cu", shadow[3], label, launches[shadow[0]],
              sh_res["found_max_abs_err"], times["shadow_ms"],
              times["shadow_plain_ms"], sh_res, via=shadow[4])]


def mode_frame(sr, prep, cfg, light, label: str, gpu: str, frames: int,
               view=None, views=None, shadowed_min=None,
               textured_min=None) -> list:
    """A one-sample frame of a textured or smooth-normal scene (phase 9):
    K1 in its textured or smooth mode and the frame's shadow kernel (K2 on
    the fused branch, K2′ on the legacy one) against their plain versions
    on the frame's arguments; the frame through the public entry points
    with the counts read around it (K1 once, in that mode, its shadow
    kernel, no other); the plain image; and the times: ``frames``
    view-varied frames, or the frames seen through ``views``.  The checks
    and the stages see the scene through ``view``.  Returns the
    kernels-line entries."""
    import torch
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels import table
    from simple_raytracer_tpu_torch.kernels import tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    dev = prep.device
    cam = cfg.camera
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    branch = tiled.frame_branch(prep, cfg, tpx * tpx)
    mode = nearest.attr_mode(prep, cfg)
    require(branch in ("fused", "legacy") and mode != nearest.FLAT,
            f"{label} takes the {branch} branch in K1 mode {mode}")
    shadow = "anyhit_from_t" if branch == "fused" else "anyhit"
    cam_spec = (view, cam.focal, cam.width, cam.height, tpx)
    rays = None
    if branch == "legacy":
        o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx,
                                        cam.focal, view_matrix=view,
                                        device=dev)
        rays = (o.reshape(-1, 3), d.reshape(-1, 3))
    args = frame_args(prep, cfg, light, cam_spec, rays)
    k1, ks = args["nearest_shaded"], args[shadow]
    require(k1[10] == mode, f"{label}: K1 called in mode {k1[10]}")
    size = (cam.width, cam.height)

    # K1 in its mode vs plain, then the shadow kernel vs plain
    k1_res = check_k1_shaded(k1, label, size)
    if textured_min is not None:
        require(k1_res["textured_hit_rays"] > textured_min,
                f"{label}: {k1_res['textured_hit_rays']} textured hit rays")
    if branch == "fused":
        sh_res = check_k2(ks, label, size)
    else:
        kt = nearest.tiled_nearest_shaded(*k1)[0]
        inside = frame_lanes(k1[0][:, 4], k1[0][:, 5], tpx, *size)
        sh_res, sh_walk = check_found(
            anyhit.tiled_anyhit, anyhit.tiled_anyhit_plain, ks,
            torch.isfinite(kt) & inside, 1, "K2'", label, shadowed_min)
        rays_schedule(ks, label, sh_walk, "K2'", occlusion=True)

    render = render_checked(sr, prep, cfg, light, label, ("nearest_shaded",
                                                          shadow), view)
    launches = render["launches"]
    require(launches["nearest_shaded"] == 1 and launches[shadow] == 1
            and render["k1_modes"] == {m: int(m == mode)
                                       for m in nearest.MODES},
            f"{label}: K1 launches by mode {render['k1_modes']}")
    ms_frame = (frames_ms(sr, prep, cfg, [(V, light) for V in views], label)
                if views else
                view_varied_ms(sr, prep, cfg, light, frames, label))

    # each kernel and its plain version, and each stage alone
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    fcam = pl.camera(prep, cam_spec, light)
    t, _i, obj, shade, bounds = nearest.hits_shaded(prep, cfg, light,
                                                    cam_spec, maxv, cam=fcam)
    times = {
        "k1_ms": cuda_ms(lambda: nearest.tiled_nearest_shaded(*k1), 20),
        "k1_plain_ms": cuda_ms(
            lambda: nearest.tiled_nearest_shaded_plain(*k1), 2),
        "shadow_ms": cuda_ms(lambda: table.roles()[shadow].cuda(*ks), 20),
        "shadow_plain_ms": cuda_ms(lambda: table.roles()[shadow].plain(*ks),
                                   2),
        "plan_and_k1_ms": cuda_ms(lambda: nearest.hits_shaded(
            prep, cfg, light, cam_spec, maxv), 10),
        "frame_ms": cuda_ms(lambda: finalize_image(
            *sr.render_radiance(prep, cfg, light, view_matrix=view), cfg),
            10)}
    if mode == nearest.TEXTURED:
        times["texel_finish_ms"] = cuda_ms(lambda: tiled.texel_finish(
            prep.scene, cfg, obj, shade), 10)
    if branch == "fused":
        times["shadow_plan_and_k2_ms"] = cuda_ms(lambda: anyhit.anyhit_from_t(
            prep, cfg, t, obj, bounds, fcam, cam_spec, maxv), 10)
    else:
        o2, d2, m = ks[3], ks[4], ks[3].shape[1]
        excl = tiled._pure_excl(ks[5])
        times["shadow_plan_ms"] = cuda_ms(lambda: pl.cull_occl(
            prep, o2.reshape(-1, 3), d2.reshape(-1, 3), m, maxv,
            cfg.kernel.window_blocks_ah, excl, apex_rev=True), 10)
    emit(phase=f"timing ({label})", width=cam.width, height=cam.height,
         samples=1, frames=len(views) if views else frames,
         ms_per_frame=ms_frame,
         rays_per_s=cam.width * cam.height * 1e3 / ms_frame, gpu=gpu,
         **times)
    name = {nearest.TEXTURED: "textured", nearest.SMOOTH: "smooth"}[mode]
    sh_entry = ((K2_NAME, "tiled_anyhit_from_t (tiled_t.py:1878)")
                if branch == "fused" else
                (ANYHIT_NAME, "tiled_anyhit_t (tiled_t.py:1815)"))
    return [
        entry(f"{K1_NAME} ({name} mode)", "nearest.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:855", label,
              launches["nearest_shaded"],
              max(k1_res["t_max_abs_err"], k1_res["shade_max_abs_err"]),
              times["k1_ms"], times["k1_plain_ms"], k1_res,
              via=f"hits_shaded (tiled_t.py:2235), _fused_phong attr mode "
                  f"{mode} (tiled_t.py:677)"),
        entry(sh_entry[0], "anyhit.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:1374", label,
              launches[shadow], sh_res["found_max_abs_err"],
              times["shadow_ms"], times["shadow_plain_ms"], sh_res,
              via=sh_entry[1])]


def complex_frames(sr, root, dev):
    """Phase 9's complex frame: (prepared scene, config, light, view of the
    checks, views timed, label).  With the asset directory ``root``, the
    reference's complex scene (``catalog.complex_scene``, world space) on
    the 36 turntable views of ``bench.py::run_complex``; without, its
    stand-in ``procedural.dense_textured_on_ground`` seen from the camera
    at the origin, timed on view-varied frames."""
    import numpy as np
    import torch
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.scene import catalog
    from simple_raytracer_tpu_torch.scene import procedural as P
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=OCC_WIDTH,
                                             height=OCC_HEIGHT,
                                             focal=OCC_FOCAL),
        bvh=sr.BVHConfig(split="sah"))
    if root is None:
        scene = P.dense_textured_on_ground(sr.SceneManager()).build()
        prep = prepare(scene, cfg, device=dev)
        light = torch.tensor(P.BENCH_LIGHT, dtype=torch.float32, device=dev)
        return (prep, cfg, light, None, None,
                f"complex stand-in: procedural dense_textured_on_ground, "
                f"{prep.num_triangles} triangles, {OCC_WIDTH}x{OCC_HEIGHT}")
    require(os.path.isfile(os.path.join(root, "obj", "tree", "tree.obj")),
            f"no complex scene assets under {root}")
    sm, _, light = catalog.complex_scene(root, 0.0, bake_view=False)
    prep = prepare(sm.build(), cfg, device=dev)
    anim = sr.AnimationConfig()
    angles = np.arange(anim.start_deg, anim.stop_deg, anim.step_deg,
                       dtype=np.float32)
    views = [torch.tensor(catalog.orbit_view(
        float(a), anim.orbit_radius, anim.camera_y, anim.pitch_deg,
        anim.yaw_offset_deg), dtype=torch.float32, device=dev)
        for a in angles]
    return (prep, cfg, torch.tensor(light, dtype=torch.float32, device=dev),
            views[0], views,
            f"complex: reference OBJ scene, {prep.num_triangles} triangles, "
            f"{OCC_WIDTH}x{OCC_HEIGHT}, {len(views)}-view turntable")


def io_bound(moved: int, f32_ops: int) -> dict:
    """The bound of a probe: the larger of its bytes over the memory rate
    and its f32 operations over the f32 rate.  The bytes are charged at
    device memory's rate, so the probes are timed with the L2 flushed
    before each timed call, outside its timed interval
    (``probes.device_ms(flush=True)``): back to back, a probe of 10-30 MB
    found its inputs in the 50 MB L2 and beat this bound."""
    t_ops = f32_ops / F32_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes": moved, "f32_ops": f32_ops}


def probe_bytes(variant: str, inputs: dict, out) -> int:
    """Bytes a fixed-cost probe must move: the inputs its variant reads
    (o, d; or the camera constants and tile origins of rebuilt rays and of
    image stores), each once, and its outputs, each written once."""
    from simple_raytracer_tpu_torch.probes import fixed
    rays, _value, _idx, image = fixed.SPECS[variant]
    read = {"o": ("o",), "d": ("d",), "od": ("o", "d"),
            "cam": ("cam", "origins"), None: ()}[rays]
    if image and rays != "cam":
        read += ("origins",)
    return nbytes(*(inputs[k] for k in read), out)


def attr_window_rows(starts, bid) -> int:
    """Distinct table rows that attr_window's inputs need: the window lanes
    whose triangle is some ray's winner."""
    import torch
    from simple_raytracer_tpu_torch.probes import attr
    cols = []
    for k in range(starts.shape[1]):
        s = starts[:, k:k + 1]
        off = bid - s * (attr.WB * attr.BS)
        hit = (off >= 0) & (off < attr.WB * attr.BS)
        cols.append((s * attr.WL + torch.div(off, attr.BS,
                                             rounding_mode="floor")
                     * attr.RPB + off % attr.BS)[hit])
    return int(torch.unique(torch.cat(cols)).numel())


def probe_phase(prep, cfg, light, label: str, gpu: str) -> list:
    """Phase 10: the probes' entry points (probes/fixed.py::run on the
    bench frame, probes/attr.py::run at the scripts' production shapes)
    with every count reset just before and read just after; then each
    probe against its plain version on the same inputs, exactly (t and
    rows equal, idx equal on every lane; K1's cut plans by phase 3's
    check), its plain version's and its library call's times.  Returns the
    kernels-line entries."""
    import torch
    import torch.nn.functional as F
    from simple_raytracer_tpu_torch.kernels import nearest, table
    from simple_raytracer_tpu_torch.probes import attr, device_ms, fixed
    from simple_raytracer_tpu_torch.utils import metrics
    reset_counts()
    frecs, inputs, points = fixed.run(prep, cfg, light, PROBE_FRAMES)
    arecs, ainputs = attr.run(iters=PROBE_FRAMES)
    torch.cuda.synchronize()
    now, calls = metrics.counts(), table.calls()
    launches = {**{v: now.get(f"fixed.fixed_probe.launches.{v}", 0)
                   for v in fixed.VARIANTS},
                **{r: calls[r] for r in ("attr_gather", "attr_window",
                                         "nearest_shaded")}}
    emit(phase=f"probes: launches ({label})", launches=launches)
    require(all(n > 0 for n in launches.values()),
            f"a probe kernel was not launched: {launches}")
    k1_ms = {r["probe"]: r["ms"] for r in frecs if r["variant"] is None}
    entries = []
    o = inputs["o"]
    for r in frecs:
        variant = r["variant"]
        if variant is None:
            continue
        name = r["probe"]
        t, idx = fixed.fixed_probe(variant, **inputs)
        pt, pidx = fixed.fixed_probe_plain(variant, **inputs)
        torch.cuda.synchronize()
        t_eq = bool(torch.equal(t, pt))
        idx_eq = idx is None or bool(torch.equal(idx, pidx))
        err = float((t - pt).abs().max())
        moved = probe_bytes(variant, inputs, (t, idx))
        lanes = t.numel() if variant == "empty" else r["lanes"]
        bnd = io_bound(moved, PROBE_F32_OPS[variant] * lanes)
        plain_ms = cuda_ms(lambda: fixed.fixed_probe_plain(variant, **inputs),
                           2)
        lib_ms = (device_ms(lambda: o[..., 0] + 1.0, PROBE_FRAMES,
                            flush=True)[0] if variant == "io" else None)
        emit(check=f"probe {name} vs plain ({label})", variant=variant,
             t_equal=t_eq, idx_equal=idx_eq, max_abs_err=err,
             ms_per_frame=r["ms"], us_per_tile=r["us_per_tile"],
             ns_per_lane=r["ns_per_lane"],
             host_us_per_call=r["host_us_per_call"],
             share_of_k1=r["ms"] / k1_ms["k1"], **bnd,
             share=bnd["bound_ms"] / r["ms"], plain_ms=plain_ms,
             library_ms=lib_ms, gpu=gpu)
        require(t_eq and idx_eq, f"probe {name} differs from its plain "
                                 f"version ({label})")
        replaces, via = fixed.PROBES[name][1:]
        entries.append(entry(f"fixed_probe_kernel ({name})",
                             "probe_fixed.cu", replaces, label,
                             launches[variant], err, r["ms"], plain_ms, bnd,
                             lib_ms, via=via))

    # where K1's walk goes on the bench plan: the windows each tile walks
    # (its lanes' most needed windows, from the plain walk's record)
    _out, (lane_pairs, _staged) = plain_walk(
        nearest.tiled_nearest_shaded_plain, points["k1"])
    walked = (lane_pairs.amax(dim=1) // points["k1"][6]).float()
    busy = walked[walked > 0]
    emit(check=f"K1 windows walked per tile ({label})",
         tiles=int(walked.numel()), tiles_walking=int(busy.numel()),
         mean=float(busy.mean()), p50=float(busy.quantile(0.5)),
         p90=float(busy.quantile(0.9)), max=int(busy.max()),
         tiles_over_32=int((busy > 32).sum()),
         windows_walked=int(busy.sum()), sms=torch.cuda.get_device_properties(
             prep.device).multi_processor_count)

    # K1 itself on the plan cut to one entry per tile (win) and to none
    size = (cfg.camera.width, cfg.camera.height)
    for name in fixed.K1_POINTS:
        res = check_k1_shaded(points[name], f"{name}: {label}", size)
        plain_ms = cuda_ms(lambda: nearest.tiled_nearest_shaded_plain(
            *points[name]), 2)
        emit(check=f"probe {name} ({label})", ms_per_frame=k1_ms[name],
             k1_ms=k1_ms["k1"], share_of_k1=k1_ms[name] / k1_ms["k1"],
             share=res["bound_ms"] / k1_ms[name], plain_ms=plain_ms, gpu=gpu)
        replaces, via = (fixed.WIN_REPLACES if name == "win" else
                         (fixed.WIN_REPLACES[0], "win_body's fixed part"))
        entries.append(entry(f"{K1_NAME} ({name} plan)",
                             "nearest.cu", replaces, label,
                             launches["nearest_shaded"],
                             res["t_max_abs_err"], k1_ms[name], plain_ms,
                             res, via=via))

    # the winner fetch
    for r in arecs:
        name = r["probe"]
        args = ainputs[name]
        kern = getattr(attr, name)
        plain = getattr(attr, name + "_plain")
        out, pout = kern(*args), plain(*args)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, pout))
        err = float((out - pout).abs().max())
        lib_ms = None
        if name == "attr_gather":
            bid, at = args
            rows = int(torch.unique(bid[bid >= 0]).numel())
            moved = nbytes(bid, out) + rows * at.shape[1] * at.element_size()
            pad = torch.cat([at.new_zeros(1, at.shape[1]), at])
            lib_ms = device_ms(lambda: F.embedding(bid + 1, pad),
                               PROBE_FRAMES, flush=True)[0]
            ops = 0
        else:
            starts, bid, at = args
            rows = attr_window_rows(starts, bid)
            moved = (nbytes(starts, bid, out)
                     + rows * at.shape[1] * at.element_size())
            ops = bid.numel() * starts.shape[1] * attr.AF
        bnd = io_bound(moved, ops)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        emit(check=f"probe {name} vs plain", rows_equal=equal,
             max_abs_err=err, rays=r["lanes"], tiles=r["tiles"],
             ms_per_frame=r["ms"], us_per_tile=r["us_per_tile"],
             ns_per_lane=r["ns_per_lane"],
             host_us_per_call=r["host_us_per_call"], table_rows_read=rows,
             **bnd,
             share=bnd["bound_ms"] / r["ms"], plain_ms=plain_ms,
             library_ms=lib_ms, gpu=gpu)
        require(equal, f"probe {name} differs from its plain version")
        replaces, via = attr.REPLACES[name]
        entries.append(entry(
            name + "_kernel", "probe_attr.cu",
            replaces, f"{r['tiles']} tiles, {r['lanes']} rays",
            launches[name], err, r["ms"], plain_ms, bnd, lib_ms, via=via))
    emit(phase=f"timing (probes: {label})", frames=PROBE_FRAMES, gpu=gpu,
         **{f"{r['probe']}_ms": r["ms"] for r in frecs + arecs})
    return entries


def write_assets(root: str) -> None:
    """Stand-in assets of the reference's layout under ``root``:
    sphere.obj an icosphere(3) of radius SPHERE_RADIUS, cube.obj the unit
    box, as OBJ text."""
    from simple_raytracer_tpu_torch.scene import procedural as P
    sphere = P.icosphere(3)
    sphere.verts[..., :3] *= SPHERE_RADIUS
    for name, mesh in (("sphere.obj", sphere), ("cube.obj", P.box())):
        with open(os.path.join(root, name), "w") as f:
            f.write(P.obj_text(mesh))


def run_cli(args, label: str) -> str:
    """``python -m simple_raytracer_tpu_torch ARGS`` from this checkout, on
    the card (the CLI's default device); its standard output."""
    res = subprocess.run([sys.executable, "-m", "simple_raytracer_tpu_torch",
                          *args], cwd=HERE, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    require(res.returncode == 0,
            f"CLI {label} exited {res.returncode}: {res.stderr[-2000:]}")
    return res.stdout


def agreement(img, ref, what: str, label: str) -> dict:
    """``img`` against ``ref`` (uint8 [H, W, 3]) at the JAX package's bars:
    within 1 on >= 99.9% of pixels, equal on >= 98%."""
    import torch
    img, ref = (torch.as_tensor(x).cpu() for x in (img, ref))
    require(img.shape == ref.shape, f"{label}: {what} shape {img.shape}")
    diff = (img.int() - ref.int()).abs().amax(dim=-1)
    within1 = float((diff <= 1).float().mean())
    equal = float((diff == 0).float().mean())
    require(within1 >= IMAGE_MIN and equal >= 0.98,
            f"{label} vs {what}: {within1} within 1, {equal} equal")
    return {f"vs_{what}_within_1": within1, f"vs_{what}_equal": equal,
            f"vs_{what}_pixels_differ": int((diff > 0).sum())}


def plain_mode_frame(sr, operand, cfg, light, label: str, gpu: str,
                     view=None) -> tuple:
    """A frame of the bruteforce or BVH mode through ``render`` with the
    counts reset just before and read just after: no walk kernel of csrc/
    launched, the shading on the card (one csrc/shade.cu call and launch
    a ray chunk, none plain), coverage in (0.05, 0.99), finite radiance of
    the frame's shape; then MODE_FRAMES frames timed and the card's peak
    allocated memory.  Returns (image, the emitted line)."""
    import torch
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    from simple_raytracer_tpu_torch.utils import metrics
    cam = cfg.camera
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rad, hit = sr.render_radiance(operand, cfg, light, view_matrix=view)
    img = finalize_image(rad, hit, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    launches, shading = counts["launches"], counts["shading"]
    now = metrics.counts("traverse.")
    require(all(n == 0 for n in launches.values()),
            f"{label} launched kernels of csrc/: {launches}")
    require(shading["cuda"] >= 1 and shading["launches"] == shading["cuda"]
            and shading["plain"] == 0,
            f"{label}: shaded {shading}, not on the card alone")
    require(tuple(img.shape) == (cam.height, cam.width, 3)
            and img.device.type == "cuda"
            and bool(torch.isfinite(rad).all()), f"bad radiance ({label})")
    bg = (img == torch.tensor(cfg.background, dtype=torch.uint8,
                              device=img.device)).all(dim=-1)
    coverage = float((~bg).float().mean())
    require(0.05 < coverage < 0.99, f"{label}: coverage {coverage}")
    peak = torch.cuda.max_memory_allocated()
    steps = {}
    if cfg.mode == "bvh":
        steps = {"nearest_steps": now["traverse.nearest_hit.steps"],
                 "shadow_steps": now["traverse.any_hit_other.steps"]}
    t0 = time.time()
    for _ in range(MODE_FRAMES):
        out = sr.render(operand, cfg, light, view_matrix=view,
                        device=operand.device)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / MODE_FRAMES
    require(bool(torch.equal(out, img)), f"{label}: timed frames differ")
    res = {"phase": f"render ({label})", "mode": cfg.mode,
           "width": cam.width, "height": cam.height, "focal": cam.focal,
           "coverage": coverage, "launches": launches, "shading": shading,
           "frames": MODE_FRAMES,
           "ms_per_frame": ms, "peak_allocated_bytes": peak, **steps,
           "gpu": gpu}
    return img, res


def plain_mode_phase(sr, prep, cfg, light, gpu: str) -> None:
    """Phase 11: the bruteforce reference frame (in process and through
    the CLI), the bruteforce soft textured frame, the BVH flagship frame,
    the CLI's turntable with its resume, and the profiler's traces."""
    import tempfile
    import torch
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.io.image import read_bmp
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels.tiled import frame_branch
    from simple_raytracer_tpu_torch.render.renderer import ensure_prepared
    from simple_raytracer_tpu_torch.scene import catalog
    from simple_raytracer_tpu_torch.scene import procedural as P
    from simple_raytracer_tpu_torch.utils import metrics
    dev = prep.device
    with tempfile.TemporaryDirectory() as tmp:
        write_assets(tmp)
        # the reference frame: six spheres at the CLI's defaults
        sm, view, slight = catalog.six_spheres(tmp, 0.0, bake_view=False)
        scene = sm.build()
        bf = sr.default_config()
        require(bf.mode == "bruteforce", f"default mode {bf.mode}")
        operand = ensure_prepared(scene, bf, dev)
        label = (f"bruteforce: six_spheres, {scene.num_triangles} "
                 f"triangles, {bf.camera.width}x{bf.camera.height}")
        img, res = plain_mode_frame(sr, operand, bf, slight, label, gpu,
                                    view)
        out = os.path.join(tmp, "bf.bmp")
        run_cli(["render", "--scene", "six_spheres", "--root", tmp,
                 "--mode", "bruteforce", "--out", out], "render")
        cli_img = torch.from_numpy(read_bmp(out))
        require(torch.equal(cli_img, img.cpu()),
                f"{label}: the CLI's BMP differs from render()")
        tiled = sr.render(scene, bf.replace(mode="tiled"), slight, view,
                          device=dev)
        bvh = sr.render(scene, bf.replace(mode="bvh"), slight, view,
                        device=dev)
        emit(**res, triangles=scene.num_triangles, cli_bmp_equal=True,
             **agreement(img, tiled, "tiled", label),
             **agreement(img, bvh, "bvh", label))

        # bruteforce soft textured against the tiled gather frame
        tex_scene = P.textured_on_ground(sr.SceneManager(),
                                         TEX_SUBDIV).build()
        tcfg = bf.replace(camera=sr.CameraConfig(
            width=OCC_WIDTH, height=OCC_HEIGHT, focal=OCC_FOCAL),
            light=sr.LightConfig(num_samples=TEX_SAMPLES),
            bvh=sr.BVHConfig(split="sah"))
        label = (f"bruteforce soft textured: procedural textured_on_ground"
                 f"({TEX_SUBDIV}), {tex_scene.num_triangles} triangles, "
                 f"{OCC_WIDTH}x{OCC_HEIGHT}, S={TEX_SAMPLES}")
        timg, res = plain_mode_frame(sr, tex_scene.to(dev), tcfg, light,
                                     label, gpu)
        gcfg = tcfg.replace(mode="tiled")
        gprep = prepare(tex_scene, gcfg, dev)
        tpx = pl.effective_tile_px(gcfg, gprep.scene.num_triangles)
        require(frame_branch(gprep, gcfg, tpx * tpx) == "gather",
                f"{label}: the tiled frame is not the gather branch")
        gimg = sr.render(gprep, gcfg, light)
        emit(**res, triangles=tex_scene.num_triangles,
             **agreement(timg, gimg, "tiled_gather", label))

        # the BVH flagship frame: the bench's scene at 256x192
        fcam = sr.CameraConfig(width=FLAGSHIP_WIDTH, height=FLAGSHIP_HEIGHT,
                               focal=P.bench_focal(FLAGSHIP_HEIGHT))
        fcfg = cfg.replace(mode="bvh", camera=fcam)
        label = (f"bvh flagship: {prep.num_triangles} triangles, "
                 f"{FLAGSHIP_WIDTH}x{FLAGSHIP_HEIGHT}")
        fimg, res = plain_mode_frame(sr, prep, fcfg, light, label, gpu)
        ftiled = sr.render(prep, fcfg.replace(mode="tiled"), light)
        emit(**res, triangles=prep.num_triangles, num_nodes=prep.num_nodes,
             max_leaf=prep.max_leaf,
             **agreement(fimg, ftiled, "tiled", label))

        # the turntable through the CLI, then again: nothing to write
        gen = os.path.join(tmp, "gen")
        anim = ["animate", "--scene", "six_spheres", "--root", tmp,
                "--step-deg", "120", "--fmt", "bmp", "--out-dir", gen]
        first = run_cli(anim, "animate")
        names = sorted(os.listdir(gen))
        require(names == ["output0.bmp", "output120.bmp", "output240.bmp"],
                f"animate wrote {names}")
        mtimes = [os.path.getmtime(os.path.join(gen, n)) for n in names]
        second = run_cli(anim, "animate (resume)")
        require('"sweep"' in first and '"sweep"' not in second
                and [os.path.getmtime(os.path.join(gen, n))
                     for n in names] == mtimes
                and sorted(os.listdir(gen)) == names,
                "animate did not resume past its frames")
        sweep = [json.loads(x) for x in first.splitlines()
                 if '"sweep"' in x][0]
        emit(phase="turntable (six_spheres, tiled, CLI)", files=names,
             ms_per_frame=sweep["ms_per_frame"], resumed=True, gpu=gpu)

        # the profiler: the CLI's trace, then 3 bench frames traced
        trace_dir = os.path.join(tmp, "trace")
        run_cli(["render", "--scene", "six_spheres", "--root", tmp,
                 "--mode", "tiled", "--profile", trace_dir,
                 "--out", os.path.join(tmp, "t.png")], "render --profile")
        path = os.path.join(trace_dir, metrics.TRACE_FILE)
        require(os.path.isfile(path), f"no trace at {path}")
        # its window holds prepare and the kernels' first build as well as
        # the frame, so it checks the trace, not the card's busy share
        cli_kernels = metrics.busy_share(path)["kernels"]
        require(cli_kernels > 0, "the CLI's trace has no kernels")
        emit(phase="profile (CLI render, six_spheres, tiled)",
             trace=os.path.relpath(path, tmp), trace_bytes=os.path.getsize(
                 path), kernels=cli_kernels, gpu=gpu)
        bench_dir = os.path.join(tmp, "bench_trace")
        view_varied_ms(sr, prep, cfg, light, 2, "profile warm-up")
        with metrics.profile_trace(bench_dir):
            view_varied_ms(sr, prep, cfg, light, MODE_FRAMES, "profile")
        bpath = os.path.join(bench_dir, metrics.TRACE_FILE)
        share = metrics.busy_share(bpath)
        require(share["kernels"] > 0, "the bench trace has no kernels")
        emit(phase="profile (bench, 3 view-varied frames)",
             trace_bytes=os.path.getsize(bpath), **share, gpu=gpu)


def train_losses(step, params, target, steps: int) -> tuple:
    """(the last params, the losses of ``steps`` steps from ``params``)."""
    losses = []
    for _ in range(steps):
        params, loss = step(params, target)
        losses.append(float(loss))
    return params, losses


def falling(losses, what: str) -> None:
    import math
    require(all(math.isfinite(x) for x in losses)
            and all(b < a for a, b in zip(losses, losses[1:])),
            f"{what}: losses {losses} not finite and falling")


def grads_within(got, want, what: str, rel=None, rtol=0.0,
                 atol=0.0) -> dict:
    """Each field of the DiffParams ``got`` against ``want``: within
    ``rel`` of the field's largest magnitude, or within rtol / atol
    elementwise; finite.  Returns the max abs error of each field."""
    import dataclasses
    import torch
    errs = {}
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        require(bool(torch.isfinite(a).all()), f"{what}: {f.name} not finite")
        err = float((a - b).abs().max()) if a.numel() else 0.0
        ok = (err <= rel * float(b.abs().max()) if rel is not None else
              bool(torch.allclose(a, b, rtol=rtol, atol=atol)))
        require(ok, f"{what}: {f.name} differs by {err}")
        errs[f.name] = err
    return errs


def train_phase(sr, prep, light, root, gpu: str) -> list:
    """Phase 12: the train bench's step through ``make_train_step`` with
    the counts read around its first step, its walks and the whole step
    against their plain versions, remat, the times, the tiled gradients
    against the bruteforce ones, the CLI's ``train`` with its resume, and
    the texture fit.  Returns the kernels-line entries."""
    import tempfile
    import torch
    from simple_raytracer_tpu_torch.dist.train import DiffParams
    from simple_raytracer_tpu_torch.examples import fit_texture
    from simple_raytracer_tpu_torch.kernels import (anyhit, nearest, table,
                                                    tiled)
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    from simple_raytracer_tpu_torch.scene import procedural as P
    dev = prep.device
    cfg = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=WIDTH, height=HEIGHT,
                                             focal=SHADOW_FOCAL),
        light=sr.LightConfig(enable_shadows=True),
        bvh=sr.BVHConfig(split="sah"))
    label = (f"train bench: {prep.num_triangles} triangles, {WIDTH}x"
             f"{HEIGHT}, focal {SHADOW_FOCAL:g}")
    with torch.no_grad():
        rad, hit = sr.render_radiance(prep, cfg, light)
        target = torch.where(hit[..., None], rad, 0.0)
    start = sr.extract_params(prep.scene, light)
    start.obj_color = start.obj_color * TRAIN_COLOR
    step = sr.make_train_step(prep, cfg, lr=TRAIN_LR)

    # the main path: the counts reset just before the first step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params, loss = step(start, target)
    torch.cuda.synchronize()
    launches = read_counts()["launches"]
    peak = torch.cuda.max_memory_allocated()
    roles = ("nearest_rays", "anyhit")
    require(launches == {r: int(r in roles) for r in launches},
            f"{label}: a step launched {launches}, not {roles} once each")
    params, more = train_losses(step, params, target, TRAIN_STEPS - 1)
    losses = [float(loss)] + more
    falling(losses, label)
    require(all(bool(torch.isfinite(p).all()) for p in params.leaves()),
            f"{label}: params not finite")

    # the step's walks against their plain versions, on the step's
    # arguments; the shadow front end's inputs for its time
    stores = {role: [] for role in WALKS}
    shadow_in = []
    real_shadow_fn = tiled.tiled_shadow_fn

    def shadow_spy(*a, **k):
        fn = real_shadow_fn(*a, **k)
        return lambda *x, **y: (shadow_in.append((fn, x, y)), fn(*x, **y))[1]
    tiled.tiled_shadow_fn = shadow_spy
    try:
        with table.using({role: table.spy(role, stores[role])
                          for role in WALKS}):
            sr.make_train_step(prep, cfg).value_and_grad(start, target)
    finally:
        tiled.tiled_shadow_fn = real_shadow_fn
    kn, ks = stores["nearest_rays"][0], stores["anyhit"][0]
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    tile = tpx * tpx
    inside = frame_lanes(*pl.tile_origins(kn[0].shape[0],
                                          -(-WIDTH // tpx), tpx, WIDTH,
                                          HEIGHT, dev),
                         tpx, WIDTH, HEIGHT)
    near_res, kt, _ki, _walk = check_nearest(
        nearest.tiled_nearest_rays, nearest.tiled_nearest_rays_plain, kn,
        inside, "K1 rays mode", label, nearest_ops(kn[2]),
        window_bytes(kn[1], kn[4]), 24, exact=True)
    sh_res, _walk = check_found(anyhit.tiled_anyhit,
                                anyhit.tiled_anyhit_plain, ks,
                                torch.isfinite(kt) & inside, 1, "K2'", label,
                                SHADOWED_MIN)

    # the whole step on the plain walks: the same winners on every ray
    o, d, _, _ = primary_rays_tiled(WIDTH, HEIGHT, tpx, SHADOW_FOCAL,
                                    device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    tk, ik = nearest.hits(prep, cfg, o, d, tile, maxv, apex=True)
    with table.using(table.plain()):
        tp, ip = nearest.hits(prep, cfg, o, d, tile, maxv, apex=True)
    require(torch.equal(ik, ip) and torch.equal(tk, tp),
            f"{label}: the step's winners differ from the plain walks'")
    plain = sr.make_train_step(prep, cfg, lr=TRAIN_LR)
    lk, gk = step.value_and_grad(start, target)
    with table.using(table.plain()):
        lp, gp = plain.value_and_grad(start, target)
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    require(loss_err <= 1e-6, f"{label}: loss vs plain {loss_err}")
    errs = grads_within(gk, gp, f"{label} vs plain", rel=GRAD_REL)
    emit(check=f"train step vs plain walks ({label})",
         idx_equal_every_ray=True, rays=int(ik.numel()),
         hit_rays=int((ik >= 0).sum()), loss=float(lk),
         loss_rel_err=loss_err, grad_max_abs_err=errs,
         grad_max_abs={f: float(g.abs().max()) for f, g in
                       zip(errs, gp.leaves())}, grad_rel_bound=GRAD_REL)

    # remat: the forward again in the backward, the walks twice a step
    rstep = sr.make_train_step(prep, cfg, lr=TRAIN_LR, remat=True)
    reset_counts()
    rparams, rloss = rstep(start, target)
    torch.cuda.synchronize()
    rlaunches = read_counts()["launches"]
    require(rlaunches == {r: 2 * int(r in roles) for r in rlaunches},
            f"{label}: a remat step launched {rlaunches}")
    _, rmore = train_losses(rstep, rparams, target, TRAIN_STEPS - 1)
    rlosses = [float(rloss)] + rmore
    rerr = max(abs(a - b) / abs(b) for a, b in zip(rlosses, losses))
    require(rerr <= 1e-6, f"{label}: remat losses {rlosses} vs {losses}")

    # the times: steps on the host clock, the parts alone (CUDA events)
    torch.cuda.synchronize()
    t0 = time.time()
    train_losses(step, start, target, TRAIN_TIMED)
    torch.cuda.synchronize()
    ms_step = (time.time() - t0) * 1e3 / TRAIN_TIMED
    shadow_fn, sx, sy = shadow_in[0]
    leaves = [x.detach().requires_grad_(True) for x in start.leaves()]
    times = {
        "plan_and_k1_ms": cuda_ms(lambda: nearest.hits(
            prep, cfg, o, d, tile, maxv, apex=True), 10),
        "k1_rays_ms": cuda_ms(lambda: nearest.tiled_nearest_rays(*kn), 20),
        "k1_rays_plain_ms": cuda_ms(
            lambda: nearest.tiled_nearest_rays_plain(*kn), 2),
        "shadow_ms": cuda_ms(lambda: shadow_fn(*sx, **sy), 10),
        "k2r_ms": cuda_ms(lambda: anyhit.tiled_anyhit(*ks), 20),
        "k2r_plain_ms": cuda_ms(lambda: anyhit.tiled_anyhit_plain(*ks), 2),
        "forward_ms": cuda_ms(lambda: step.loss_fn(DiffParams(*leaves),
                                                   target), 10),
        "forward_backward_ms": cuda_ms(
            lambda: step.value_and_grad(start, target), 10),
        "step_ms": cuda_ms(lambda: step(start, target), 10),
        "remat_step_ms": cuda_ms(lambda: rstep(start, target), 5)}
    times["recompute_and_shade_ms"] = (times["forward_ms"]
                                       - times["plan_and_k1_ms"]
                                       - times["shadow_ms"])
    times["backward_ms"] = times["forward_backward_ms"] - times["forward_ms"]
    times["update_ms"] = times["step_ms"] - times["forward_backward_ms"]
    emit(phase=f"train ({label})", rays=int(o.shape[0]),
         tiles=int(kn[0].shape[0]), steps=TRAIN_STEPS, lr=TRAIN_LR,
         losses=losses, remat_losses=rlosses, remat_max_rel_err=rerr,
         launches=launches, remat_launches=rlaunches,
         peak_allocated_bytes=peak, steps_timed=TRAIN_TIMED,
         ms_per_step=ms_step, **times, gpu=gpu)

    # the tiled gradients against the bruteforce ones, at 256x192
    ccfg = cfg.replace(camera=sr.CameraConfig(
        width=FLAGSHIP_WIDTH, height=FLAGSHIP_HEIGHT,
        focal=P.bench_focal(FLAGSHIP_HEIGHT)))
    with torch.no_grad():
        crad, chit = sr.render_radiance(prep, ccfg, light)
        ctarget = torch.where(chit[..., None], crad, 0.0)
    t0 = time.time()
    ltl, gtl = sr.make_train_step(prep, ccfg).value_and_grad(start, ctarget)
    torch.cuda.synchronize()
    tiled_s = time.time() - t0
    t0 = time.time()
    lbf, gbf = sr.make_train_step(
        prep, ccfg.replace(mode="bruteforce")).value_and_grad(start, ctarget)
    torch.cuda.synchronize()
    bf_s = time.time() - t0
    cerrs = grads_within(gtl, gbf, "tiled vs bruteforce grads",
                         rtol=GRAD_RTOL, atol=GRAD_ATOL)
    emit(check=f"tiled grads vs bruteforce grads ({prep.num_triangles} "
               f"triangles, {FLAGSHIP_WIDTH}x{FLAGSHIP_HEIGHT})",
         loss_tiled=float(ltl), loss_bruteforce=float(lbf),
         grad_max_abs_err=cerrs, rtol=GRAD_RTOL, atol=GRAD_ATOL,
         tiled_step_s=tiled_s, bruteforce_step_s=bf_s, gpu=gpu)

    # the command line: train, then resume from its checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        write_assets(tmp)
        ck = os.path.join(tmp, "train.npz")
        args = ["train", "--scene", "six_spheres", "--root", tmp,
                "--checkpoint", ck, "--ckpt-every", "2", "--lr", "1e-3",
                "--log-every", "1"]
        first = [json.loads(x) for x in run_cli(
            args + ["--steps", "5"], "train").splitlines()
            if x.startswith("{")]
        cli_losses = [e["loss"] for e in first if e["event"] == "train"]
        require(len(cli_losses) == 5, f"train logged {cli_losses}")
        falling(cli_losses, "CLI train")
        second = [json.loads(x) for x in run_cli(
            args + ["--steps", "7"], "train (resume)").splitlines()
            if x.startswith("{")]
        resumed = [e["step"] for e in second if e["event"] == "resumed"]
        more = [e for e in second if e["event"] == "train"]
        require(resumed == [5] and [e["step"] for e in more] == [5, 6]
                and more[0]["loss"] < cli_losses[-1],
                f"train did not resume at step 5: {second}")
        emit(phase="train (CLI, six_spheres, bruteforce)", losses=cli_losses,
             resumed_at=resumed[0],
             resumed_losses=[e["loss"] for e in more], gpu=gpu)

    # the texture fit
    fscene, fcfg = fit_texture.scene_and_config(root, FIT_WIDTH, FIT_HEIGHT,
                                                device=dev)
    t0 = time.time()
    _tex, fit_losses, _t, _h = fit_texture.fit(fscene, fcfg, light,
                                               FIT_STEPS)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    require(fit_losses[-1] < fit_losses[0] / 5.0,
            f"texture fit: loss {fit_losses[0]} -> {fit_losses[-1]}")
    emit(phase="texture fit", source="the tree" if root else
         "procedural textured_on_ground(3)", width=FIT_WIDTH,
         height=FIT_HEIGHT, steps=FIT_STEPS, loss_first=fit_losses[0],
         loss_last=fit_losses[-1], ms_per_step=fit_s * 1e3 / FIT_STEPS,
         gpu=gpu)

    return [
        entry(RAYS_NAME, "nearest.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:855", label,
              launches["nearest_rays"], near_res["t_max_abs_err"],
              times["k1_rays_ms"], times["k1_rays_plain_ms"], near_res,
              via="tiled_nearest_t over explicit rays (tiled_t.py:1616)"),
        entry(ANYHIT_NAME, "anyhit.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:1374", label,
              launches["anyhit"], sh_res["found_max_abs_err"],
              times["k2r_ms"], times["k2r_plain_ms"], sh_res,
              via="tiled_anyhit_t (tiled_t.py:1815)")]


def timed_plains() -> dict:
    """The walks' plain twins by role (kernels/table.py), each timed on the
    card
    (CUDA events, ``.ms``) at its first call on a set of arguments and kept
    with its result: a later call on equal arguments returns that result
    again.  The plain image of a frame whose kernels were just held to
    these versions then reuses their walks on the same inputs (a range-only
    walk at 1080p takes some 20 s in plain PyTorch)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import table

    def same(a, b):
        if torch.is_tensor(a) or torch.is_tensor(b):
            return (torch.is_tensor(a) and torch.is_tensor(b)
                    and a.shape == b.shape and a.dtype == b.dtype
                    and a.device == b.device and torch.equal(a, b))
        return a == b

    def kept(fn):
        def call(*args):
            if call.args is not None and len(args) == len(call.args) and all(
                    same(a, b) for a, b in zip(args, call.args)):
                return call.out
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0.record()
            out = fn(*args)
            t1.record()
            torch.cuda.synchronize()
            call.ms, call.args, call.out = t0.elapsed_time(t1), args, out
            return out
        call.ms = call.args = call.out = None
        return call
    return {role: kept(table.roles()[role].plain) for role in WALKS}


def config_frame(sr, prep, cfg, light, label: str, gpu: str, frames: int,
                 reference=None, shadowed_min=None) -> tuple:
    """A frame of phase 13 (``hit_tile`` sub-tiles, normalized directions or
    range-only plans: the soft, gather or paged branch over the explicit
    primary rays, as JAX's render_flat_tiled picks it): the nearest walk
    (K1's fetch mode over rays, K1's rays mode or K6) and the any-hit walk
    (K2′ or K7) against their plain versions on the frame's arguments, bit
    for bit (t, idx and the fetch mode's attribute rows; found on every
    lane), with their ``schedule`` lines; with ``reference`` ("full tile":
    the fetch mode over the same rays in whole tiles; "lists": the walk of
    the same rays over list plans of LIST_MAXV entries), the frame's (t,
    idx) equal on every lane to that walk's; the frame through the public
    entry points with the counts reset just before (its branch's two
    kernels launched, no other) against the plain image; ``frames``
    view-varied frames timed, each kernel and its plain version.  Returns
    (the kernels-line entries, the frame's primary rays (o, d))."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest, paged
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels import table
    from simple_raytracer_tpu_torch.kernels import tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    dev = prep.device
    cam = cfg.camera
    S = cfg.light.num_samples
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    tile = tpx * tpx
    branch = tiled.frame_branch(prep, cfg, tile)
    near = {"soft": "nearest_rays_attrs", "gather": "nearest_rays",
            "paged": "nearest_pages"}[branch]
    occ = "anyhit_pages" if branch == "paged" else "anyhit"
    fetch = near == "nearest_rays_attrs"
    what = {"nearest_rays_attrs": "K1 fetch over rays",
            "nearest_rays": "K1 rays", "nearest_pages": "K6"}[near]
    occ_what = "K7" if branch == "paged" else "K2'"
    sweep = cfg.cull_maxv > 0          # range-only walks: no span sweeps
    reps = 20 if sweep else 3
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx, cam.focal,
                                    cam.normalize_dirs, device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    args = frame_args(prep, cfg, light, cam_spec, (o, d))
    kn, ko = args[near], args[occ]
    plains = timed_plains()
    kernel = table.roles()[near].cuda

    # the nearest walk vs plain; the fetch mode's rows too
    walk_args = (kn[0], kn[1], *kn[3:]) if fetch else kn
    n, m = walk_args[2].shape[:2]
    inside = frame_lanes(*pl.tile_origins(o.shape[0] // tile,
                                          -(-cam.width // tpx), tpx,
                                          cam.width, cam.height, dev),
                         tpx, cam.width, cam.height).reshape(n, m)
    n_res, kt, ki, n_walk = check_nearest(
        kernel, plains[near], kn, inside, what, label,
        nearest_ops(walk_args[2]), window_bytes(kn[1], walk_args[4]), 24,
        winners=kn[2] if fetch else None, exact=True)
    if fetch:
        ka, pa = kernel(*kn)[2], plains[near](*kn)[2]
        torch.cuda.synchronize()
        rows_equal = bool(torch.equal(ka, pa))
        emit(check=f"{what} rows vs plain ({label})", rows_equal=rows_equal,
             hit_rows=int((ka[:, 3] >= 0).sum()))
        require(rows_equal, f"{what} rows differ from the plain fetch "
                            f"({label})")
    rays_schedule(walk_args, label, n_walk, what, sweep=sweep)
    if reference:
        wb = cfg.kernel.window_blocks
        if reference == "full tile":
            maxv = pl.effective_cull_maxv(cfg, prep.num_blocks, wb)
            rt, ri, _ = nearest.hits_attrs(prep, cfg, None, maxv,
                                           rays=(o, d), tile=tile)
        elif branch == "paged":
            rt, ri = paged.hits(prep, cfg, o, d, tile, LIST_MAXV, apex=True)
        else:
            rt, ri = nearest.hits(prep, cfg.replace(cull_maxv=LIST_MAXV), o,
                                  d, tile, pl.effective_cull_maxv(
                                      cfg.replace(cull_maxv=LIST_MAXV),
                                      prep.num_blocks, wb), apex=True)
        torch.cuda.synchronize()
        same = bool(torch.equal(rt, kt.reshape(-1))
                    and torch.equal(ri, ki.reshape(-1)))
        emit(check=f"{what} vs the {reference} walk ({label})",
             t_idx_equal_every_lane=same, hit_rays=int(torch.isfinite(rt)
                                                       .sum()),
             lanes=int(rt.numel()))
        require(same, f"{what} (t, idx) differ from the {reference} walk of "
                      f"the same rays ({label})")

    # the any-hit walk vs plain, on the lanes whose point is a hit
    o_res, o_walk = check_found(table.roles()[occ].cuda, plains[occ], ko,
                                (torch.isfinite(kt) & inside).reshape(-1),
                                S, occ_what, label, shadowed_min)
    rays_schedule(ko, label, o_walk, occ_what, occlusion=True, sweep=sweep)

    launches = render_checked(sr, prep, cfg, light, label, (near, occ),
                              plains=plains)["launches"]
    ms_frame = view_varied_ms(sr, prep, cfg, light, frames, label)
    times = {"nearest_ms": cuda_ms(lambda: kernel(*kn), reps),
             "nearest_plain_ms": plains[near].ms,
             "anyhit_ms": cuda_ms(lambda: table.roles()[occ].cuda(*ko), reps),
             "anyhit_plain_ms": plains[occ].ms,
             "frame_ms": cuda_ms(lambda: finalize_image(
                 *sr.render_radiance(prep, cfg, light), cfg), reps)}
    emit(phase=f"timing ({label})", width=cam.width, height=cam.height,
         samples=S, branch=branch, frames=frames, ms_per_frame=ms_frame,
         rays_per_s=cam.width * cam.height * 1e3 / ms_frame, gpu=gpu,
         **times)
    near_entry = {
        "nearest_rays_attrs": (K1_FETCH_RAYS_NAME,
                               "simple_raytracer_tpu/kernels/tiled_t.py:855",
                               "tiled_nearest_t with At and no cam "
                               "(tiled_t.py:1616), from hits_attrs"),
        "nearest_rays": (RAYS_NAME + " (K1 rays mode)",
                         "simple_raytracer_tpu/kernels/tiled_t.py:855",
                         "tiled_nearest_t (tiled_t.py:1616), from hits"),
        "nearest_pages": (RAYS_NAME + " (pages)",
                          "simple_raytracer_tpu/kernels/tiled.py:815",
                          "tiled_nearest (tiled.py:1047)")}[near]
    occ_entry = ((ANYHIT_NAME + " (page windows)",
                  "simple_raytracer_tpu/kernels/tiled.py:905",
                  "tiled_anyhit (tiled.py:1090)") if branch == "paged" else
                 (ANYHIT_NAME, "simple_raytracer_tpu/kernels/tiled_t.py:1374",
                  "tiled_anyhit_t (tiled_t.py:1815)"))
    return [
        entry(near_entry[0], "nearest.cu", near_entry[1], label,
              launches[near], n_res["t_max_abs_err"], times["nearest_ms"],
              times["nearest_plain_ms"], n_res, via=near_entry[2]),
        entry(occ_entry[0], "anyhit.cu", occ_entry[1], label,
              launches[occ], o_res["found_max_abs_err"],
              times["anyhit_ms"], times["anyhit_plain_ms"], o_res,
              via=occ_entry[2])], (o, d)


def fused_over_range_plan(prep, cfg, light, label: str, rays) -> dict:
    """K1's fused flat mode over the frame's range-only primary plan (built
    from its rays ``rays`` with the pixel origins in columns 4/5, as a
    scene of more than 65,536 windows plans it): against its plain version
    (t and idx bit for bit, rows within RGB_ATOL, bounds rows) and, on
    every lane, K1's (t, idx) over the frame's list plan; timed.  No frame
    of this run has more than 65,536 windows, so no frame launches it."""
    import torch
    from simple_raytracer_tpu_torch.kernels import nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    cam = cfg.camera
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    k1 = list(nearest.shaded_args(prep, cfg, light, cam_spec, maxv))
    lt, li = nearest.tiled_nearest_shaded(*k1)[:2]
    k1[0] = nearest.primary_plan(prep, cfg, cam_spec, 0, rays)
    k1 = tuple(k1)
    require(bool((k1[0][:, 3] == 0).all()), "the plan is not range-only")
    plain = timed_plains()["nearest_shaded"]
    res = check_k1_shaded(k1, label, (cam.width, cam.height), plain=plain,
                          sweep=False)
    kt, ki = nearest.tiled_nearest_shaded(*k1)[:2]
    torch.cuda.synchronize()
    same = bool(torch.equal(kt, lt) and torch.equal(ki, li))
    out = {"check": f"K1 fused over its range-only plan ({label})",
           "t_idx_equal_list_walk_every_lane": same,
           "ms": cuda_ms(lambda: nearest.tiled_nearest_shaded(*k1), 3),
           "plain_ms": plain.ms, "bound_ms": res["bound_ms"],
           "bound_by": res["bound_by"], "pairs": res["pairs"],
           "launches_on_a_frame": 0, "library_ms": None}
    emit(**out)
    require(same, f"K1 fused over the range-only plan differs from its list "
                  f"walk ({label})")
    return out


def config_phase(sr, prep, cfg, light, source: str, gpu: str) -> list:
    """Phase 13: the tiled configurations that walk explicit rays or
    range-only plans, on the shadow bench (sub-tiles, normalized
    directions, cull_maxv=0, K1's fused mode over the range-only plan) and
    the paged frame at 600x400 with cull_maxv=0.  Returns the
    kernels-line entries."""
    sb = cfg.replace(camera=sr.CameraConfig(width=WIDTH, height=HEIGHT,
                                            focal=SHADOW_FOCAL))
    sb_label = (f"shadow bench: {source}, {WIDTH}x{HEIGHT}, focal "
                f"{SHADOW_FOCAL:g}")
    entries, _ = config_frame(
        sr, prep, sb.replace(hit_tile=SUB_TILE), light,
        f"sub-tile {sb_label}, hit_tile {SUB_TILE}", gpu, FRAMES,
        "full tile", SHADOWED_MIN)
    more, _ = config_frame(
        sr, prep, sb.replace(camera=sr.CameraConfig(
            width=WIDTH, height=HEIGHT, focal=SHADOW_FOCAL,
            normalize_dirs=True)), light, f"normalized {sb_label}", gpu,
        FRAMES, None, SHADOWED_MIN)
    entries += more
    range_label = f"range-only {sb_label}, cull_maxv 0"
    more, rays = config_frame(sr, prep, sb.replace(cull_maxv=0), light,
                              range_label, gpu, RANGE_FRAMES, "lists",
                              SHADOWED_MIN)
    entries += more
    fused_over_range_plan(prep, sb, light, range_label, rays)
    more, _ = config_frame(
        sr, prep, cfg.replace(camera=sr.CameraConfig(
            width=OCC_WIDTH, height=OCC_HEIGHT, focal=OCC_FOCAL),
            tiled_impl="paged", cull_maxv=0), light,
        f"paged range-only: {source}, {OCC_WIDTH}x{OCC_HEIGHT}, cull_maxv 0",
        gpu, RANGE_FRAMES, "lists")
    return entries + more


def image_bars(img, ref, what: str, within_min: float, equal_min: float
               ) -> dict:
    """Two uint8 frames: within 1 on >= ``within_min`` of the pixels, equal
    on >= ``equal_min``."""
    diff = (img.int() - ref.int()).abs().amax(dim=-1)
    out = {"within_1": float((diff <= 1).float().mean()),
           "equal": float((diff == 0).float().mean())}
    require(out["within_1"] >= within_min and out["equal"] >= equal_min,
            f"{what}: {out}")
    return out


def host_ms(fn, reps: int) -> float:
    """Host ms per run of ``fn`` over ``reps`` runs ending in a
    synchronize, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / reps


def busiest_call(calls) -> int:
    """The index of the call, of a list of captured kernel arguments, whose
    plan holds the most windows."""
    return max(range(len(calls)), key=lambda i: int(plan_stats(
        calls[i][0])["windows_per_tile_mean"] * calls[i][0].shape[0]))


def spied_run(fn, roles) -> tuple:
    """``fn()`` with the counts reset just before and read just after, a
    :func:`spy` in each of ``roles`` capturing its arguments meanwhile.
    Returns (its result, the walks' counts, the captured arguments by
    role)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import table
    stores = {r: [] for r in roles}
    reset_counts()
    with table.using({r: table.spy(r, stores[r]) for r in roles}):
        out = fn()
        torch.cuda.synchronize()
    return out, read_counts()["launches"], stores


def ray_walk_holds(near: str, occ: str, kn, ko, R: int, S: int, what,
                   label: str) -> tuple:
    """A nearest walk over explicit rays (role ``near``: K1's fetch mode
    over rays, "nearest_rays_attrs", or K1's rays mode) and the any-hit
    walk of the same rays' hit points (role ``occ``: K2′ or K7) held to
    their plain versions on a path's captured arguments ``kn`` and ``ko``,
    bit for bit (t, idx, the fetched rows; found on every lane); the first
    ``R`` lanes of the nearest walk's tiles are real rays, the shadow's
    lanes follow them, ``S`` samples each; ``what`` names the two walks.
    Timed: each kernel (CUDA events) and its plain version (its one run).
    Returns (the nearest walk's check line, the any-hit walk's, the
    times)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import table
    fetch = near == "nearest_rays_attrs"
    plains = timed_plains()
    near_fn, occ_fn = table.roles()[near].cuda, table.roles()[occ].cuda
    walk_args = (kn[0], kn[1], *kn[3:]) if fetch else kn
    n, m = walk_args[2].shape[:2]
    dev = walk_args[2].device
    inside = (torch.arange(n * m, device=dev) < R).reshape(n, m)
    n_res, kt, _ki, _w = check_nearest(
        near_fn, plains[near], kn, inside, what[0], label,
        nearest_ops(walk_args[2]), window_bytes(kn[1], walk_args[4]), 24,
        winners=kn[2] if fetch else None, exact=True)
    if fetch:
        ka, pa = near_fn(*kn)[2], plains[near](*kn)[2]
        torch.cuda.synchronize()
        rows_equal = bool(torch.equal(ka, pa))
        emit(check=f"{what[0]} rows vs plain ({label})",
             rows_equal=rows_equal, hit_rows=int((ka[:, 3] >= 0).sum()))
        require(rows_equal, f"{what[0]} rows differ from the plain fetch "
                            f"({label})")
    o_res, _ = check_found(occ_fn, plains[occ], ko,
                           (torch.isfinite(kt) & inside).reshape(-1)[:R],
                           S, what[1], label)
    times = {"nearest_ms": cuda_ms(lambda: near_fn(*kn), 3),
             "nearest_plain_ms": plains[near].ms,
             "anyhit_ms": cuda_ms(lambda: occ_fn(*ko), 3),
             "anyhit_plain_ms": plains[occ].ms}
    return n_res, o_res, times


def dp_world_of_one(sr, prep, scene, cfg, light, label: str, gpu: str):
    """Phase 14 (a): the distribution layer on a one-process NCCL group on
    the card.  The data-parallel frame (row-major slabs through the
    explicit-ray entry: K1's fetch mode over rays, K2′) with the counts
    reset just before, equal on every pixel to the explicit-ray entry's
    render of the same unsharded rays and within the port's bars of the
    fused frame; one DP train step equal to the step without a mesh bit
    for bit; three composed steps (dp = gp = 1, the ring of one shard
    inside the loss) with falling losses; ``frames_parallel`` of two
    views equal to ``frames_batched``.  The DP frame's K1 fetch over rays
    and K2′, and the composed steps' K1 rays walk and K7, held bit for bit
    to their plain versions on the arguments those paths gave them.
    Returns the kernels-line entries of the DP frame and the composed
    steps."""
    import numpy as np
    import torch
    from simple_raytracer_tpu_torch.dist import (make_mesh,
                                                 make_train_step_composed,
                                                 render_sharded)
    from simple_raytracer_tpu_torch.driver.animation import (frames_batched,
                                                             frames_parallel)
    from simple_raytracer_tpu_torch.kernels.tiled import render_flat_tiled
    from simple_raytracer_tpu_torch.ops.camera import primary_rays
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    from simple_raytracer_tpu_torch.scene.catalog import orbit_view
    cam = cfg.camera
    dev = prep.device
    mesh = make_mesh(1, ("dp",), device=dev)
    require(mesh.device == dev, f"mesh on {mesh.device}, scene on {dev}")

    # the main path: the counts reset just before the DP frame; each
    # kernel's arguments kept
    roles = ("nearest_rays_attrs", "anyhit")
    img, launches, stores = spied_run(
        lambda: render_sharded(prep, cfg, light, mesh), roles)
    require(all(launches[r] == len(stores[r]) == 1 for r in roles)
            and all(n == 0 for r, n in launches.items() if r not in roles),
            f"{label}: the DP frame launched {launches}, not one call of "
            f"each of {roles}")
    R = cam.width * cam.height
    S = cfg.light.num_samples
    dp_near, dp_occ, dp_times = ray_walk_holds(
        *roles, stores[roles[0]][0], stores[roles[1]][0], R, S,
        ("DP K1 fetch over rays", "DP K2'"), label)
    o, d = primary_rays(cam.width, cam.height, cam.focal, device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)

    def explicit():
        rad, hit = render_flat_tiled(prep, cfg, light, None, rays=(o, d))
        return finalize_image(rad.reshape(cam.height, cam.width, 3),
                              hit.reshape(cam.height, cam.width), cfg)
    one = explicit()
    same = bool(torch.equal(img, one))
    require(same, f"{label}: the DP frame differs from the explicit-ray "
                  f"render of the same rays")
    fused = sr.render(prep, cfg, light)
    vs_fused = image_bars(img, fused, f"{label}: DP frame vs fused",
                          IMAGE_MIN, 0.98)
    bg = (img == torch.tensor(cfg.background, dtype=torch.uint8,
                              device=dev)).all(dim=-1)
    coverage = float((~bg).float().mean())
    require(0.05 < coverage < 0.99, f"{label}: coverage {coverage}")
    times = {"dp_frame_ms": host_ms(lambda: render_sharded(prep, cfg, light,
                                                           mesh),
                                    DIST_FRAMES),
             "explicit_frame_ms": host_ms(explicit, DIST_FRAMES),
             "fused_frame_ms": host_ms(lambda: sr.render(prep, cfg, light),
                                       DIST_FRAMES)}

    # one DP step over the mesh of one: the step without a mesh, bit for
    # bit, with PyTorch's deterministic algorithms (the backward's
    # index_select scatter-adds with atomics otherwise, in no fixed order)
    with torch.no_grad():
        rad, hit = sr.render_radiance(prep, cfg, light)
        target = torch.where(hit[..., None], rad, 0.0)
    start = sr.extract_params(prep.scene, light)
    start.obj_color = start.obj_color * TRAIN_COLOR
    torch.use_deterministic_algorithms(True)
    try:
        want = sr.make_train_step(prep, cfg, lr=TRAIN_LR).value_and_grad(
            start, target)
        got = sr.make_train_step(prep, cfg, mesh=mesh,
                                 lr=TRAIN_LR).value_and_grad(start, target)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    step_equal = bool(torch.equal(got[0], want[0]) and all(
        torch.equal(g, w) for g, w in zip(got[1].leaves(),
                                          want[1].leaves())))
    require(step_equal, f"{label}: the DP step over one process differs "
                        f"from the step without a mesh")

    # three composed steps, dp = gp = 1: the ring of one shard in the loss
    mesh2 = make_mesh(1, ("dp", "gp"), (1, 1), device=dev)
    cstep, cparams, _ = make_train_step_composed(scene, cfg, mesh2,
                                                 lr=TRAIN_LR)
    cparams.light_pos = light.clone()
    cparams.obj_color = cparams.obj_color * TRAIN_COLOR
    closses = []

    def steps():
        nonlocal cparams
        for _ in range(COMPOSED_STEPS):
            cparams, loss = cstep(cparams, target)
            closses.append(float(loss))
    croles = ("nearest_rays", "anyhit_pages")
    t0 = time.time()
    _, claunches, cstores = spied_run(steps, croles)
    ms_composed = (time.time() - t0) * 1e3 / COMPOSED_STEPS
    falling(closses, f"{label}: composed steps")
    require(all(claunches[r] == len(cstores[r]) == COMPOSED_STEPS
                for r in croles)
            and all(n == 0 for r, n in claunches.items() if r not in croles),
            f"{label}: the composed steps launched {claunches}, not one "
            f"call of each of {croles} a step")
    c_near, c_occ, c_times = ray_walk_holds(
        *croles, cstores[croles[0]][0], cstores[croles[1]][0], R, 1,
        ("composed K1 rays", "composed K7"), label + ", composed step 1")

    # whole frames over the mesh
    views = np.stack([orbit_view(a, 100.0, 0.0, 0.0) for a in (0.0, 60.0)])
    pf = frames_parallel(prep, cfg, views, light, mesh, axis="dp")
    frames_equal = bool(torch.equal(pf, frames_batched(prep, cfg, views,
                                                       light)))
    require(frames_equal, f"{label}: frames_parallel != frames_batched")
    emit(phase=f"distribution, one process ({label})",
         backend=torch.distributed.get_backend(), mesh=mesh.shape,
         launches=launches, coverage=coverage,
         dp_equal_explicit_every_pixel=same, dp_vs_fused=vs_fused,
         dp_step_bit_equal=step_equal, composed_losses=closses,
         composed_launches=claunches, composed_ms_per_step=ms_composed,
         frames_parallel_equal=frames_equal, **times,
         dp_kernels=dp_times, composed_kernels=c_times, gpu=gpu)
    via_dp = ("sharding.py:81-84 render_flat_tiled with no cam_spec "
              "(tiled.py:1496)")
    via_c = "train.py:226-291 the composed step's ring (dp = gp = 1)"
    return [
        entry(K1_FETCH_RAYS_NAME + " (DP slab)", "nearest.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:855", label,
              launches[roles[0]], dp_near["t_max_abs_err"],
              dp_times["nearest_ms"], dp_times["nearest_plain_ms"], dp_near,
              via=via_dp + " -> hits_attrs -> tiled_nearest_t "
                           "(tiled_t.py:1705)"),
        entry(ANYHIT_NAME + " (DP slab)", "anyhit.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:1374", label,
              launches[roles[1]], dp_occ["found_max_abs_err"],
              dp_times["anyhit_ms"], dp_times["anyhit_plain_ms"], dp_occ,
              via=via_dp + " -> tiled_shadow_fn -> tiled_anyhit_t "
                           "(tiled_t.py:1860)"),
        entry(RAYS_NAME + " (composed step's ring K1 rays walk)",
              "nearest.cu", "simple_raytracer_tpu/kernels/tiled_t.py:855",
              label, claunches[croles[0]], c_near["t_max_abs_err"],
              c_times["nearest_ms"], c_times["nearest_plain_ms"], c_near,
              via=via_c + " -> ring.py:71-93 -> tiled_nearest_t; held on "
                          "step 1"),
        entry(ANYHIT_NAME + " (composed step's ring K7, page windows)",
              "anyhit.cu", "simple_raytracer_tpu/kernels/tiled.py:905",
              label, claunches[croles[1]], c_occ["found_max_abs_err"],
              c_times["anyhit_ms"], c_times["anyhit_plain_ms"], c_occ,
              via=via_c + " -> ring.py:270-277 -> tiled_anyhit "
                          "(tiled.py:1119); held on step 1")]


def ring_phase(sr, prep, scene, cfg, light, label: str, gpu: str) -> list:
    """Phase 14 (b): the ring over RING_SHARDS geometry shards on the one
    card, through the local schedule (every home block visits every shard
    in the ring's order): the frame with the counts reset just before
    (exactly RING_SHARDS**2 K1 rays-walk calls and at most as many K7
    calls), its hit mask equal to the unsharded tiled frame's and its
    image within JAX's ring bar of it; K1's rays walk and K7 bit for bit
    with their plain versions on one (home block, shard) pair; the frame's
    time, each shard's K1 and K7 time (CUDA events, every call of the
    frame timed again), the planners' share, the shard sizes.  Returns the
    kernels-line entries."""
    import torch
    from simple_raytracer_tpu_torch.dist import ring
    from simple_raytracer_tpu_torch.kernels import table
    from simple_raytracer_tpu_torch.ops.camera import primary_rays
    from simple_raytracer_tpu_torch.render.integrator import finalize_image
    cam = cfg.camera
    dev = prep.device
    n = RING_SHARDS
    t0 = time.time()
    shards = ring.shard_geometry(scene, n, cfg, device=dev)
    torch.cuda.synchronize()
    sizes = {"real_triangles": [s.prep.num_triangles for s in shards],
             "padded_triangles": [s.prep.scene.num_triangles
                                  for s in shards],
             "blocks": [s.prep.num_blocks for s in shards],
             "seconds": round(time.time() - t0, 3)}
    emit(phase=f"ring shards ({label})", shards=n, **sizes)
    tables = ring.strip_scene_tables(scene).to(dev)
    o, d = primary_rays(cam.width, cam.height, cam.focal, device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    R = o.shape[0]
    require(R % n == 0, f"{R} rays over {n} home blocks")

    def frame():
        rad, hit = ring.render_flat_ring_local(tables, shards, cfg, o, d,
                                               light, apex=True)
        return finalize_image(rad.reshape(cam.height, cam.width, 3),
                              hit.reshape(cam.height, cam.width), cfg), hit

    # the main path: the counts reset just before the ring frame; every
    # call's arguments kept, by role, for the per-shard times
    stores = {r: [] for r in ("nearest_rays", "anyhit_pages")}
    reset_counts()
    with table.using({r: table.spy(r, stores[r]) for r in stores}):
        img, hit = frame()
    torch.cuda.synchronize()
    launches = read_counts()["launches"]
    require(launches["nearest_rays"] == n * n
            and 0 < launches["anyhit_pages"] <= n * n
            and all(c == 0 for r, c in launches.items() if r not in stores),
            f"{label}: the ring frame launched {launches}")
    rad1, hit1 = sr.render_radiance(prep, cfg, light)
    one = finalize_image(rad1, hit1, cfg)
    hit_equal = bool(torch.equal(hit.reshape(cam.height, cam.width), hit1))
    require(hit_equal, f"{label}: the ring's hit mask differs from the "
                       f"unsharded frame's")
    bars = image_bars(img, one, f"{label}: ring vs unsharded", IMAGE_MIN,
                      RING_EQUAL_MIN)

    # one (home block, shard) pair of each walk against its plain version:
    # the call with the most windows in its plan (call c of the frame is
    # home block c // n on shard (c // n + c % n) mod n)
    def busiest(calls):
        c = busiest_call(calls)
        return c, c // n, (c // n + c % n) % n
    c1, b1, s1 = busiest(stores["nearest_rays"])
    kn = stores["nearest_rays"][c1]
    m = kn[2].shape[1]
    inside = (torch.arange(kn[2].shape[0] * m, device=dev)
              < R // n).reshape(-1, m)
    k1_fn, k1_plain = table.roles()["nearest_rays"][:2]
    k7_fn, k7_plain = table.roles()["anyhit_pages"][:2]
    n_res, _kt, _ki, _w = check_nearest(
        k1_fn, k1_plain, kn, inside,
        f"ring K1 rays (home block {b1}, shard {s1})", label,
        nearest_ops(kn[2]), window_bytes(kn[1], kn[4]), 24, exact=True)
    c7, b7, s7 = busiest(stores["anyhit_pages"])
    ko = stores["anyhit_pages"][c7]
    o_res, _ = check_found(k7_fn, k7_plain, ko,
                           hit[b7 * (R // n):(b7 + 1) * (R // n)], 1,
                           f"ring K7 (home block {b7}, shard {s7})", label)

    # times: the frame, then each call of the frame again (CUDA events)
    ms_frame = host_ms(lambda: frame(), DIST_FRAMES)
    k1_calls = [cuda_ms(lambda a=a: k1_fn(*a), 3)
                for a in stores["nearest_rays"]]
    k7_calls = [cuda_ms(lambda a=a: k7_fn(*a), 3)
                for a in stores["anyhit_pages"]]
    # call j of block i ran on shard (i + j) mod n
    per_shard = {"k1_ms": [0.0] * n, "k7_ms": [0.0] * n}
    for key, calls in (("k1_ms", k1_calls), ("k7_ms", k7_calls)):
        if len(calls) == n * n:
            for c, ms in enumerate(calls):
                per_shard[key][(c // n + c % n) % n] += ms
    kern = sum(k1_calls) + sum(k7_calls)
    times = {"ms_per_frame": ms_frame, "k1_ms_frame": sum(k1_calls),
             "k7_ms_frame": sum(k7_calls), "per_shard": per_shard,
             "planners_and_rest_share": (ms_frame - kern) / ms_frame,
             "k1_pair_ms": cuda_ms(lambda: k1_fn(*kn), 10),
             "k1_pair_plain_ms": cuda_ms(lambda: k1_plain(*kn), 1),
             "k7_pair_ms": cuda_ms(lambda: k7_fn(*ko), 10),
             "k7_pair_plain_ms": cuda_ms(lambda: k7_plain(*ko), 1)}
    emit(phase=f"ring ({label})", shards=n, home_rays=R // n,
         ray_tile=RING_TILE, launches=launches, hit_mask_equal=hit_equal,
         image_vs_unsharded=bars, **times, gpu=gpu)
    return [
        entry(RAYS_NAME + " (ring K1 rays walk)", "nearest.cu",
              "simple_raytracer_tpu/kernels/tiled_t.py:855", label,
              launches["nearest_rays"], n_res["t_max_abs_err"],
              times["k1_pair_ms"], times["k1_pair_plain_ms"], n_res,
              via="ring.py:71-93 _tt.hits -> tiled_nearest_t "
                  f"(tiled_t.py:1705); held on home block {b1}, shard {s1}",
              frame_ms=times["k1_ms_frame"]),
        entry(ANYHIT_NAME + " (ring K7, page windows)", "anyhit.cu",
              "simple_raytracer_tpu/kernels/tiled.py:905", label,
              launches["anyhit_pages"], o_res["found_max_abs_err"],
              times["k7_pair_ms"], times["k7_pair_plain_ms"], o_res,
              via="ring.py:270-277 tiled_shadow_fn -> tiled_anyhit "
                  f"(tiled.py:1119); held on home block {b7}, shard {s7}",
              frame_ms=times["k7_ms_frame"])]


def dist_phase(sr, prep, scene, cfg, light, source: str, gpu: str) -> list:
    """Phase 14: the distribution layer on the shadow bench (one process
    on the card, then the 4-shard ring).  Returns the kernels-line
    entries."""
    sb = cfg.replace(camera=sr.CameraConfig(width=WIDTH, height=HEIGHT,
                                            focal=SHADOW_FOCAL))
    label = (f"shadow bench: {source}, {WIDTH}x{HEIGHT}, focal "
             f"{SHADOW_FOCAL:g}")
    import torch.distributed as dist
    try:
        entries = dp_world_of_one(sr, prep, scene, sb, light, f"DP {label}",
                                  gpu)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return entries + ring_phase(sr, prep, scene, sb, light,
                                f"ring of {RING_SHARDS} shards, {label}",
                                gpu)


@contextlib.contextmanager
def no_native():
    """``SRT_NO_NATIVE=1`` inside the block: the Python host paths."""
    os.environ["SRT_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        del os.environ["SRT_NO_NATIVE"]


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo's first processor describes it (a
    virtual machine may report its model name as "unknown": the family and
    model numbers say more), and the CPUs this process sees."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            k, _, v = line.partition(":")
            info[k.strip()] = v.strip()
    return (f"{info.get('vendor_id', platform.machine())} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')} "
            f"({info.get('model name', 'no model name')}), "
            f"{info.get('cpu MHz', '?')} MHz, {os.cpu_count()} CPUs")


def native_objects(P, T, root, d: str) -> dict:
    """Phase 15's scenes as OBJ files: {scene: [(key, path, pose, color)]}.
    The procedural meshes are written to ``d`` with ``procedural.obj_text``;
    with ``root`` the bench's are the reference's bunny and cube files."""
    def write(name, mesh):
        path = os.path.join(d, name)
        with open(path, "w") as f:
            f.write(P.obj_text(mesh))
        return path
    sphere = ("sphere", write("sphere.obj", P.icosphere(6, 0.08, seed=0)),
              P.SPHERE_POSE, (0.8, 0.7, 0.6))
    box = ("ground", write("ground.obj", P.box()), P.GROUND_POSE,
           (0.0, 1.0, 0.0))
    sphere2 = ("sphere2", write("sphere2.obj", P.icosphere(6, 0.08, seed=1)),
               P.SPHERE2_POSE, (0.6, 0.6, 0.9))
    bench = [sphere, box]
    if root is not None:
        bench = [("bunny", os.path.join(root, "obj", "stanford-bunny.obj"),
                  T.translate((0.0, -5.5, 60.0)) @ T.rotate_y(3.14159265)
                  @ T.scale(50.0, 50.0, 50.0), (0.8, 0.7, 0.6)),
                 ("ground", os.path.join(root, "cube.obj"), P.GROUND_POSE,
                  (0.0, 1.0, 0.0))]
    return {"bench": bench, "dense": [sphere, sphere2, box]}


def host_seconds(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def native_meshes(objects, leaf_size: int, gpu: str, cpu: str) -> None:
    """Phase 15 (a): each file through ``load_obj`` and its triangles
    through ``build_bvh(split="median")``, natively and on the Python
    paths: every array equal, each path's host seconds."""
    import numpy as np
    from simple_raytracer_tpu_torch.accel.bvh import build_bvh
    from simple_raytracer_tpu_torch.native import (bvh_build_native,
                                                   obj_parse_native)
    from simple_raytracer_tpu_torch.scene.obj_loader import load_obj
    for key, path, _, _ in objects:
        # load_obj and build_bvh fall back to Python quietly where the
        # native code defers: here it must run
        require(obj_parse_native(path) is not None,
                f"the native scan defers on {key} ({path})")
        mesh, load_s = host_seconds(lambda: load_obj(path))
        with no_native():
            pmesh, pload_s = host_seconds(lambda: load_obj(path))
        for f in ("verts", "normals", "uvs", "tri_color", "tri_tex"):
            a, b = getattr(mesh, f), getattr(pmesh, f)
            require(a.dtype == b.dtype and np.array_equal(a, b),
                    f"native load_obj {key}: {f} differs")
        require(mesh.textures == pmesh.textures,
                f"native load_obj {key}: textures differ")
        tris = mesh.verts[..., :3]
        require(bvh_build_native(tris, leaf_size) is not None,
                f"the native BVH build defers on {key}")
        bvh, bvh_s = host_seconds(lambda: build_bvh(tris, leaf_size))
        pbvh, pbvh_s = host_seconds(
            lambda: build_bvh(tris, leaf_size, use_native=False))
        for f in ("node_min", "node_max", "skip", "leaf_first", "leaf_count",
                  "perm"):
            a, b = getattr(bvh, f), getattr(pbvh, f)
            require(a.dtype == b.dtype and np.array_equal(a, b),
                    f"native build_bvh {key}: {f} differs")
        require((bvh.max_leaf, bvh.depth) == (pbvh.max_leaf, pbvh.depth),
                f"native build_bvh {key}: max_leaf or depth differs")
        emit(phase=f"native vs python ({key})", file=os.path.basename(path),
             triangles=mesh.num_triangles, bvh_nodes=int(bvh.skip.shape[0]),
             load_obj_native_s=load_s, load_obj_python_s=pload_s,
             build_bvh_native_s=bvh_s, build_bvh_python_s=pbvh_s,
             equal=True, host_cpu=cpu, gpu=gpu,
             note="host seconds on the card's machine, one run each")


def native_kernels(prep, cfg, light, branch: str, label: str) -> None:
    """Phase 15 (b): the frame's two kernels against their plain versions
    on the arguments the frame gives them from the natively prepared scene
    (the median BVH's blocks and plans): K1 and K2 as phase 3 holds them
    (the fused branch), or K1 and K2′ as phase 6 does (the legacy one)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import anyhit, nearest
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.ops.camera import primary_rays_tiled
    cam = cfg.camera
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    cam_spec = (None, cam.focal, cam.width, cam.height, tpx)
    if branch == "fused":
        compare_kernels(prep, cfg, light, cam_spec, label, time_it=False)
        return
    o, d, _, _ = primary_rays_tiled(cam.width, cam.height, tpx, cam.focal,
                                    cam.normalize_dirs, device=prep.device)
    args = frame_args(prep, cfg, light, cam_spec,
                      (o.reshape(-1, 3), d.reshape(-1, 3)))
    k1, k2r = args["nearest_shaded"], args["anyhit"]
    size = (cam.width, cam.height)
    check_k1_shaded(k1, label, size, sweep=False)
    kt = nearest.tiled_nearest_shaded(*k1)[0]
    inside = frame_lanes(k1[0][:, 4], k1[0][:, 5], tpx, *size)
    _, walk = check_found(anyhit.tiled_anyhit, anyhit.tiled_anyhit_plain,
                          k2r, torch.isfinite(kt) & inside,
                          cfg.light.num_samples, "K2'", label)
    rays_schedule(k2r, label, walk, "K2'", occlusion=True, sweep=False)


def native_frame(sr, objects, cfg, light, label: str, gpu: str,
                 cpu: str) -> None:
    """Phase 15 (c): the scene loaded and prepared on the card with the
    median split, natively and on the Python paths; the natively prepared
    frame's kernels held to their plain versions; the bench frame rendered
    through ``render`` from each: equal on every pixel, the frame's
    branch's two kernels launched and no other."""
    import torch
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.kernels.tiled import frame_branch

    def scene_from_files():
        sm = sr.SceneManager()
        for key, path, pose, color in objects:
            sm.load_obj_file(path, key=key)
            sm.set_color(key, color)
            sm.transform_triangles(key, pose)
        return sm.build()

    def prepared():
        scene, load_s = host_seconds(scene_from_files)
        prep, prep_s = host_seconds(lambda: prepare(scene, cfg, device=dev))
        return prep, load_s, prep_s

    dev = light.device
    prep, load_s, prep_s = prepared()
    with no_native():
        pprep, pload_s, pprep_s = prepared()
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    branch = frame_branch(prep, cfg, tpx * tpx)
    roles = NATIVE_ROLES[branch]
    native_kernels(prep, cfg, light, branch, label)
    reset_counts()
    img = sr.render(prep, cfg, light)
    torch.cuda.synchronize()
    counts = read_counts()
    launches, plans = counts["launches"], counts["plans"]
    shading = counts["shading"]
    require(all(launches[r] > 0 for r in roles)
            and all(n == 0 for r, n in launches.items() if r not in roles),
            f"{label} launched {launches}, not exactly {roles}")
    require(shading == SHADING_BY_BRANCH[branch],
            f"{label}: the {branch} frame shaded {shading}, not "
            f"{SHADING_BY_BRANCH[branch]}")
    pimg = sr.render(pprep, cfg, light)
    require(tuple(img.shape) == (cfg.camera.height, cfg.camera.width, 3)
            and torch.equal(img, pimg),
            f"{label}: the native and the Python paths' frames differ")
    bg = (img == torch.tensor(cfg.background, dtype=torch.uint8,
                              device=dev)).all(dim=-1)
    coverage = float((~bg).float().mean())
    require(0.05 < coverage < 0.99, f"{label}: coverage {coverage}")
    emit(phase=f"render ({label})", branch=branch, launches=launches,
         plans=plans, shading=shading, coverage=coverage,
         image_equal_to_python_paths=True,
         triangles=prep.num_triangles, load_native_s=load_s,
         load_python_s=pload_s, prepare_native_s=prep_s,
         prepare_python_s=pprep_s, host_cpu=cpu, gpu=gpu,
         note="host seconds on the card's machine, one run each")


def native_phase(sr, root, light, gpu: str) -> None:
    """Phase 15: the native host code on the card's host (see the module
    docstring)."""
    import tempfile
    from simple_raytracer_tpu_torch.native import build as native_build
    from simple_raytracer_tpu_torch.native import native_available
    from simple_raytracer_tpu_torch.scene import procedural as P
    from simple_raytracer_tpu_torch.scene import transforms as T
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    b = native_build.build()
    cpu = cpu_model()
    emit(phase="native build", gxx=gxx, seconds=b["seconds"],
         cached=b["cached"], library=os.path.relpath(b["path"], HERE),
         host_cpu=cpu)
    require(native_available(), "the native library does not load")
    cfg = sr.default_config().replace(
        mode="tiled",
        camera=sr.CameraConfig(width=WIDTH, height=HEIGHT,
                               focal=P.bench_focal(HEIGHT)),
        light=sr.LightConfig(enable_shadows=True))
    require(cfg.bvh.split == "median", "the default split is not median")
    with tempfile.TemporaryDirectory() as d:
        scenes = native_objects(P, T, root, d)
        meshes = {o[1]: o for objs in scenes.values() for o in objs}
        native_meshes(meshes.values(), cfg.bvh.leaf_size, gpu, cpu)
        for name, objects in scenes.items():
            native_frame(sr, objects, cfg, light,
                         f"native {name}: {', '.join(o[0] for o in objects)}"
                         f", median split, {WIDTH}x{HEIGHT}", gpu, cpu)


def planner_bound(prep, n: int, wb: int, plan, apex: bool,
                  excl: bool, hourglass: bool = False) -> dict:
    """The least time of one plan: its (tile, block) tests at
    OPS_PLAN_PAIR (OPS_PLAN_HOURGLASS for the hourglass test; + the apex
    and excl terms) f32 operations and, with an apex test, each block's
    rect, at 67 TFLOP/s; against the block tables and the tile bounds read
    once and the plan written once."""
    pairs = n * prep.num_blocks
    test = OPS_PLAN_HOURGLASS if hourglass else OPS_PLAN_PAIR
    ops = pairs * (test + OPS_PLAN_APEX * apex + OPS_PLAN_EXCL * excl)
    ops += prep.num_blocks * OPS_PLAN_BLOCK * apex
    moved = (nbytes(prep.block_min, prep.block_max, plan)
             + prep.block_obj.numel() * 4 * excl + n * (12 + 4 * apex) * 4)
    t_ops = ops / F32_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": pairs, "f32_ops": ops, "bytes": moved}


def bounds_bound(role: str, args, out) -> dict:
    """The least time of one call of a bounds role on ``args`` (its
    result ``out``): its f32 operations at 67 TFLOP/s against its inputs
    read and its results written once (views of the camera row not
    counted twice)."""
    if role == "camera":
        prep, _spec, light = args
        ops = prep.num_blocks * OPS_CAMERA_BLOCK if light is not None else 0
        moved = nbytes(out) + (nbytes(prep.block_min, prep.block_max)
                               if light is not None else 0)
    elif role == "tile_bounds":
        cam, _spec, n = args
        ops = 4 * n * OPS_BOUNDS_CORNER
        moved = nbytes(cam) + nbytes(*(out[k] for k in (
            "s", "v", "w", "dmin", "dmax", "ru_lo", "ru_hi", "rv_lo",
            "rv_hi", "tile_bad", "dw_hi")))
    else:
        rows, cam = args
        ops = rows.shape[0] * OPS_SHADOW_TILE
        moved = nbytes(rows, cam) + nbytes(*(out[k] for k in (
            "omin", "omax", "dmin", "dmax", "ru_lo", "ru_hi", "rv_lo",
            "rv_hi", "live", "excl")))
    t_ops = ops / F32_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "f32_ops": ops, "bytes": moved}


def bounds_equal(got, want) -> bool:
    """A bounds role's results (a tensor or a dict of them) equal."""
    import torch
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            torch.equal(got[k], want[k]) for k in want)
    return torch.equal(got, want)


def bounds_timing(label: str, stores, gpu: str) -> list:
    """Phase 16's bounds: each call of the frame's bounds roles
    (``stores``, by role) on the card against its plain twin (equal to
    the bit), timed alone (``queued_ms``), in its call (CUDA events), and
    the twin's call, with its bound (:func:`bounds_bound`)."""
    from simple_raytracer_tpu_torch.kernels import table
    entries = []
    for role, calls in stores.items():
        e = table.roles()[role]
        for a in calls:
            reset_counts()
            got = e.cuda(*a)
            launches = table.launches()[role]
            want = e.plain(*a)
            require(bounds_equal(got, want),
                    f"bounds vs plain ({label}, {role}): not equal")
            require(launches == 1, f"bounds ({label}, {role}): {launches} "
                    "launches a call, not 1")
            card_ms, host_ms = queued_ms(lambda: e.cuda(*a), PLAN_REPS)
            call_ms = cuda_ms(lambda: e.cuda(*a), PLAN_REPS)
            plain_ms = cuda_ms(lambda: e.plain(*a), PLAN_REPS // 10)
            plain_card_ms, plain_host_ms = queued_ms(lambda: e.plain(*a),
                                                     PLAN_REPS // 10)
            bnd = bounds_bound(role, a, got)
            frame = f"{label}: {role}"
            entries.append(entry(
                BOUNDS_KERNELS[role], "plan.cu",
                "none: the bounds are jnp in the JAX package "
                "(tiled_t.py::make_cam, analytic_tile_bounds, shadow_frame, "
                "analytic_shadow_bounds_exact)", frame, launches, 0.0, card_ms,
                plain_ms, bnd, call_ms=call_ms, host_ms=host_ms))
            emit(phase=f"bounds vs plain ({frame})", equal=True,
                 launches=launches,
                 tiles=(a[2] if role == "tile_bounds" else
                        a[0].shape[0] if role == "shadow_bounds" else 0),
                 card_ms=card_ms, host_ms=host_ms, call_ms=call_ms,
                 plain_ms=plain_ms, plain_card_ms=plain_card_ms,
                 plain_host_ms=plain_host_ms, gpu=gpu, **bnd,
                 share=bnd["bound_ms"] / card_ms)
    return entries


def planner_phase(sr, frames, light, gpu: str) -> list:
    """Phase 16: the planner kernel on every plan of one frame of each of
    ``frames`` ({label: (prep, cfg)}), held to the plain planner on every
    word and timed (see the module's docstring)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import plan as pl, table
    from simple_raytracer_tpu_torch.utils import metrics
    entries = []
    for label, (prep, cfg) in frames.items():
        calls = []
        stores = {r: [] for r in BOUNDS_KERNELS}
        real = pl.cull

        def spy(*a, **k):
            calls.append((a, k))
            return real(*a, **k)
        pl.cull = spy
        try:
            with table.using({r: table.spy(r, stores[r])
                              for r in BOUNDS_KERNELS}):
                sr.render(prep, cfg, light)
        finally:
            pl.cull = real
        reset_counts()
        img = sr.render(prep, cfg, light)
        torch.cuda.synchronize()
        plans = read_counts()["plans"]
        hourglasses = sum(bool(k.get("hourglass")) for _, k in calls)
        require(plans["card"] == 2 and plans["plain"] == 0
                and plans["hourglass"] == hourglasses,
                f"{label}: {plans} plans a frame, not 2 on the card "
                f"({hourglasses} of the hourglass test)")
        require(len(calls) == 2, f"{label}: {len(calls)} plans a frame")
        bounds = {r: (table.calls()[r], table.calls(twin=True)[r],
                      table.launches()[r]) for r in BOUNDS_KERNELS}
        require(all(b == (len(stores[r]), 0, len(stores[r]))
                    for r, b in bounds.items())
                and len(stores["camera"]) == len(stores["tile_bounds"]) == 1,
                f"{label}: the bounds a frame (card, plain, launches) "
                f"{bounds}, calls {({r: len(c) for r, c in stores.items()})}")
        with table.using({"plan": pl.cull_plain,
                          **{r: table.roles()[r].plain
                             for r in BOUNDS_KERNELS}}):
            ref = sr.render(prep, cfg, light)
        require(torch.equal(img, ref),
                f"{label}: the frame differs from the plain planner's on "
                f"{int((img != ref).any(-1).sum())} pixels")
        for a, k in calls:
            prep_, maxv, wb, ab = a[:4]
            apex, rev = bool(k.get("apex")), bool(k.get("apex_rev"))
            excl = k.get("excl") is not None
            hourglass = bool(k.get("hourglass"))
            what = ("primary" if apex else "hard shadow" if rev
                    else "hourglass fold" if hourglass else "fold")
            reset_counts()
            got = pl.cull(*a, **k)
            launches = metrics.counts()["plan.cull_cuda.launches"]
            want = pl.cull_plain(*a, **k)
            require(torch.equal(got, want),
                    f"planner vs plain ({label}, {what}): "
                    f"{int((got != want).sum())} words differ")
            n = int(ab["omin"].shape[0])
            card_ms, host_ms = queued_ms(lambda: pl.cull(*a, **k), PLAN_REPS)
            call_ms = cuda_ms(lambda: pl.cull(*a, **k), PLAN_REPS)
            plain_ms = cuda_ms(lambda: pl.cull_plain(*a, **k), PLAN_REPS // 10)
            plain_card_ms, plain_host_ms = queued_ms(
                lambda: pl.cull_plain(*a, **k), PLAN_REPS // 10)
            bnd = planner_bound(prep_, n, wb, want, apex or rev, excl,
                                hourglass)
            frame = f"{label}: {what} plan"
            entries.append(entry(
                PLAN_HOURGLASS_NAME if hourglass else PLAN_NAME, "plan.cu",
                "none: plans are jnp in the JAX package (tiled_t.py::cull, "
                "cull_occl)", frame, launches, 0.0, card_ms,
                plain_ms, bnd, call_ms=call_ms, host_ms=host_ms))
            emit(phase=f"planner vs plain ({frame})", equal=True,
                 image_equal_to_plain_planner=True,
                 launches=launches, frame_plans=plans, tiles=n,
                 blocks=prep_.num_blocks, windows=prep_.num_blocks // wb,
                 plan_w=int(want.shape[1]),
                 listed_entries=int(want[:, 2].sum()),
                 range_rows=int(((want[:, 3] == 0) & (want[:, 1] > 0))
                                .sum()),
                 card_ms=card_ms, host_ms=host_ms, call_ms=call_ms,
                 plain_ms=plain_ms, plain_card_ms=plain_card_ms,
                 plain_host_ms=plain_host_ms, gpu=gpu, **bnd,
                 share=bnd["bound_ms"] / card_ms)
        entries += bounds_timing(label, stores, gpu)
    return entries


def shade_bound(scene, cfg, args) -> dict:
    """The least time of the shading kernel's work on ``args`` (those of
    ``shade_launch``): the bytes it must move at 3.35 TB/s, each once: every
    ray's SHADE_RAY_BYTES and its S shadow flags, the rows of the distinct
    hit triangles, the distinct texels the textured hits read, the light
    samples."""
    import torch
    from simple_raytracer_tpu_torch.ops import shading as sh
    from simple_raytracer_tpu_torch.render import integrator
    _, _, o, d, t, idx, samples, found = args
    R, S = o.shape[0], samples.shape[0]
    hit = torch.isfinite(t)
    tris = torch.unique(idx[hit].long())
    smooth = bool(cfg.shading.smooth_normals)
    textured = bool(scene.has_textures)
    row = 48 + (36 if smooth else 12) + 4 + (24 + 4 if textured else 0)
    texels = 0
    if textured:
        rec = integrator.gather_hit_records(scene, idx[hit], cfg)
        point = o[hit] + t[hit][:, None] * d[hit]
        uv = sh.interpolate_uv(rec["uvs"], sh.barycentric(rec["tri_v"],
                                                          point))
        tid = rec["tex_id"].clamp_min(0).long()
        w, h = scene.tex_width[tid].long(), scene.tex_height[tid].long()
        x = torch.minimum(uv[:, 0].to(torch.int32).long().clamp_min(0),
                          w - 1)
        y = torch.minimum(uv[:, 1].to(torch.int32).long().clamp_min(0),
                          h - 1)
        lin = scene.tex_offset[tid].long() + y * w + x
        texels = int(torch.unique(lin[rec["tex_id"] >= 0]).numel())
    moved = (R * (SHADE_RAY_BYTES + (S if found is not None else 0))
             + int(tris.numel()) * row + texels * SHADE_TEXEL_BYTES
             + S * 12)
    return {"bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": moved, "rays": R, "hit_rays": int(hit.sum()),
            "distinct_triangles": int(tris.numel()), "texels": texels}


def shade_phase(sr, frames, light, gpu: str) -> list:
    """Phase 17: the shading kernel on one frame of each of ``frames``
    ({label: (prep, cfg)}), held to the plain integrator and timed (see the
    module's docstring)."""
    import torch
    from simple_raytracer_tpu_torch.kernels import table
    from simple_raytracer_tpu_torch.render import integrator
    entries = []
    for label, (prep, cfg) in frames.items():
        launches = []
        real = integrator.shade_launch

        def spy(*a):
            launches.append(a)
            return real(*a)
        integrator.shade_launch = spy
        try:
            sr.render(prep, cfg, light)
        finally:
            integrator.shade_launch = real
        require(len(launches) == 1, f"{label}: {len(launches)} shading "
                                    f"launches a frame")
        args = launches[0]
        reset_counts()
        img = sr.render(prep, cfg, light)
        torch.cuda.synchronize()
        shading = read_counts()["shading"]
        counts = {"shade_cuda.calls": shading["cuda"],
                  "shade_cuda.launches": shading["launches"],
                  "shade_plain.calls": shading["plain"]}
        require(list(counts.values()) == [1, 1, 0],
                f"{label}: {counts} in one frame, not one CUDA call and "
                f"launch")
        rad, rad_hit = sr.render_radiance(prep, cfg, light)
        with table.using({"shade": integrator.shade_plain}):
            ref = sr.render(prep, cfg, light)
            ref_rad, ref_hit = sr.render_radiance(prep, cfg, light)
        require(torch.equal(img, ref),
                f"{label}: the frame differs from the plain integrator's on "
                f"{int((img != ref).any(-1).sum())} pixels")
        require(torch.equal(rad_hit, ref_hit),
                f"{label}: the hit masks differ between the routes")
        rad_bits = int((rad[rad_hit].contiguous().view(torch.int32)
                        != ref_rad[rad_hit].contiguous().view(torch.int32))
                       .sum())
        require(rad_bits == 0,
                f"{label}: the radiance of {rad_bits} channels of hit "
                f"pixels differs from the plain route's")
        scene, cfg_, o, d, t, idx, samples, found = args
        flags = (None if found is None else
                 lambda *a, **k: found.reshape(-1))
        got = integrator.shade_launch(*args)
        want = integrator.shade_plain(scene, cfg_, o, d, t, idx, light,
                                      flags)
        hit = torch.isfinite(t)
        require(torch.equal(got[hit], want[hit]),
                f"{label}: kernel vs plain integrator: "
                f"{int((got[hit] != want[hit]).any(-1).sum())} hit rays "
                f"differ")
        card_ms, host_ms = queued_ms(lambda: integrator.shade_launch(*args),
                                     SHADE_REPS)
        call_ms = cuda_ms(lambda: integrator.shade_launch(*args), SHADE_REPS)
        plain_ms = cuda_ms(lambda: integrator.shade_plain(
            scene, cfg_, o, d, t, idx, light, flags), SHADE_REPS // 10)
        plain_card_ms, plain_host_ms = queued_ms(
            lambda: integrator.shade_plain(scene, cfg_, o, d, t, idx, light,
                                           flags), SHADE_REPS // 10)
        bnd = shade_bound(scene, cfg_, args)
        entries.append(entry(
            SHADE_NAME, "shade.cu",
            "none: the JAX package shades in jnp (render/integrator.py::"
            "shade_records)", label, counts["shade_cuda.launches"], 0.0,
            card_ms, plain_ms, bnd,
            call_ms=call_ms, host_ms=host_ms))
        emit(phase=f"shading kernel vs plain ({label})", equal=True,
             image_equal_to_plain=True, hit_radiance_bits_differing=rad_bits,
             counts_in_one_frame=counts, samples=int(samples.shape[0]),
             shadow=found is not None, card_ms=card_ms, host_ms=host_ms,
             call_ms=call_ms, plain_ms=plain_ms, plain_card_ms=plain_card_ms,
             plain_host_ms=plain_host_ms, gpu=gpu, **bnd,
             share=bnd["bound_ms"] / card_ms)
    return entries


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="the reference's asset directory (renders the "
                         "Stanford bunny instead of the procedural mesh)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "simple_raytracer_tpu_torch")):
        print(f"chip_smoke: no simple_raytracer_tpu_torch/ in {HERE}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import simple_raytracer_tpu_torch as sr
    from simple_raytracer_tpu_torch.accel.prepared import prepare
    from simple_raytracer_tpu_torch.kernels import build
    from simple_raytracer_tpu_torch.kernels import plan as pl
    from simple_raytracer_tpu_torch.scene import procedural as P
    require("jax" not in sys.modules, "the port imported jax")

    # 1. device and toolchain
    gpu = gpu_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit(phase="device", gpu=gpu, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         device=torch.cuda.get_device_name(0))
    dev = torch.device("cuda", 0)

    # 2. build
    b = build.build()
    ptxas = [ln.strip() for ln in b["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit(phase="build", seconds=round(b["seconds"], 3), cached=b["cached"],
         libraries=[os.path.relpath(p, HERE) for p in b["paths"]],
         ptxas=ptxas)
    build.library()

    # scene: the bench frame
    t0 = time.time()
    scene, source = bench_scene(sr, args.root)
    focal = P.bench_focal(HEIGHT)
    cfg = sr.default_config().replace(
        mode="tiled",
        camera=sr.CameraConfig(width=WIDTH, height=HEIGHT, focal=focal),
        light=sr.LightConfig(enable_shadows=True),
        bvh=sr.BVHConfig(split="sah"))
    prep = prepare(scene, cfg, device=dev)
    torch.cuda.synchronize()
    emit(phase="scene", source=source, triangles=prep.num_triangles,
         padded_triangles=prep.scene.num_triangles, blocks=prep.num_blocks,
         seconds=round(time.time() - t0, 3))
    light = torch.tensor(P.BENCH_LIGHT, dtype=torch.float32, device=dev)

    # 3-5. the bench frame: K1 and K2 vs their plain versions, the frame
    # through the public entry points, timed view-varied frames, and where
    # a frame's time goes (each stage alone, CUDA events)
    bench = f"bench: {source}, {WIDTH}x{HEIGHT}"
    entries, _ = fused_frame(sr, prep, cfg, light, bench, gpu, FRAMES)
    # 3. K1 and K2 on a small scene whose shadow falls in view
    small = sr.default_config().replace(
        mode="tiled", camera=sr.CameraConfig(width=128, height=128,
                                             focal=400.0),
        bvh=sr.BVHConfig(split="sah"))
    small_prep = prepare(P.sphere_on_ground(sr.SceneManager(), 3).build(),
                         small, device=dev)
    _s1, s2, _ = compare_kernels(
        small_prep, small, light,
        (None, 400.0, 128, 128,
         pl.effective_tile_px(small, small_prep.scene.num_triangles)),
        "icosphere(3) + box ground, 128x128", time_it=False)
    require(s2["shadowed_rays"] > 50, "no shadow in the small scene")
    # 3-5 again on the shadow bench: the bench's scene at the reference's
    # field of view, its shadow in view
    shadow_bench = (f"shadow bench: {source}, {WIDTH}x{HEIGHT}, focal "
                    f"{SHADOW_FOCAL:g}")
    sb_entries, sb_k2 = fused_frame(
        sr, prep, cfg.replace(camera=sr.CameraConfig(
            width=WIDTH, height=HEIGHT, focal=SHADOW_FOCAL)), light,
        shadow_bench, gpu, FRAMES)
    require(sb_k2["shadowed_hit_lanes"] > SHADOWED_MIN
            and sb_k2["plan"]["empty_tiles"] < sb_k2["plan"]["tiles"],
            f"the shadow bench's shadow is not in view: "
            f"{sb_k2['shadowed_hit_lanes']} shadowed hit lanes")
    entries += sb_entries

    # 6. the soft-shadow and the dense frames
    occ_cam = sr.CameraConfig(width=OCC_WIDTH, height=OCC_HEIGHT,
                              focal=OCC_FOCAL)
    soft = cfg.replace(camera=occ_cam,
                       light=sr.LightConfig(num_samples=SOFT_SAMPLES))
    entries += occlusion_frame(
        sr, prep, soft, light,
        f"soft: {source}, {OCC_WIDTH}x{OCC_HEIGHT}, S={SOFT_SAMPLES}", gpu)
    t0 = time.time()
    dense = cfg.replace(camera=occ_cam)
    dense_prep = prepare(P.dense_on_ground(sr.SceneManager()).build(),
                         dense, device=dev)
    torch.cuda.synchronize()
    emit(phase="scene (dense)", source="procedural dense_on_ground",
         triangles=dense_prep.num_triangles, blocks=dense_prep.num_blocks,
         seconds=round(time.time() - t0, 3))
    dense_label = (f"dense: procedural, {dense_prep.num_triangles} "
                   f"triangles, {OCC_WIDTH}x{OCC_HEIGHT}")
    entries += occlusion_frame(sr, dense_prep, dense, light, dense_label,
                               gpu)

    # 7. the paged frames
    entries += paged_frame(sr, prep, cfg.replace(tiled_impl="paged"), light,
                           f"paged {bench}", gpu, FRAMES)
    t0 = time.time()
    tex = cfg.replace(camera=occ_cam, tiled_impl="paged",
                      light=sr.LightConfig(num_samples=SOFT_SAMPLES),
                      shading=sr.ShadingConfig(smooth_normals=True))
    tex_prep = prepare(P.textured_on_ground(sr.SceneManager(), 6).build(),
                       tex, device=dev)
    torch.cuda.synchronize()
    emit(phase="scene (textured)", source="procedural textured_on_ground(6)",
         triangles=tex_prep.num_triangles, pages=tex_prep.num_pages,
         seconds=round(time.time() - t0, 3))
    entries += paged_frame(
        sr, tex_prep, tex, light,
        f"paged textured: procedural, smooth normals, {OCC_WIDTH}x"
        f"{OCC_HEIGHT}, S={SOFT_SAMPLES}", gpu, OCC_FRAMES,
        SHADOWED_MIN)
    entries += paged_frame(sr, dense_prep, dense.replace(tiled_impl="paged"),
                           light, f"paged {dense_label}", gpu, OCC_FRAMES,
                           SHADOWED_MIN)

    # 8. the sublane gather frames
    gtex = tex.replace(tiled_impl=None)
    tex_label = (f"procedural textured_on_ground(6), smooth normals, "
                 f"{OCC_WIDTH}x{OCC_HEIGHT}, S={SOFT_SAMPLES}")
    entries += gather_frame(sr, tex_prep, gtex, light,
                            f"gather textured: {tex_label}", gpu, OCC_FRAMES,
                            SHADOWED_MIN)
    entries += gather_frame(
        sr, tex_prep, gtex.replace(kernel=sr.KernelConfig(
            groups=GROUPS, groups_ah=GROUPS)), light,
        f"gather grouped (G={GROUPS}): {tex_label}", gpu, OCC_FRAMES,
        SHADOWED_MIN)
    entries += gather_frame(
        sr, prep, cfg.replace(kernel=sr.KernelConfig(prepass=True)), light,
        f"prepass {bench}", gpu, FRAMES)

    # 9. one-sample textured and smooth-normal frames: K1's textured and
    # smooth modes, then the fused shadow (K2) or the legacy one (K2′)
    entries += mode_frame(
        sr, tex_prep, cfg, light,
        f"textured bench: procedural textured_on_ground(6), flat, {WIDTH}x"
        f"{HEIGHT}", gpu, FRAMES)
    t0 = time.time()
    smooth = cfg.replace(shading=sr.ShadingConfig(smooth_normals=True))
    smooth_prep = prepare(P.smooth_on_ground(sr.SceneManager(), 6).build(),
                          smooth, device=dev)
    torch.cuda.synchronize()
    emit(phase="scene (smooth)", source="procedural smooth_on_ground(6)",
         triangles=smooth_prep.num_triangles,
         seconds=round(time.time() - t0, 3))
    entries += mode_frame(
        sr, smooth_prep, smooth, light,
        f"smooth bench: procedural smooth_on_ground(6), smooth normals, "
        f"{WIDTH}x{HEIGHT}", gpu, FRAMES)
    t0 = time.time()
    cprep, ccfg, clight, cview, cviews, clabel = complex_frames(
        sr, args.root, dev)
    torch.cuda.synchronize()
    emit(phase="scene (complex)", source=clabel,
         triangles=cprep.num_triangles, blocks=cprep.num_blocks,
         seconds=round(time.time() - t0, 3))
    entries += mode_frame(sr, cprep, ccfg, clight, clabel, gpu, OCC_FRAMES,
                          cview, cviews, SHADOWED_MIN, TEXTURED_MIN)

    # 10. the probes: K1's fixed-cost parts and the winner fetch
    entries += probe_phase(prep, cfg, light, f"probes on the {bench}", gpu)

    # 11. the plain PyTorch modes (bruteforce, BVH) and the command line
    plain_mode_phase(sr, prep, cfg, light, gpu)

    # 12. training: the train bench, the CLI's train and the texture fit
    entries += train_phase(sr, prep, light, args.root, gpu)

    # 13. the tiled configurations over explicit rays or range-only plans
    entries += config_phase(sr, prep, cfg, light, source, gpu)

    # 14. distribution: a one-process NCCL group, the ring of 4 shards
    entries += dist_phase(sr, prep, scene, cfg, light, source, gpu)

    # 15. the native host code: the C++ OBJ scan and median BVH build
    native_phase(sr, args.root, light, gpu)

    # 16. the planner kernels on the bench, shadow bench, soft and dense
    # soft plans
    t0 = time.time()
    dsoft = sr.default_config().replace(
        mode="tiled", camera=occ_cam,
        light=sr.LightConfig(num_samples=SOFT_SAMPLES))
    dsoft_prep = prepare(P.dense_textured_on_ground(sr.SceneManager())
                         .build(), dsoft, device=dev)
    torch.cuda.synchronize()
    emit(phase="scene (dense soft)",
         source="procedural dense_textured_on_ground, median BVH",
         triangles=dsoft_prep.num_triangles, blocks=dsoft_prep.num_blocks,
         hourglass=pl.hourglass_for(dsoft_prep),
         seconds=round(time.time() - t0, 3))
    entries += planner_phase(sr, {
        "bench": (prep, cfg),
        "shadow bench": (prep, cfg.replace(camera=sr.CameraConfig(
            width=WIDTH, height=HEIGHT, focal=SHADOW_FOCAL))),
        "soft": (prep, soft),
        f"dense soft: procedural, {dsoft_prep.num_triangles} triangles, "
        f"{OCC_WIDTH}x{OCC_HEIGHT}, S={SOFT_SAMPLES}": (dsoft_prep, dsoft)},
        light, gpu)

    # 17. the shading kernel on the two soft scenes
    entries += shade_phase(sr, {
        f"gather textured: {tex_label}": (tex_prep, gtex),
        f"dense soft: procedural, {dsoft_prep.num_triangles} triangles, "
        f"{OCC_WIDTH}x{OCC_HEIGHT}, S={SOFT_SAMPLES}": (dsoft_prep, dsoft)},
        light, gpu)

    print(json.dumps({"kernels": entries}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
