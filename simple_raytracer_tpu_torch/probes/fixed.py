"""The fixed-cost probes of K1 (``csrc/probe_fixed.cu``).

Counterparts of the JAX package's TPU probes ``scripts/fixed_probe.py``,
``fixed_probe2.py`` and ``fixed_probe3.py``, which split the nearest
kernel's per-ray fixed cost into its parts.  Each variant of
``fixed_probe_kernel`` is one part; each computes, per lane of each tile
(F10 = [dx, dy, dz, o x d, ox, oy, oz, 1], JAX ``tiled_t._build_feats``):

====== ============================ ======================= ===========
name   rays                         t (and idx)             store, grid
====== ============================ ======================= ===========
io     read o                       ox + 1                  tile-major
feat   read o, d                    the sum of F10's rows   tile-major
feat3  read d (one shared origin)   dx + dy + dz            tile-major
acc    read o, d                    the least row of F10,   tile-major
                                    idx its lowest id (K1's
                                    best-hit keep)
noin   rebuilt from the pixel       rows 0, 3, 6, 9 summed  tile-major
noout  read o                       ox + 1                  image order
none   rebuilt                      dx + 1                  image order
none2  rebuilt                      dx + 1, idx = tile      image order
feat_i rebuilt                      the sum of F10, idx =   image order
                                    tile
empty  none                         lane + a + tile, only   block 0 only
                                    block 0 stores
write  none                         lane + a + tile         tile-major
grid1  none                         lane + a + tile         persistent
grid1f rebuilt                      the sum of F10          persistent
====== ============================ ======================= ===========

Sums start from 0 and add the rows in order.  Rebuilt rays are K1's
(``srt::ray_dir``: the camera constants and the tile's pixel origin);
"image order" stores each lane at its pixel's place in the [H, W] image
(the untile folded into the store); "persistent" runs one block per SM,
each striding over the tiles, where the others run one block per tile.
``fixed_probe.py``'s fifth probe, ``win_body`` (one window's test and its
epilogue), is K1 itself: :func:`k1_points` cuts the frame's plan to each
tile's first entry, and to none (K1's fixed part with its real epilogue).

The TPU probes walked the 1080p primary stream ray-major, in 507 steps of
4096 rays (``tiled_t.ray_tile_od``).  On the card they walk K1's own tiles:
64x64 pixels, tile-major, 510 tiles of the 1920x1080 frame (2,088,960
lanes), at K1's threads and rays per thread, so that each variant measures a
part of K1.  ``fixed_probe2.py``'s ``base_kern`` and ``fixed_probe.py``'s
``io_body`` are one body; here both are the ``io`` instance.

Run on a card (the scripts' arguments; the frame is the bench frame)::

    python -m simple_raytracer_tpu_torch.probes.fixed [--tile 4096] [--frames 8]
"""

from __future__ import annotations

import argparse
import math

import torch

from ..kernels import build, nearest, table
from ..kernels import plan as pl
from ..ops.camera import primary_rays_tiled, tile_ray_dirs, untile_image
from ..utils.metrics import count
from . import device_ms, line, record, require_cuda

# the kernel's variants, in the order of csrc/probe_fixed.cu's Variant
VARIANTS = ("io", "feat", "feat3", "acc", "noin", "noout", "none", "none2",
            "feat_i", "empty", "write", "grid1", "grid1f")
# per variant: rays ("o", "d", "od" read, "cam" rebuilt, None), the value,
# the idx output (None, "argmin", "tile"), image-order store
SPECS = {"io": ("o", "ox1", None, False),
         "feat": ("od", "sum", None, False),
         "feat3": ("d", "dir", None, False),
         "acc": ("od", "keep", "argmin", False),
         "noin": ("cam", "0369", None, False),
         "noout": ("o", "ox1", None, True),
         "none": ("cam", "dx1", None, True),
         "none2": ("cam", "dx1", "tile", True),
         "feat_i": ("cam", "sum", "tile", True),
         "empty": (None, "row", None, False),
         "write": (None, "row", None, False),
         "grid1": (None, "row", None, False),
         "grid1f": ("cam", "sum", None, False)}
# each TPU probe by name -> its variant (``base`` is ``io``'s instance) and
# the TPU kernel it replaces: the pl.pallas_call line, and its body
PROBES = {
    "io": ("io", "scripts/fixed_probe.py:63", "io_body (:77)"),
    "feat": ("feat", "scripts/fixed_probe.py:63", "feat_body (:80), 6 parts"),
    "feat3": ("feat3", "scripts/fixed_probe.py:63",
              "feat_body (:80), 3 parts (:123)"),
    "acc": ("acc", "scripts/fixed_probe.py:63", "acc_body (:88)"),
    "base": ("io", "scripts/fixed_probe2.py:78", "base_kern (:74)"),
    "noin": ("noin", "scripts/fixed_probe2.py:99", "noin_kern (:90)"),
    "noout": ("noout", "scripts/fixed_probe2.py:114", "noout_kern (:109)"),
    "none": ("none", "scripts/fixed_probe2.py:130", "none_kern (:125)"),
    "none2": ("none2", "scripts/fixed_probe2.py:145", "none2_kern (:139)"),
    "feat_i": ("feat_i", "scripts/fixed_probe2.py:169", "feati_kern (:155)"),
    "empty": ("empty", "scripts/fixed_probe3.py:98", "empty_kern (:57)"),
    "write": ("write", "scripts/fixed_probe3.py:98", "write_kern (:63)"),
    "grid1": ("grid1", "scripts/fixed_probe3.py:98", "grid1_kern (:67)"),
    "grid1f": ("grid1f", "scripts/fixed_probe3.py:98", "grid1f_kern (:73)"),
}
# K1 on the frame's plan, cut to one entry per tile (fixed_probe.py's
# win_body), and cut to none
K1_POINTS = {"win": 1, "k1_empty": 0}
WIN_REPLACES = ("scripts/fixed_probe.py:63", "win_body (:103)")


def frame_inputs(width: int, height: int, tile_px: int, focal: float,
                 device=None) -> dict:
    """The probes' arguments on a frame of identity view: o, d
    [n, tile, 3] (the tile-major primary rays), cam [24]
    (plan.make_cam), origins [n, 2] i32 (each tile's first pixel relative
    to the image centre), a = 0 and the frame's shape."""
    o, d, tx, ty = primary_rays_tiled(width, height, tile_px, focal,
                                      device=device)
    n, tile = tx * ty, tile_px * tile_px
    px0, py0 = pl.tile_origins(n, tx, tile_px, width, height, device)
    return {"o": o.reshape(n, tile, 3).contiguous(),
            "d": d.reshape(n, tile, 3).contiguous(),
            "cam": pl.make_cam(None, focal, (0.0, 0.0, 0.0), None, device),
            "origins": torch.stack([px0, py0], dim=1).contiguous(),
            "a": 0.0, "tile_px": tile_px, "width": width, "height": height}


def _check(o, d, cam, origins, tile_px: int, width: int, height: int,
           threads: int) -> None:
    build.check_operands(cam.device, tile_px, threads,
                         o=(o, torch.float32), d=(d, torch.float32),
                         cam=(cam, torch.float32),
                         origins=(origins, torch.int32))
    tx, ty = -(-width // tile_px), -(-height // tile_px)
    n = tx * ty
    if o.shape != (n, tile_px * tile_px, 3) or d.shape != o.shape:
        raise ValueError(f"o {tuple(o.shape)} / d {tuple(d.shape)} for "
                         f"{n} tiles of {tile_px}x{tile_px} pixels")
    if cam.shape != (24,) or origins.shape != (n, 2):
        raise ValueError(f"cam {tuple(cam.shape)} / origins "
                         f"{tuple(origins.shape)}")


def fixed_probe(variant: str, o, d, cam, origins, a: float, tile_px: int,
                width: int, height: int, threads: int = 512):
    """One variant of ``fixed_probe_kernel`` (see the module docstring)
    over the tiles of a width x height frame of tile_px-pixel tiles: o, d
    [n, tile, 3] f32, cam [24] f32, origins [n, 2] i32 (every variant takes
    all of them).  Returns (t, idx or None): [n, tile] tile-major, [1, tile]
    for ``empty`` (the row that block 0 stores) or [height, width] in image
    order; idx i32 where the variant writes one."""
    if variant not in SPECS:
        raise ValueError(f"unknown probe variant {variant!r}")
    tile = tile_px * tile_px
    threads = min(threads, tile)
    _check(o, d, cam, origins, tile_px, width, height, threads)
    _rays, _value, idx_kind, image = SPECS[variant]
    n = o.shape[0]
    shape = (height, width) if image else (n, tile)
    t = torch.empty(shape, dtype=torch.float32, device=cam.device)
    idx = (None if idx_kind is None
           else torch.empty(shape, dtype=torch.int32, device=cam.device))
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.library().srt_fixed_probe(
            VARIANTS.index(variant), o.data_ptr(), d.data_ptr(),
            cam.data_ptr(), origins.data_ptr(), a, n, tile_px, width,
            height, t.data_ptr(), None if idx is None else idx.data_ptr(),
            threads, stream)
    build.check(rc, f"fixed_probe_kernel ({variant})")
    count(f"fixed.fixed_probe.launches.{variant}")
    return (t[:1] if variant == "empty" else t), idx


def feature_rows(ox, oy, oz, dx, dy, dz) -> list:
    """F10 = [dx, dy, dz, cx, cy, cz, ox, oy, oz, 1] with c = o x d, each
    row shaped as d (JAX ``tiled_t._build_feats``, rows 0-9)."""
    def full(x):
        return x.expand(dx.shape) if x.dim() == 0 else x
    ox, oy, oz = full(ox), full(oy), full(oz)
    return [dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
            ox * dy - oy * dx, ox, oy, oz, torch.ones_like(dx)]


def _summed(rows) -> torch.Tensor:
    t = torch.zeros_like(rows[0])
    for r in rows:
        t = t + r
    return t


def fixed_probe_plain(variant: str, o, d, cam, origins, a: float,
                      tile_px: int, width: int, height: int,
                      threads: int = 512):
    """Plain PyTorch version of :func:`fixed_probe` (same arguments and
    results; ``threads`` is ignored)."""
    if variant not in SPECS:
        raise ValueError(f"unknown probe variant {variant!r}")
    rays, value, idx_kind, image = SPECS[variant]
    n, tile = o.shape[0], tile_px * tile_px
    dev = cam.device
    tiles = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    if rays == "cam":
        dx, dy, dz = tile_ray_dirs(cam, origins[:, 0], origins[:, 1],
                                   tile_px)
        ox, oy, oz = cam[9], cam[10], cam[11]
    else:
        ox, oy, oz = o.unbind(-1)
        dx, dy, dz = d.unbind(-1)
    F = feature_rows(ox, oy, oz, dx, dy, dz)
    idx = None
    if value == "ox1":
        t = F[6] + 1.0
    elif value == "sum":
        t = _summed(F)
    elif value == "dir":
        t = _summed(F[:3])
    elif value == "0369":
        t = _summed(F[0::3])
    elif value == "dx1":
        t = dx + 1.0
    elif value == "row":
        lane = torch.arange(tile, device=dev).to(torch.float32)
        a32 = torch.tensor(a, dtype=torch.float32, device=dev)
        t = (lane[None, :] + a32) + tiles.to(torch.float32)
    else:                            # "keep": least row, lowest id on ties
        Fs = torch.stack(F)                                   # [10, n, tile]
        best = (Fs == Fs.amin(dim=0)).to(torch.int32).argmax(dim=0)
        t = Fs.gather(0, best[None])[0]
        idx = torch.where(torch.isfinite(t), best.to(torch.int32), -1)
    if idx_kind == "tile":
        idx = tiles.expand(n, tile)
    if variant == "empty":
        return t[:1].contiguous(), None
    if image:
        tx, ty = -(-width // tile_px), -(-height // tile_px)
        t = untile_image(t.reshape(-1), width, height, tile_px, tx, ty)
        if idx is not None:
            idx = untile_image(idx.reshape(-1), width, height, tile_px, tx,
                               ty)
    return (t.contiguous(),
            None if idx is None else idx.to(torch.int32).contiguous())


def cut_plan(plan, keep: int):
    """``plan`` with every tile's walk cut to its first ``keep`` entries
    (list rows) or windows (range rows)."""
    p = plan.clone()
    p[:, 1].clamp_(max=keep)
    p[:, 2].clamp_(max=keep)
    return p


def k1_points(args: tuple) -> dict:
    """K1's arguments on the frame (``nearest.shaded_args``) with the plan
    cut by :data:`K1_POINTS`: "win" walks each tile's first entry (the
    fixed part, one staged window's tests and the real epilogue), and
    "k1_empty" walks nothing (the fixed part with the real epilogue)."""
    return {name: (cut_plan(args[0], keep),) + tuple(args[1:])
            for name, keep in K1_POINTS.items()}


def run(prep, cfg, light_pos, frames: int = 8, threads: int = 512):
    """Time every probe of :data:`PROBES` on the frame of ``cfg.camera`` in
    K1's tiles, each call cold (its inputs out of the L2), then K1 on that
    frame's plan (``k1``) and on its cut plans (:func:`k1_points`), back
    to back, each over ``frames`` calls after one warm-up.
    Returns (records, the probes' inputs, K1's arguments by point)."""
    cam = cfg.camera
    tpx = pl.effective_tile_px(cfg, prep.scene.num_triangles)
    inputs = frame_inputs(cam.width, cam.height, tpx, cam.focal, prep.device)
    n, lanes = inputs["o"].shape[0], inputs["o"].shape[0] * tpx * tpx
    out = []
    for name, (variant, _src, _body) in PROBES.items():
        times = device_ms(lambda: table.run("fixed", variant, **inputs,
                                            threads=threads), frames,
                          flush=True)
        out.append(record(name, times, n, lanes, variant=variant))
    maxv = pl.effective_cull_maxv(cfg, prep.num_blocks,
                                  cfg.kernel.window_blocks)
    args = nearest.shaded_args(prep, cfg, light_pos,
                               (None, cam.focal, cam.width, cam.height, tpx),
                               maxv)
    points = {"k1": args, **k1_points(args)}
    for name, a in points.items():
        times = device_ms(lambda: table.run("nearest_shaded", *a), frames)
        out.append(record(name, times, n, lanes, variant=None))
    return out, inputs, points


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=4096,
                    help="rays per tile, a square of pixels (K1's 64x64)")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    require_cuda()
    tpx = math.isqrt(args.tile)
    if tpx * tpx != args.tile:
        raise ValueError(f"--tile {args.tile} is no square of pixels")
    import simple_raytracer_tpu_torch as sr
    from ..accel.prepared import prepare
    from ..scene import procedural as P
    cfg = sr.default_config().replace(
        mode="tiled", tile_px=tpx, bvh=sr.BVHConfig(split="sah"),
        camera=sr.CameraConfig(width=1920, height=1080,
                               focal=P.bench_focal(1080)))
    prep = prepare(P.sphere_on_ground(sr.SceneManager(), 6).build(), cfg,
                   device="cuda")
    light = torch.tensor(P.BENCH_LIGHT, dtype=torch.float32, device="cuda")
    records, _inputs, _points = run(prep, cfg, light, args.frames)
    print(f"# {torch.cuda.get_device_name(0)}, bench frame 1920x1080 in "
          f"{tpx}x{tpx}-pixel tiles", flush=True)
    for r in records:
        print(line(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
