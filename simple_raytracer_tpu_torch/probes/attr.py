"""The winner-fetch probes (``csrc/probe_attr.cu``).

Counterparts of the JAX package's TPU probes ``scripts/attr_probe.py`` and
``scripts/attr_fetch_probe.py``, which fetched the winning triangle's
attribute rows inside a kernel without a gather (one-hot contractions on
the matrix unit):

* :func:`attr_gather` (``attr_gather_kernel``; ``attr_probe.py``'s
  ``_attr_kernel``): per ray, the winner id in [-1, T) -> that triangle's
  row of the attribute table, zeros on a miss.  The scripts' toy table has
  T = 18 x 128 triangles and 16 attributes; production is n = 8,100 tiles
  of 256 rays (2,073,600 rays, the 1080p frame).
* :func:`attr_window` (``attr_window_kernel``; ``attr_fetch_probe.py``'s
  inner ``kernel``): per tile and ray, the sum over the tile's plan windows
  (``starts``) of the table rows of the window lanes whose triangle is the
  ray's winner, in window order, in f32.  Windows are two 32-triangle blocks
  of 128 lanes each, of which the first 32 carry a triangle; the table is
  bf16 and has NB x 128 lanes.  Production: 510 tiles x 10 windows x 4,096
  rays, NB = 2,172.

The TPU kernels took the table as A [16, lanes]; the card's kernels read
rows of its transpose ``at`` [lanes, 16] (64 or 32 bytes a row), which
:func:`gather_inputs` and :func:`window_inputs` build.  Both make their
inputs in numpy as the scripts do (``np.random.default_rng(0)``, the same
draws in the same order).

Run on a card (the scripts' arguments)::

    python -m simple_raytracer_tpu_torch.probes.attr [n] [--windows 10]
        [--tiles 510] [--tile_r 4096] [--iters 8]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import build, table
from ..utils.metrics import count
from . import device_ms, line, record, require_cuda

AF = 16                  # attributes per triangle
# attr_probe.py's toy scene: 18 chunks of 128 triangles, tiles of 256 rays
TILE_R = 256
NCH = 18
T = NCH * 128
# attr_fetch_probe.py: 32-triangle blocks, two blocks to a window, 128
# lanes a block (the first 32 carry triangles), 2,172 blocks
BS, WB = 32, 2
RPB = 4 * BS
WL = WB * RPB
NB = 2172
GATHER_N = 8100          # attr_probe.py's default n: the 1080p frame
REPLACES = {"attr_gather": ("scripts/attr_probe.py:77",
                            "_attr_kernel (:30), through attr_fetch"),
            "attr_window": ("scripts/attr_fetch_probe.py:77",
                            "kernel (:57), through run")}


def gather_inputs(n: int, device=None):
    """``attr_probe.py``'s inputs for n tiles: (bid [n, 256] i32 in
    [-1, T), at [T, 16] f32, the transpose of its A [16, T])."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((AF, T)).astype(np.float32)
    bid = rng.integers(-1, T, size=(n, TILE_R)).astype(np.int32)
    return (torch.from_numpy(bid).to(device),
            torch.from_numpy(np.ascontiguousarray(A.T)).to(device))


def window_inputs(tiles: int, windows: int, tile_r: int, nb: int = NB,
                  device=None):
    """``attr_fetch_probe.py``'s inputs: (starts [tiles, windows] i32,
    sorted per tile, bid [tiles, tile_r] i32 in [0, nb * 32), at
    [nb * 128, 16] bf16, the transpose of its A [16, nb * 128] rounded to
    bf16 as ``astype(jnp.bfloat16)`` rounds)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((AF, nb * RPB)).astype(np.float32)
    bid = rng.integers(0, nb * BS, (tiles, 1, tile_r)).astype(np.int32)
    starts = np.sort(rng.integers(0, nb // WB - 1, (tiles, windows))
                     .astype(np.int32), axis=1)
    at = torch.from_numpy(np.ascontiguousarray(A.T)).to(torch.bfloat16)
    return (torch.from_numpy(starts).to(device),
            torch.from_numpy(bid.reshape(tiles, tile_r)).to(device),
            at.to(device))


def _aligned(**xs) -> None:
    for name, x in xs.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def attr_gather(bid, at, threads: int = 256):
    """Winner ids bid [n, R] i32 in [-1, T) and the table at [T, 16] f32
    -> rows [n, R, 16] f32: at[bid], zeros where bid < 0."""
    build.check_tensors(bid.device, bid=(bid, torch.int32),
                        at=(at, torch.float32))
    if bid.dim() != 2 or at.dim() != 2 or at.shape[1] != AF:
        raise ValueError(f"bid {tuple(bid.shape)} / at {tuple(at.shape)}")
    _aligned(at=at)
    out = torch.empty((*bid.shape, AF), dtype=torch.float32,
                      device=bid.device)
    with torch.cuda.device(bid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.library().srt_attr_gather(
            bid.data_ptr(), at.data_ptr(), bid.numel(), out.data_ptr(),
            threads, stream)
    build.check(rc, "attr_gather_kernel")
    count("attr.attr_gather.launches")
    return out


def attr_gather_plain(bid, at, threads: int = 256):
    """Plain PyTorch version of :func:`attr_gather` (same arguments and
    results; ``threads`` is ignored)."""
    rows = at[bid.clamp_min(0).long()]
    return torch.where((bid >= 0)[..., None], rows, 0.0)


def attr_window(starts, bid, at, threads: int = 256):
    """Per tile i and ray r: the sum over k of the rows of at
    [NB * 128, 16] bf16 at the lanes of window starts[i, k] whose triangle
    is bid[i, r] (see the module docstring), added in k order in f32;
    starts [tiles, windows] i32, bid [tiles, R] i32.  Returns
    [tiles, 16, R] f32 (``attr_fetch_probe.py``'s output layout)."""
    build.check_tensors(bid.device, starts=(starts, torch.int32),
                        bid=(bid, torch.int32), at=(at, torch.bfloat16))
    if (bid.dim() != 2 or starts.dim() != 2
            or starts.shape[0] != bid.shape[0] or at.dim() != 2
            or at.shape[1] != AF or at.shape[0] % WL):
        raise ValueError(f"starts {tuple(starts.shape)} / bid "
                         f"{tuple(bid.shape)} / at {tuple(at.shape)}")
    _aligned(at=at)
    tiles, R = bid.shape
    out = torch.empty((tiles, AF, R), dtype=torch.float32, device=bid.device)
    with torch.cuda.device(bid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.library().srt_attr_window(
            starts.data_ptr(), starts.shape[1], bid.data_ptr(),
            at.data_ptr(), tiles, R, out.data_ptr(), threads, stream)
    build.check(rc, "attr_window_kernel")
    count("attr.attr_window.launches")
    return out


def attr_window_plain(starts, bid, at, threads: int = 256):
    """Plain PyTorch version of :func:`attr_window` (same arguments and
    results; ``threads`` is ignored): per window, the one lane whose
    triangle can be the winner, b - 64 s in [0, 64)."""
    tiles, R = bid.shape
    acc = torch.zeros((tiles, R, AF), dtype=torch.float32, device=bid.device)
    for k in range(starts.shape[1]):
        s = starts[:, k:k + 1]
        off = bid - s * (WB * BS)
        hit = (off >= 0) & (off < WB * BS)
        lane = torch.div(off, BS, rounding_mode="floor") * RPB + off % BS
        col = torch.where(hit, s * WL + lane, 0)
        acc = acc + torch.where(hit[..., None], at[col.long()].float(), 0.0)
    return acc.permute(0, 2, 1).contiguous()


def run(n: int = GATHER_N, tiles: int = 510, windows: int = 10,
        tile_r: int = 4096, iters: int = 8, device="cuda"):
    """Time :func:`attr_gather` on ``attr_probe.py``'s inputs for n tiles
    and :func:`attr_window` on ``attr_fetch_probe.py``'s, each over
    ``iters`` calls after one warm-up.  Returns (records, the inputs by
    probe).  Each call is timed cold, its inputs out of the L2."""
    inputs = {"attr_gather": gather_inputs(n, device),
              "attr_window": window_inputs(tiles, windows, tile_r,
                                           device=device)}
    out = [record("attr_gather", device_ms(
               lambda: table.run("attr_gather", *inputs["attr_gather"]),
               iters, flush=True), n, n * TILE_R),
           record("attr_window", device_ms(
               lambda: table.run("attr_window", *inputs["attr_window"]),
               iters, flush=True), tiles, tiles * tile_r, windows=windows)]
    return out, inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=GATHER_N,
                    help="tiles of 256 rays for attr_gather")
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--tiles", type=int, default=510)
    ap.add_argument("--tile_r", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    require_cuda()
    records, inputs = run(args.n, args.tiles, args.windows, args.tile_r,
                          args.iters)
    bid, at = inputs["attr_gather"]
    err = float((attr_gather(bid, at) - attr_gather_plain(bid, at))
                .abs().max())
    print(f"# {torch.cuda.get_device_name(0)}; attr_gather vs plain: "
          f"max |err| = {err}", flush=True)
    for r in records:
        print(line(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
