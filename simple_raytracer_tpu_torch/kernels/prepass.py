"""Kernel 3: the bf16 classification walk of the exact two-pass nearest walk.

``tiled_prepass`` wraps the CUDA kernels of csrc/prepass.cu, a schedule
launch (``prepass_schedule_kernel``) and a persistent walk over (tile, ray
slice, span) work items (``prepass_items_kernel``), and replaces the JAX
package's Pallas kernel ``kernels/tiled_t.py::_prepass_kernel_t`` (reached
through ``tiled_prepass_t`` from ``hits`` with ``SRT_TILED_PREPASS=1``;
here ``KernelConfig.prepass``).  ``tiled_prepass_plain`` is its plain
PyTorch version, a model of the items: same arguments, same flags, the
kernel's bf16 roundings and f32 sums in the same order.  The wrapper takes
CUDA tensors, launches the kernels (a call is two launches) and counts the
call (``prepass.tiled_prepass.launches``); kernels/table.py chooses between
it and its plain version.

:func:`refine_plan` (JAX ``tiled_t._refine_plan``) keeps the flagged
windows of each plan row; the nearest walk over the refined plan gives the
same (t, idx) as over the whole plan (kernels/nearest.py::hits).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.intersect import ray_features
from ..utils.metrics import count
from . import build, plan as pl

# error factor of the bf16 quad: |x_bf16 - x| <= PREPASS_M * sum_k |G_k| *
# alpha_k, twice the operand rounding's 2^-7 (JAX tiled_t.PREPASS_M)
PREPASS_M = 2.0 ** -6
PLAIN_ELEMS = 1 << 22   # ray-triangle pairs per step of the plain walk
MAX_RAYS = 8192         # rays per tile the wrapper takes
# K3's work items (csrc/prepass.cu): slices of nearest.slice_rays(M) lanes,
# range rows in spans of PREPASS_RANGE_SPAN windows, lists in spans of
# PREPASS_LIST_SPAN entries, each span walked from its own start (best_hi
# +inf); the pair of least K3 + refined nearest walk time in chip_smoke.py's
# span sweep on the prepass bench
PREPASS_RANGE_SPAN = 4
PREPASS_LIST_SPAN = 8


def prepass_call(plan, gram, o, d, window_tris: int, eps: float,
                 range_span: int = None, list_span: int = None):
    """Check the operands of K3 (CUDA tensors, as :func:`tiled_prepass`),
    allocate its output and scratch, and return (launch, flags [n, W],
    sched): ``launch(stages=3)`` queues the schedule, which zeroes the
    flags (1), and the walk (2).  Spans default to PREPASS_RANGE_SPAN and
    PREPASS_LIST_SPAN."""
    from . import nearest
    build.check_tensors(plan.device, plan=(plan, torch.int32),
                        gram=(gram, torch.float32), o=(o, torch.float32),
                        d=(d, torch.float32))
    n = plan.shape[0]
    if plan.dim() != 2 or plan.shape[1] <= pl.PLAN_AUX:
        raise ValueError(f"plan shape {tuple(plan.shape)}")
    if gram.dim() != 2 or gram.shape[1] != 40 \
            or gram.shape[0] % window_tris:
        raise ValueError(f"gram shape {tuple(gram.shape)} for windows of "
                         f"{window_tris}")
    if o.dim() != 3 or o.shape[0] != n or o.shape[2] != 3 \
            or d.shape != o.shape:
        raise ValueError(f"o {tuple(o.shape)} / d {tuple(d.shape)} for {n} "
                         f"tiles")
    m = o.shape[1]
    if not 0 < m <= MAX_RAYS:
        raise ValueError(f"{m} rays per tile (at most {MAX_RAYS})")
    rs = range_span or PREPASS_RANGE_SPAN
    ls = list_span or PREPASS_LIST_SPAN
    n_windows = gram.shape[0] // window_tris
    rmax = nearest.rows_max(plan, n_windows, rs, ls)
    flags = torch.empty(plan.shape, dtype=torch.bool, device=plan.device)
    sched = torch.empty(2 + 2 * rmax, dtype=torch.int32, device=plan.device)

    def launch(stages: int = 3):
        with torch.cuda.device(plan.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = build.library().srt_prepass(
                plan.data_ptr(), plan.shape[1], n, gram.data_ptr(),
                n_windows, o.data_ptr(), d.data_ptr(), m, window_tris, eps,
                PREPASS_M, flags.data_ptr(), sched.data_ptr(), rmax, rs, ls,
                stages, stream)
        build.check(rc, "prepass_items_kernel")
    return launch, flags, sched


def prepass_shape(window_tris: int, m: int) -> dict:
    """K3's walk on the current card for windows of ``window_tris``
    triangles and tiles of ``m`` rays: CTAs per SM, registers per thread,
    SMs, rays per slice and threads per CTA."""
    out = (ctypes.c_int * 5)()
    build.check(build.library().srt_prepass_shape(
        window_tris, m, ctypes.cast(out, ctypes.c_void_p)),
        "srt_prepass_shape")
    return dict(zip(("ctas_per_sm", "registers", "sms", "slice_rays",
                     "threads"), out))


def tiled_prepass(plan, gram, o, d, window_tris: int, eps: float):
    """Window flags of every tile of ``plan``.

    plan [n, W] i32 (kernels/plan.py layout, windows of ``window_tris``
    triangles); gram [Tp, 40] f32 (accel/prepared.py); o, d [n, M, 3] f32
    the rays of each tile.  Returns flags [n, W] bool: flag k is set when
    the window at plan position k may hold the nearest hit of some ray of
    the tile under the bf16 error bound ``PREPASS_M * sum_k |G_k| alpha_k``
    (as the work items of :func:`tiled_prepass_plain` find it).  Positions
    past the walk (and rows in range mode longer than the plan's entries)
    read False."""
    launch, flags, _ = prepass_call(plan, gram, o, d, window_tris, eps)
    launch()
    count("prepass.tiled_prepass.launches")
    return flags


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), held as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def walked_plan(plan):
    """``plan`` with its range rows longer than the plan's entries emptied:
    K3 walks none of them (refine_plan keeps their plans whole)."""
    mv = plan.shape[1] - pl.PLAN_AUX
    out = plan.clone()
    out[(plan[:, 3] != 1) & (plan[:, 1] > mv), 1] = 0
    return out


def work_rows(plan, n_windows: int, range_span: int = PREPASS_RANGE_SPAN,
              list_span: int = PREPASS_LIST_SPAN):
    """The plain version of K3's schedule: the rows (tile, span) [N, 2] i32
    and their walk lengths [N], longest first, of :func:`walked_plan`
    (kernels/nearest.py::work_rows)."""
    from . import nearest
    return nearest.work_rows(walked_plan(plan), n_windows, range_span,
                             list_span)


def tiled_prepass_plain(plan, gram, o, d, window_tris: int, eps: float,
                        slice_rays: int = None, range_span: int = None,
                        list_span: int = None):
    """Plain PyTorch version of :func:`tiled_prepass` (same arguments and
    flags), a model of the kernel's work items.
    Each tile's rays are cut into slices of ``slice_rays`` consecutive
    lanes (default nearest.slice_rays(M); a last slice cut short walks with
    copies of its first ray, which change nothing), each slice walks every
    span of the tile's row (:func:`work_rows`: ranges in spans of
    ``range_span`` windows, lists in spans of ``list_span`` entries) with
    :func:`walk_plain` (its own alpha, best_hi from +inf at the span's
    start, its own break), and a position's flag is the OR over the items.
    One slice a tile and spans longer than every row walk each tile
    whole.  Records the items' work as the plain nearest walk does:
    ``tiled_prepass_plain.lane_pairs`` [n, M] i64 (each ray's tests) and
    ``tiled_prepass_plain.staged`` [windows] bool."""
    from . import nearest
    n, m = o.shape[:2]
    dev = plan.device
    sr = slice_rays or nearest.slice_rays(m)
    rs = range_span or PREPASS_RANGE_SPAN
    ls = list_span or PREPASS_LIST_SPAN
    ns, src = nearest.slice_lanes(m, sr, dev)
    f = ray_features(o, d)[:, src].reshape(n * ns, sr, 10)
    rows = walked_plan(plan).repeat_interleave(ns, dim=0)
    lst = rows[:, 3] == 1
    span = torch.where(lst, ls, rs)
    spans = -(-torch.where(lst, rows[:, 2], rows[:, 1]) // span)
    flags = torch.zeros(rows.shape, dtype=torch.bool, device=dev)
    pairs = torch.zeros((n * ns, sr), dtype=torch.int64, device=dev)
    staged = torch.zeros(gram.shape[0] // window_tris, dtype=torch.bool,
                         device=dev)
    for s in range(int(spans.max()) if spans.numel() else 0):
        sub, _ = nearest.span_plan(rows, s, rs, ls)
        r, j = torch.nonzero(walk_plain(sub, gram, f, window_tris, eps),
                             as_tuple=True)
        flags[r, s * span[r] + j] = True
        pairs += walk_plain.lane_pairs
        staged |= walk_plain.staged
    tiled_prepass_plain.lane_pairs = pairs.reshape(n, ns * sr)[:, :m]
    tiled_prepass_plain.staged = staged
    return flags.reshape(n, ns, -1).any(dim=1)


tiled_prepass_plain.lane_pairs = tiled_prepass_plain.staged = None


def walk_plain(plan, gram, f, window_tris: int, eps: float):
    """K3's walk of whole rows: row i of ``plan`` walks its positions in
    order over the rays whose f32 features are f [n, M, 10]
    (ops/intersect.py::ray_features), with alpha the rows' largest |F_k|,
    best_hi from +inf, and (list rows) a break once every ray's best_hi is
    below the next entry's bound; range rows longer than the plan's
    entries are not walked.  Walks the rows in step, a few at a time.
    Returns flags [n, W] bool; records ``walk_plain.lane_pairs`` [n, M]
    i64 and ``walk_plain.staged`` [windows] bool."""
    n, m = f.shape[:2]
    dev = plan.device
    wt = window_tris
    alpha = f.abs().amax(dim=1)                                 # [n, 10]
    fb = _bf16(f)
    g = gram.reshape(-1, 10, 4)
    gb = _bf16(g)
    ga = g.abs()
    mv = plan.shape[1] - pl.PLAN_AUX
    use_list = plan[:, 3] == 1
    cnt = torch.where(use_list, plan[:, 2], plan[:, 1])
    cnt = torch.where(~use_list & (cnt > mv), 0, cnt)     # kept by refine_plan
    flags = torch.zeros(plan.shape, dtype=torch.bool, device=dev)
    bh = torch.full((n, m), float("inf"), device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    jt = torch.arange(wt, dtype=torch.int32, device=dev)
    lane_pairs = torch.zeros((n, m), dtype=torch.int64, device=dev)
    staged = torch.zeros(gram.shape[0] // wt, dtype=torch.bool, device=dev)
    chunk = max(1, PLAIN_ELEMS // max(1, m * wt))
    for k in range(int(cnt.max()) if n else 0):
        live = torch.nonzero((k < cnt) & ~done).flatten()
        for ids in live.split(chunk):
            e = plan[ids, pl.PLAN_AUX + min(k, mv - 1)]
            w = torch.where(use_list[ids], e & 0xFFFF, plan[ids, 0] + k)
            staged[w.long()] = True
            lane_pairs[ids] += wt
            tid = (w[:, None] * wt + jt[None, :]).long()        # [c, wt]
            G, Ga = gb[tid], ga[tid]                            # [c, wt, 10, 4]
            al = alpha[ids]
            s = Ga[:, :, 0, :] * al[:, None, 0, None]
            for kk in range(1, 10):
                s = s + Ga[:, :, kk, :] * al[:, None, kk, None]
            err = (PREPASS_M * s)[:, None]                      # [c, 1, wt, 4]
            F = fb[ids]
            # the ten-term sums: each product of two bf16 values is exact,
            # so q + G * F rounds once, fused or not (the kernel's FMAs)
            q = G[:, None, :, 0, :] * F[:, :, None, 0, None]    # [c, M, wt, 4]
            for kk in range(1, 10):
                q.addcmul_(G[:, None, :, kk, :], F[:, :, None, kk, None])
            sgn = torch.where(q[..., 0] >= 0.0, 1.0, -1.0)
            adet, un, vn, tn = (q[..., c] * sgn for c in range(4))
            eD, eU, eV, eT = (err[..., c] for c in range(4))
            uL, uH, vL, vH = un - eU, un + eU, vn - eV, vn + eV
            tL, tH = tn - eT, tn + eT
            aL, aH = adet - eD, adet + eD
            mn = torch.minimum
            conf = mn(mn(uL, vL), mn(aL - (uH + vH), mn(tL, aL - eps))) >= 0.0
            t_hi = tH / aL.clamp_min(1e-30)
            mb = mn(mn(uH, vH), mn(aH - (uL + vL), mn(tH, aH - eps))) >= 0.0
            b0 = bh[ids][..., None]                             # [c, M, 1]
            cand = (mb & (tL.clamp_min(0.0) <= b0 * aH)) | \
                (~(adet > eD) & (aH >= eps))
            flags[ids, k] = cand.flatten(1).any(dim=1)
            best = torch.where(conf, t_hi, float("inf")).amin(dim=-1)
            bh[ids] = torch.minimum(bh[ids], best)
        # front-to-back break on the rays' upper bounds (logical shift)
        nb16 = plan[live, pl.PLAN_AUX + min(k + 1, mv - 1)] >> 16
        worst = ((bh[live].view(torch.int32) >> 16) & 0xFFFF).amax(dim=1)
        done[live] = use_list[live] & (k + 1 < cnt[live]) & (worst < nb16)
    walk_plain.lane_pairs, walk_plain.staged = lane_pairs, staged
    return flags


walk_plain.lane_pairs = walk_plain.staged = None


def refine_plan(plan: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """A plan compacted to its flagged windows (JAX tiled_t._refine_plan):
    front-to-back order and packed entry bounds kept.  Range rows get
    list entries of their windows with bound 0; range rows longer than the
    plan's entries keep their plan (the walk takes them whole).  ``flags``
    [n, >= entries] (bool, or JAX's 0/1 floats)."""
    n = plan.shape[0]
    mv = plan.shape[1] - pl.PLAN_AUX
    lo, rng, lcnt = plan[:, 0], plan[:, 1], plan[:, 2]
    use_list = plan[:, 3] == 1
    cnt = torch.where(use_list, lcnt, rng)
    pos = torch.arange(mv, dtype=torch.int32, device=plan.device)[None]
    live = (flags[:, :mv] != 0) & (pos < cnt[:, None])
    ent = torch.where(use_list[:, None], plan[:, pl.PLAN_AUX:],
                      lo[:, None] + pos)
    slot = torch.where(live, torch.cumsum(live, dim=1) - 1, mv)
    ent2 = torch.zeros((n, mv + 1), dtype=torch.int32, device=plan.device)
    ent2.scatter_(1, slot.long(), ent)
    z = torch.zeros_like(lo)
    aux = torch.stack([lo, rng, live.sum(dim=1).to(torch.int32),
                       torch.ones_like(lo), z, z, z, z], dim=-1)
    plan2 = torch.cat([aux, ent2[:, :mv]], dim=1)
    keep = ~use_list & (cnt > mv)
    return torch.where(keep[:, None], plan, plan2).contiguous()
