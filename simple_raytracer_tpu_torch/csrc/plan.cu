// The cull planner: the plan rows of a tile set, from its bounds and the
// block tables, in at most two launches; and the O(tiles) bounds of the
// fused frame's two plans, a launch each, with the frame's camera row.
//
// Replaces no TPU kernel: the JAX package builds its plans in jnp
// (kernels/tiled_t.py::cull, cull_occl; kernels/tiled.py::
// cull_blocks_lists), and XLA fuses them.  The port built them one PyTorch
// op at a time (kernels/plan.py::cull_plain, its plain version: some
// 300-380 small ops a plan), which held the card idle while the host
// dispatched them.  Reached through kernels/plan.py::cull for CUDA tensors
// and list-capable plans, with the interval test or the hourglass test.
//
// What bounds it on this card: the (tile, block) tests, ~60 f32 operations
// a pair with four divisions per axis (the hourglass test ~90, with twelve
// divisions), over tiles x blocks pairs (510 x 2,564 in a 1080p frame,
// 3,750 x 2,564 in the soft frame's fold, 3,750 x 5,122 in the dense soft
// frame's); its compulsory bytes (the block tables and the plan) are a few
// MB at most.
// Design: one CTA a tile, its threads over the tile's windows; each
// window's least entry bound kept in shared memory (or, past
// kSmemWindows, in a scratch row); the window order of the entries built by
// a partition, not a sort (below), so the row is finished in three passes
// over the windows, with nothing read back by the host.
//
// plan_blocks_kernel<Apex> (apex tests only) computes what depends on the
// block and the frame alone: each block's projected rect (bu, bv), widened
// by 1e-4 (1 + |x|), and its empty and behind-the-apex flags.
// plan_tiles_kernel<Apex, Excl> computes, per (tile, block), the interval
// slab test (plan.py::visibility, _safe_div's a/0 -> +-inf, 0/0 -> 0);
// plan_hourglass_kernel<Apex, Excl> instead the hourglass test of shadow
// rays without a shared light (plan.py::visibility_hourglass: the lines
// between the origin box and the endpoint box, for t in [0, 1] and t >= 1).
// Then both apply the primary-apex or light-apex test (visibility_px,
// visibility_px_rev) and the own-object drop (excl), and build the tile's
// row in plan_row, plan.py::cull_lists: window visibility and least bound,
// the covering range, the list count, tmin/tmax over the visible windows,
// the bucket qb and its floor, bound16, and the entries, with the tile's
// pixel origin in columns 4/5 and, for a tile not live (a shadow tile
// without a hit), a row of zeros.
//
// The bounds (below, "The planners' bounds") replace the port's ~300
// PyTorch ops a fused frame (plan.py::tile_bounds_plain, shadow_frame,
// analytic_shadow_bounds_exact, tile_origins, _rows_of), whose constants
// were copied to the card, each copy waiting for the work queued before it.
//
// The entries' order without a sort: cull_lists sorts the keys
// bound16 << 16 | window.  bound16 is the top half of floor(qb), and
// floor(qb) = max(tmin + qb * qscale, 0) is non-decreasing in the bucket qb,
// of which there are 8; so the sorted keys are the windows of each distinct
// bound16 value, values ascending, windows ascending within each.  A rank
// per bucket (its value's place among the distinct values), a count per
// rank and a prefix over the windows in window order give each visible
// window its place, exactly torch.sort's.
//
// Built with --fmad=false (kernels/build.py): each multiply and add rounds
// on its own, in the order written, which is the plain version's order
// (the projective dot products are written out there as here); divisions
// are IEEE.  Minimum and maximum propagate NaN as torch.minimum does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTBuckets = 8;          // plan.py::T_BUCKETS
constexpr int kSmemWindows = 10240;   // window bounds held in shared memory
constexpr float kEps = 1e-12f;        // plan.py::EPS
constexpr float kBig = 3.0e38f;       // plan.py::BIG
constexpr int kInvisible = 0x7FFFFFFF;

enum Apex { kNoApex = 0, kPrimary = 1, kLight = 2 };

// Tile and frame operands, each (pointer, stride 0, stride 1) in elements,
// so expanded and sliced views need no copy (plan.py::cull_cuda).
enum Op {
  kOmin, kOmax, kDmin, kDmax,          // [n, 3] f32
  kRuLo, kRuHi, kRvLo, kRvHi,          // [n] f32 (apex tests)
  kTileBad,                            // [n] bool (primary apex)
  kExcl,                               // [n] i32
  kS, kV, kW, kApexPt,                 // [3] f32: frame and apex
  kQmin, kQmax,                        // [n, 3] f32 (hourglass test)
  kLive,                               // [n] bool: rows of other tiles are 0
  kNumOps
};

// The tile grid of a frame (plan.py::tile_origins): tile t's first pixel
// relative to the image centre is ((t % tiles_x) * tpx - hw,
// (t / tiles_x) * tpx - hh); tiles_x 0: no grid.
struct Grid {
  int tiles_x, tpx, hw, hh;

  __device__ int px0(int t) const { return (t % tiles_x) * tpx - hw; }
  __device__ int py0(int t) const { return (t / tiles_x) * tpx - hh; }
};

struct Operands {
  const void* p[kNumOps];
  long long s0[kNumOps];
  long long s1[kNumOps];

  __device__ float f(int op, long long i, long long j = 0) const {
    return static_cast<const float*>(p[op])[i * s0[op] + j * s1[op]];
  }
};

// What the apex tests read of a tile: its projective rect and, for the
// primary apex, whether one of its rays leaves the cone.
struct ApexTile {
  float ru_lo, ru_hi, rv_lo, rv_hi;
  bool bad;
};

template <int A>
__device__ __forceinline__ ApexTile apex_tile(const Operands& op, int tile) {
  ApexTile t{0.0f, 0.0f, 0.0f, 0.0f, false};
  if (A != kNoApex) {
    t.ru_lo = op.f(kRuLo, tile);
    t.ru_hi = op.f(kRuHi, tile);
    t.rv_lo = op.f(kRvLo, tile);
    t.rv_hi = op.f(kRvHi, tile);
  }
  if (A == kPrimary)
    t.bad = static_cast<const unsigned char*>(op.p[kTileBad])
                [tile * op.s0[kTileBad]] != 0;
  return t;
}

// The tile's own object (excl), or 0 where unused.
template <bool Excl>
__device__ __forceinline__ int excl_of(const Operands& op, int tile) {
  return Excl ? static_cast<const int*>(op.p[kExcl])[tile * op.s0[kExcl]] : 0;
}

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.minimum / torch.maximum / clamp_min: NaN in, NaN out
__device__ __forceinline__ float nmin(float a, float b) {
  return isnan_(a) ? a : isnan_(b) ? b : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return isnan_(a) ? a : isnan_(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}

// plan.py::_safe_div: a/0 -> sign(a) * inf, 0/0 -> 0
__device__ __forceinline__ float safe_div(float a, float b) {
  if (b != 0.0f) return a / b;
  if (a == 0.0f) return 0.0f;
  return a > 0.0f ? INFINITY : a < 0.0f ? -INFINITY : a;
}

// plan.py::visibility for one (tile, block): visible, and the entry bound
// (t_lo clamped at 0) in tlo.
__device__ __forceinline__ bool interval(const float* o_lo, const float* o_hi,
                                         const float* d_lo, const float* d_hi,
                                         const float* __restrict__ bmin,
                                         const float* __restrict__ bmax,
                                         int b, float& tlo) {
  float t_lo = 0.0f, t_hi = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float lo_i = bmin[b * 3 + ax] - o_hi[ax];
    const float hi_i = bmax[b * 3 + ax] - o_lo[ax];
    const float dn = d_lo[ax], dx = d_hi[ax];
    const float c0 = safe_div(lo_i, dn), c1 = safe_div(lo_i, dx);
    const float c2 = safe_div(hi_i, dn), c3 = safe_div(hi_i, dx);
    float tmin_ax = nmin(nmin(c0, c1), nmin(c2, c3));
    float tmax_ax = nmax(nmax(c0, c1), nmax(c2, c3));
    const bool spans = (dn <= 0.0f && dx >= 0.0f) ||
                       (lo_i <= 0.0f && hi_i >= 0.0f);
    tmin_ax = spans ? 0.0f : clamp_min(tmin_ax, 0.0f);
    tmax_ax = spans ? INFINITY : tmax_ax;
    t_lo = ax == 0 ? tmin_ax : nmax(t_lo, tmin_ax);
    t_hi = ax == 0 ? tmax_ax : nmin(t_hi, tmax_ax);
  }
  tlo = clamp_min(t_lo, 0.0f);
  return t_hi >= t_lo && t_hi >= 0.0f && t_lo < INFINITY;
}

// plan.py::visibility_hourglass's margin against f32 rounding
constexpr float kHourglassEps = 1e-5f;

// A tile's lines of plan.py::visibility_hourglass: a ray's point o + t d =
// (1 - t) o + t q lies, per axis, between two lines through the origin
// box [olo, ohi] and the endpoint box [qlo, qhi].  For branch 0 (t in
// [0, 1]) the lo line runs from olo to qlo and the hi line from ohi to qhi;
// for branch 1 (t >= 1) from ohi to qlo and from olo to qhi.  c0 is a
// line's value at t = 0 and sl its slope, negated for the hi line, so each
// condition reads sl * t <= r.
struct Hourglass {
  float c0[2][3][2], sl[2][3][2];  // [branch][axis][lo line, hi line]
};

__device__ __forceinline__ Hourglass hourglass_lines(const float* olo,
                                                     const float* ohi,
                                                     const float* qlo,
                                                     const float* qhi) {
  Hourglass h;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    h.c0[0][ax][0] = olo[ax];
    h.sl[0][ax][0] = qlo[ax] - olo[ax];
    h.c0[0][ax][1] = ohi[ax];
    h.sl[0][ax][1] = -(qhi[ax] - ohi[ax]);
    h.c0[1][ax][0] = ohi[ax];
    h.sl[1][ax][0] = qlo[ax] - ohi[ax];
    h.c0[1][ax][1] = olo[ax];
    h.sl[1][ax][1] = -(qhi[ax] - olo[ax]);
  }
  return h;
}

// One branch of visibility_hourglass for block b: each condition sl * t <=
// r bounds t above (sl > 0) or below (sl < 0) by thr = r / sl, widened by
// kHourglassEps (|thr| + 1); a parallel line (sl == 0) must meet the slab
// (r >= -kHourglassEps (|bound| + 1)).  Feasible where the bounds leave an
// interval of [t0, t1]; ta is its least t.  lo, hi: the block's box.
__device__ __forceinline__ bool hourglass_branch(const Hourglass& h, int br,
                                                 const float* lo,
                                                 const float* hi, float t0,
                                                 float t1, float& ta) {
  float tb = t1;
  bool feas = true;
  ta = t0;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      // the lo line against the block's max, the hi line against its min
      const float bnd = side == 0 ? hi[ax] : lo[ax];
      const float sl = h.sl[br][ax][side];
      float r = bnd - h.c0[br][ax][side];
      if (side == 1) r = -r;
      const float thr = r / (sl == 0.0f ? 1.0f : sl);
      const float mgn = kHourglassEps * (fabsf(thr) + 1.0f);
      if (sl > 0.0f) tb = nmin(tb, thr + mgn);
      if (sl < 0.0f) ta = nmax(ta, thr - mgn);
      if (sl == 0.0f && r < -kHourglassEps * (fabsf(bnd) + 1.0f))
        feas = false;
    }
  }
  return feas && tb >= ta;
}

// plan.py::visibility_hourglass for one (tile, block): visible on either
// branch, and the entry bound (the least feasible t, 0 where not finite)
// in tlo.
__device__ __forceinline__ bool hourglass(const Hourglass& h,
                                          const float* __restrict__ bmin,
                                          const float* __restrict__ bmax,
                                          int b, float& tlo) {
  float lo[3], hi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    lo[ax] = bmin[b * 3 + ax];
    hi[ax] = bmax[b * 3 + ax];
  }
  float ta_a, ta_b;
  const bool vis_a = hourglass_branch(h, 0, lo, hi, 0.0f, 1.0f, ta_a);
  const bool vis_b = hourglass_branch(h, 1, lo, hi, 1.0f, 3.4e38f, ta_b);
  const bool vis = vis_a || vis_b;
  float t = nmin(vis_a ? ta_a : INFINITY, vis_b ? ta_b : INFINITY);
  t = vis ? clamp_min(t, 0.0f) : INFINITY;
  tlo = fabsf(t) < INFINITY ? t : 0.0f;  // isfinite
  return vis;
}

// plan.py::_rect: a projected extent widened against f32 rounding
__device__ __forceinline__ float widen_lo(float lo) {
  return lo - 1e-4f * (1.0f + fabsf(lo));
}
__device__ __forceinline__ float widen_hi(float hi) {
  return hi + 1e-4f * (1.0f + fabsf(hi));
}

// What the apex tests need of each block (plan.py::_block_corners, _rect,
// visibility_px, visibility_px_rev): rect = (bu lo, bu hi, bv lo, bv hi),
// flags bit 0 empty, bit 1 behind the primary apex plane.
template <int A>
__global__ void __launch_bounds__(kThreads) plan_blocks_kernel(
    const float* __restrict__ bmin, const float* __restrict__ bmax,
    Operands op, int nb, float4* __restrict__ rect, int* __restrict__ flags) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= nb) return;
  float s[3], v[3], w[3], ap[3], lo[3], hi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    s[ax] = op.f(kS, ax);
    v[ax] = op.f(kV, ax);
    w[ax] = op.f(kW, ax);
    ap[ax] = op.f(kApexPt, ax);
    lo[ax] = bmin[b * 3 + ax];
    hi[ax] = bmax[b * 3 + ax];
  }
  bool all_pos = true, all_neg = true, all_le = true;
  float cw[8], cs[8], cv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float cx = ((k >> 0) & 1 ? hi[0] : lo[0]) - ap[0];
    const float cy = ((k >> 1) & 1 ? hi[1] : lo[1]) - ap[1];
    const float cz = ((k >> 2) & 1 ? hi[2] : lo[2]) - ap[2];
    cw[k] = cx * w[0] + cy * w[1] + cz * w[2];
    cs[k] = cx * s[0] + cy * s[1] + cz * s[2];
    cv[k] = cx * v[0] + cy * v[1] + cz * v[2];
    all_pos = all_pos && cw[k] > kEps;
    all_neg = all_neg && cw[k] < -kEps;
    all_le = all_le && cw[k] <= kEps;
  }
  const bool ok = A == kPrimary ? all_pos : (all_pos || all_neg);
  float ulo = 0.0f, uhi = 0.0f, vlo = 0.0f, vhi = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float cws = A == kPrimary ? clamp_min(cw[k], kEps)
                                    : (fabsf(cw[k]) > kEps ? cw[k] : kEps);
    const float pu = cs[k] / cws, pv = cv[k] / cws;
    ulo = k == 0 ? pu : nmin(ulo, pu);
    uhi = k == 0 ? pu : nmax(uhi, pu);
    vlo = k == 0 ? pv : nmin(vlo, pv);
    vhi = k == 0 ? pv : nmax(vhi, pv);
  }
  rect[b] = ok ? make_float4(widen_lo(ulo), widen_hi(uhi), widen_lo(vlo),
                             widen_hi(vhi))
               : make_float4(-kBig, kBig, -kBig, kBig);
  const bool empty = lo[0] > hi[0] || lo[1] > hi[1] || lo[2] > hi[2];
  flags[b] = (empty ? 1 : 0) | (A == kPrimary && all_le ? 2 : 0);
}

// Block-wide reductions over the CTA's threads; `red` holds kWarps values.
template <typename T, typename F>
__device__ T block_reduce(T x, F op, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = op(x, __shfl_xor_sync(0xFFFFFFFFu, x, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = op(r, red[i]);
  return r;
}

// One CTA a tile: its plan row [plan_w] (plan.py::cull_lists' layout),
// from test(b, tlo), the visibility of block b with its entry bound in tlo;
// the tile's origin in columns 4/5 where the grid org has one, and a row of
// zeros (but for the origin) where op's kLive says the tile is not live
// (plan.py::_rows_of).
template <typename Test>
__device__ __forceinline__ void plan_row(const Test& test, const Operands& op,
                                         Grid org, int nb, int wb, int maxv,
                                         int plan_w,
                                         float* __restrict__ scratch,
                                         int* __restrict__ plan) {
  extern __shared__ float s_wt[];
  __shared__ float s_redf[kWarps];
  __shared__ int s_redi[kWarps];
  __shared__ int s_rank[kTBuckets], s_b16[kTBuckets];
  __shared__ int s_cnt[kTBuckets + 1], s_off[kTBuckets + 1];
  __shared__ int s_run[kTBuckets + 1];
  __shared__ int s_warp[kWarps][kTBuckets + 1];
  __shared__ float s_tmin, s_qscale;

  const int tile = blockIdx.x;
  const int np = nb / wb;
  const int mv_cap = plan_w - srt::kPlanAux;
  float* wt = np <= kSmemWindows ? s_wt : scratch + (size_t)tile * np;
  int* row = plan + (size_t)tile * plan_w;
  const int px0 = org.tiles_x > 0 ? org.px0(tile) : 0;
  const int py0 = org.tiles_x > 0 ? org.py0(tile) : 0;
  if (op.p[kLive] &&
      !static_cast<const unsigned char*>(op.p[kLive])[tile * op.s0[kLive]]) {
    for (int p = threadIdx.x; p < plan_w; p += kThreads)
      row[p] = p == 4 ? px0 : p == 5 ? py0 : 0;
    return;
  }

  // pass 1: the tests, each window's least bound (+inf: not visible), and
  // the tile's first / last visible window, count, tmin and tmax
  int first = np, last = -1, cnt = 0;
  float tmn = INFINITY, tmx = -INFINITY;
  for (int w = threadIdx.x; w < np; w += kThreads) {
    float tw = INFINITY;
    bool vis = false;
    for (int j = 0; j < wb; ++j) {
      float tl;
      if (test(w * wb + j, tl)) {
        vis = true;
        tw = nmin(tw, tl);
      }
    }
    wt[w] = tw;
    if (vis) {
      first = min(first, w);
      last = max(last, w);
      ++cnt;
      tmn = fminf(tmn, tw);
      tmx = fmaxf(tmx, tw);
    }
  }
  first = block_reduce(first, [](int a, int b) { return min(a, b); }, s_redi);
  last = block_reduce(last, [](int a, int b) { return max(a, b); }, s_redi);
  cnt = block_reduce(cnt, [](int a, int b) { return a + b; }, s_redi);
  tmn = block_reduce(tmn, [](float a, float b) { return fminf(a, b); },
                     s_redf);
  tmx = block_reduce(tmx, [](float a, float b) { return fmaxf(a, b); },
                     s_redf);

  // the row's columns, the buckets' floors and their ranks
  const int maxv_c = min(maxv, mv_cap);
  if (threadIdx.x == 0) {
    const int range_cnt = max(last - first + 1, 0);
    row[0] = range_cnt > 0 ? first : 0;
    row[1] = range_cnt;
    row[2] = min(cnt, maxv_c);
    row[3] = cnt <= maxv_c ? 1 : 0;
    row[4] = px0;
    row[5] = py0;
    row[6] = row[7] = 0;
    const float tmin = fabsf(tmn) < INFINITY ? tmn : 0.0f;  // isfinite
    const float qscale = clamp_min(tmx - tmin, 1e-20f) / kTBuckets;
    s_tmin = tmin;
    s_qscale = qscale;
    int rank = 0;
    for (int q = 0; q < kTBuckets; ++q) {
      const float floor_t =
          clamp_min(tmin + static_cast<float>(q) * qscale, 0.0f);
      const int b16 = __float_as_int(floor_t) >> 16;
      if (q > 0 && b16 != s_b16[q - 1]) ++rank;
      s_b16[q] = b16;
      s_rank[q] = rank;
    }
  }
  if (threadIdx.x <= kTBuckets) s_cnt[threadIdx.x] = s_run[threadIdx.x] = 0;
  __syncthreads();
  const float tmin = s_tmin, qscale = s_qscale;

  // a visible window's bucket (plan.py::cull_lists' qb)
  auto bucket = [&](float tw) {
    const int qb = static_cast<int>((tw - tmin) / qscale);
    return min(max(qb, 0), kTBuckets - 1);
  };

  // pass 2: visible windows by rank
  const unsigned lane_lt = (1u << (threadIdx.x & 31)) - 1u;
  for (int w = threadIdx.x; w < np; w += kThreads) {
    const float tw = wt[w];
    if (tw < INFINITY) atomicAdd(&s_cnt[s_rank[bucket(tw)]], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int r = 0; r < kTBuckets; ++r) {
      s_off[r] = acc;
      acc += s_cnt[r];
    }
  }
  __syncthreads();

  // pass 3: each visible window's place, in window order within its rank
  const int k_emit = min(mv_cap, np);
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < np; base += kThreads) {
    const int w = base + threadIdx.x;
    int rank = kTBuckets, b16 = 0;  // kTBuckets: not visible
    if (w < np) {
      const float tw = wt[w];
      if (tw < INFINITY) {
        const int qb = bucket(tw);
        rank = s_rank[qb];
        b16 = s_b16[qb];
      }
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, rank);
    if (threadIdx.x < kWarps * (kTBuckets + 1))
      (&s_warp[0][0])[threadIdx.x] = 0;
    __syncthreads();
    if ((same & lane_lt) == 0) s_warp[warp][rank] = __popc(same);
    __syncthreads();
    if (rank < kTBuckets) {
      int pos = s_off[rank] + s_run[rank] + __popc(same & lane_lt);
      for (int i = 0; i < warp; ++i) pos += s_warp[i][rank];
      if (pos < k_emit) row[srt::kPlanAux + pos] = (b16 << 16) | w;
    }
    __syncthreads();
    if (threadIdx.x < kTBuckets) {
      int add = 0;
      for (int i = 0; i < kWarps; ++i) add += s_warp[i][threadIdx.x];
      s_run[threadIdx.x] += add;
    }
    __syncthreads();
  }

  // invisible keys after the visible ones, zeros past the windows
  for (int p = cnt + threadIdx.x; p < mv_cap; p += kThreads)
    row[srt::kPlanAux + p] = p < k_emit ? kInvisible : 0;
}

// plan.py::visibility_px / visibility_px_rev for a block of rect r and
// flags fl (plan_blocks_kernel); true without an apex test.
template <int A>
__device__ __forceinline__ bool apex_visible(const ApexTile& t,
                                             const float4* __restrict__ rect,
                                             const int* __restrict__ flags,
                                             int b) {
  if (A == kNoApex) return true;
  const float4 r = rect[b];
  const int fl = flags[b];
  return r.x <= t.ru_hi && r.y >= t.ru_lo && r.z <= t.rv_hi &&
         r.w >= t.rv_lo && !(fl & 1) && !((fl & 2) && !t.bad);
}

// The plan of the interval test (plan.py::visibility), one CTA a tile.
template <int A, bool Excl>
__global__ void __launch_bounds__(kThreads) plan_tiles_kernel(
    Operands op, Grid org, const float* __restrict__ bmin,
    const float* __restrict__ bmax, const int* __restrict__ bobj,
    const float4* __restrict__ rect, const int* __restrict__ flags, int nb,
    int wb, int maxv, int plan_w, float* __restrict__ scratch,
    int* __restrict__ plan) {
  const int tile = blockIdx.x;
  float o_lo[3], o_hi[3], d_lo[3], d_hi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o_lo[ax] = op.f(kOmin, tile, ax);
    o_hi[ax] = op.f(kOmax, tile, ax);
    d_lo[ax] = op.f(kDmin, tile, ax);
    d_hi[ax] = op.f(kDmax, tile, ax);
  }
  const ApexTile at = apex_tile<A>(op, tile);
  const int excl = excl_of<Excl>(op, tile);
  plan_row(
      [&](int b, float& tl) {
        return interval(o_lo, o_hi, d_lo, d_hi, bmin, bmax, b, tl) &&
               (!Excl || bobj[b] != excl) &&
               apex_visible<A>(at, rect, flags, b);
      },
      op, org, nb, wb, maxv, plan_w, scratch, plan);
}

// The plan of the hourglass test (plan.py::visibility_hourglass) of shadow
// rays with no shared light, one CTA a tile.
template <int A, bool Excl>
__global__ void __launch_bounds__(kThreads) plan_hourglass_kernel(
    Operands op, Grid org, const float* __restrict__ bmin,
    const float* __restrict__ bmax, const int* __restrict__ bobj,
    const float4* __restrict__ rect, const int* __restrict__ flags, int nb,
    int wb, int maxv, int plan_w, float* __restrict__ scratch,
    int* __restrict__ plan) {
  const int tile = blockIdx.x;
  float o_lo[3], o_hi[3], q_lo[3], q_hi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o_lo[ax] = op.f(kOmin, tile, ax);
    o_hi[ax] = op.f(kOmax, tile, ax);
    q_lo[ax] = op.f(kQmin, tile, ax);
    q_hi[ax] = op.f(kQmax, tile, ax);
  }
  const Hourglass h = hourglass_lines(o_lo, o_hi, q_lo, q_hi);
  const ApexTile at = apex_tile<A>(op, tile);
  const int excl = excl_of<Excl>(op, tile);
  plan_row(
      [&](int b, float& tl) {
        return hourglass(h, bmin, bmax, b, tl) &&
               (!Excl || bobj[b] != excl) &&
               apex_visible<A>(at, rect, flags, b);
      },
      op, org, nb, wb, maxv, plan_w, scratch, plan);
}

template <int A, bool Excl>
cudaError_t launch_tiles(const Operands& op, Grid org, bool hourglass,
                         const float* bmin, const float* bmax,
                         const int* bobj, const float4* rect,
                         const int* flags, int nb, int wb, int maxv,
                         int plan_w, int n_tiles, float* scratch, int* plan,
                         cudaStream_t stream) {
  const int np = nb / wb;
  const size_t smem = np <= kSmemWindows ? sizeof(float) * np : 0;
  if (hourglass)
    plan_hourglass_kernel<A, Excl><<<n_tiles, kThreads, smem, stream>>>(
        op, org, bmin, bmax, bobj, rect, flags, nb, wb, maxv, plan_w,
        scratch, plan);
  else
    plan_tiles_kernel<A, Excl><<<n_tiles, kThreads, smem, stream>>>(
        op, org, bmin, bmax, bobj, rect, flags, nb, wb, maxv, plan_w,
        scratch, plan);
  return cudaGetLastError();
}

template <int A>
cudaError_t build_plan(const Operands& op, Grid org, bool hourglass,
                       const float* bmin, const float* bmax, const int* bobj,
                       int nb, int wb, int maxv, int plan_w, int n_tiles,
                       void* blocks, float* scratch, int* out,
                       cudaStream_t stream) {
  float4* rect = nullptr;
  int* flags = nullptr;
  if (A != kNoApex) {
    rect = static_cast<float4*>(blocks);
    flags = reinterpret_cast<int*>(rect + nb);
    plan_blocks_kernel<A><<<(nb + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(bmin, bmax, op, nb, rect, flags);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return op.p[kExcl]
             ? launch_tiles<A, true>(op, org, hourglass, bmin, bmax, bobj,
                                     rect, flags, nb, wb, maxv, plan_w,
                                     n_tiles, scratch, out, stream)
             : launch_tiles<A, false>(op, org, hourglass, bmin, bmax, bobj,
                                      rect, flags, nb, wb, maxv, plan_w,
                                      n_tiles, scratch, out, stream);
}

// ---- The planners' bounds --------------------------------------------------
//
// O(tiles) work a frame, from the camera row cam [24] (plan.py::make_cam:
// A, B, C, origin, light, the shadow frame s, v, w) that K1 reads too.
// camera_kernel writes that row, its shadow frame reduced from the block
// tables; tile_bounds_kernel the primary tiles' bounds, one CTA (the frame
// is a sum over every tile's corners); shadow_bounds_kernel the hard-shadow
// tiles' bounds from K1's rows, a thread a tile.  Bound by launch and
// latency, a few flops a corner or a tile.

constexpr int kBoundsThreads = 1024;  // tile_bounds_kernel's one CTA
constexpr int kSumRows = 2048;        // corner rows summed in shared memory
                                      // (plan.py::SUM_SMEM_ROWS)
constexpr int kRowLen = 15;           // K1's bounds row (nearest.cu)

// plan.py::frame_of: (s, v, w) orthonormal, w along d ((0, 0, 1) where
// |d| <= 1e-20), s against the axis least aligned with w (the first such).
__device__ void frame_of(const float* d, float* s, float* v, float* w) {
  const float nw = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    w[c] = nw > 1e-20f ? d[c] / fmaxf(nw, 1e-20f) : (c == 2 ? 1.0f : 0.0f);
  int k = fabsf(w[1]) < fabsf(w[0]) ? 1 : 0;
  if (fabsf(w[2]) < fabsf(w[k])) k = 2;
  const float e0 = k == 0 ? 1.0f : 0.0f, e1 = k == 1 ? 1.0f : 0.0f,
              e2 = k == 2 ? 1.0f : 0.0f;
  s[0] = w[1] * e2 - w[2] * e1;
  s[1] = w[2] * e0 - w[0] * e2;
  s[2] = w[0] * e1 - w[1] * e0;
  const float ns = sqrtf(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) s[c] = s[c] / ns;
  v[0] = w[1] * s[2] - w[2] * s[1];
  v[1] = w[2] * s[0] - w[0] * s[2];
  v[2] = w[0] * s[1] - w[1] * s[0];
}

// plan.py::camera_plain: the row of make_cam, from the view V (rows 0-2,
// columns 0-3, strides vs0, vs1; null: the origin camera), the focal, the
// light L (null: 0, and a zero frame) and, for the frame, the centre of the
// block boxes (plan.py::shadow_frame).  One CTA.
__global__ void __launch_bounds__(kThreads) camera_kernel(
    const float* __restrict__ V, long long vs0, long long vs1, float focal,
    const float* __restrict__ L, long long ls, const float* __restrict__ bmin,
    const float* __restrict__ bmax, int nb, float* __restrict__ cam) {
  __shared__ float red[kWarps];
  float ctr[3];
  if (L) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float mn = INFINITY, mx = -INFINITY;
      for (int b = threadIdx.x; b < nb; b += kThreads) {
        mn = fminf(mn, bmin[b * 3 + c]);
        mx = fmaxf(mx, bmax[b * 3 + c]);
      }
      mn = block_reduce(mn, [](float a, float b) { return fminf(a, b); }, red);
      mx = block_reduce(mx, [](float a, float b) { return fmaxf(a, b); }, red);
      ctr[c] = 0.5f * (mn + mx);
    }
  }
  if (threadIdx.x != 0) return;
  float fr[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (L) {
    const float d[3] = {ctr[0] - L[0], ctr[1] - L[ls], ctr[2] - L[2 * ls]};
    frame_of(d, fr, fr + 3, fr + 6);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (V) {
      const float* vr = V + r * vs0;
      cam[r] = vr[0];
      cam[3 + r] = vr[vs1];
      cam[6 + r] = vr[2 * vs1] * focal;
      cam[9 + r] = vr[3 * vs1];
    } else {
      cam[r] = r == 0 ? 1.0f : 0.0f;
      cam[3 + r] = r == 1 ? 1.0f : 0.0f;
      cam[6 + r] = r == 2 ? focal : 0.0f;
      cam[9 + r] = 0.0f;
    }
    cam[12 + r] = L ? L[r * ls] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) cam[15 + i] = fr[i];
}

// plan.py::tile_bounds_plain's direction d [3] of tile t at pixel-rect
// corner k: (px0 + (k & 1) e, py0 + (k >> 1) e), e = tpx - 1.
__device__ __forceinline__ void corner_dir(const float* cam, const Grid& g,
                                           int t, int k, float* d) {
  const float px0 = static_cast<float>(g.px0(t));
  const float py0 = static_cast<float>(g.py0(t));
  const float e = static_cast<float>(g.tpx - 1);
  const float fx = (k & 1) ? px0 + e : px0;
  const float fy = (k & 2) ? py0 + e : py0;
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = fx * cam[c] + fy * cam[3 + c] + cam[6 + c];
}

// plan.py::tile_bounds_plain for n tiles, one CTA: the 4 n corner directions
// summed by plan.py::sum_rows' halvings (in `scratch` [12 n] while over
// kSumRows rows, then in shared memory), the frame of their sum, then each
// tile's box and rects.  out: s, v, w [9], dmin, dmax [n, 3], ru_lo, ru_hi,
// rv_lo, rv_hi, dw_hi [n]; tile_bad [n].
__global__ void __launch_bounds__(kBoundsThreads) tile_bounds_kernel(
    const float* __restrict__ cam_g, Grid g, int n, float* __restrict__ out,
    bool* __restrict__ tile_bad, float* __restrict__ scratch) {
  __shared__ float s_cam[9], s_f[9];
  __shared__ float s_sum[3 * kSumRows];
  if (threadIdx.x < 9) s_cam[threadIdx.x] = cam_g[threadIdx.x];
  __syncthreads();
  int m = 4 * n;
  float* x = m <= kSumRows ? s_sum : scratch;
  for (int r = threadIdx.x; r < m; r += kBoundsThreads)
    corner_dir(s_cam, g, r >> 2, r & 3, x + 3 * r);
  __syncthreads();
  while (m > 1) {  // rows [0, h) += rows [h, 2h); row 2h (m odd) -> row h
    const int h = m >> 1, next = h + (m & 1);
    float* y = x != s_sum && next <= kSumRows ? s_sum : x;
    for (int i = threadIdx.x; i < 3 * h; i += kBoundsThreads)
      y[i] = x[i] + x[i + 3 * h];
    __syncthreads();
    if ((m & 1) && threadIdx.x < 3)
      y[3 * h + threadIdx.x] = x[6 * h + threadIdx.x];
    __syncthreads();
    x = y;
    m = next;
  }
  if (threadIdx.x == 0) {
    frame_of(x, s_f, s_f + 3, s_f + 6);
    for (int i = 0; i < 9; ++i) out[i] = s_f[i];
  }
  __syncthreads();
  const float *s = s_f, *v = s_f + 3, *w = s_f + 6;
  float* dmin = out + 9;
  float* dmax = dmin + 3 * n;
  float* rect = dmax + 3 * n;  // ru_lo, ru_hi, rv_lo, rv_hi, dw_hi
  for (int t = threadIdx.x; t < n; t += kBoundsThreads) {
    float lo[3], hi[3], ru_lo = 0.0f, ru_hi = 0.0f, rv_lo = 0.0f, rv_hi = 0.0f,
                        dw_hi = 0.0f;
    bool any_bad = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float d[3];
      corner_dir(s_cam, g, t, k, d);
      const float dw = d[0] * w[0] + d[1] * w[1] + d[2] * w[2];
      const bool bad = dw <= kEps;
      const float dws = clamp_min(dw, kEps);
      const float ru = (d[0] * s[0] + d[1] * s[1] + d[2] * s[2]) / dws;
      const float rv = (d[0] * v[0] + d[1] * v[1] + d[2] * v[2]) / dws;
      const float ul = bad ? -kBig : ru, uh = bad ? kBig : ru;
      const float vl = bad ? -kBig : rv, vh = bad ? kBig : rv;
      const float dh = bad ? 0.0f : dw;
      ru_lo = k == 0 ? ul : nmin(ru_lo, ul);
      ru_hi = k == 0 ? uh : nmax(ru_hi, uh);
      rv_lo = k == 0 ? vl : nmin(rv_lo, vl);
      rv_hi = k == 0 ? vh : nmax(rv_hi, vh);
      dw_hi = k == 0 ? dh : nmax(dw_hi, dh);
      any_bad = any_bad || bad;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = k == 0 ? d[c] : nmin(lo[c], d[c]);
        hi[c] = k == 0 ? d[c] : nmax(hi[c], d[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dmin[t * 3 + c] = lo[c];
      dmax[t * 3 + c] = hi[c];
    }
    rect[t] = ru_lo;
    rect[n + t] = ru_hi;
    rect[2 * n + t] = rv_lo;
    rect[3 * n + t] = rv_hi;
    rect[4 * n + t] = dw_hi;
    tile_bad[t] = any_bad;
  }
}

// plan.py::analytic_shadow_bounds_exact for tile t of K1's rows [n, 15]
// (hit box 6, any hit, obj lo/hi, ru lo/hi, rv lo/hi, dw lo/hi) and the
// light of cam: out omin, omax, dmin, dmax [n, 3], ru_lo, ru_hi, rv_lo,
// rv_hi [n]; excl, live [n].
__global__ void __launch_bounds__(kThreads) shadow_bounds_kernel(
    const float* __restrict__ rows, int n, const float* __restrict__ cam,
    float* __restrict__ out, int* __restrict__ excl,
    bool* __restrict__ live) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const float* b = rows + (size_t)t * kRowLen;
  const bool ah = b[6] > 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float pmin = ah ? b[c] : 0.0f, pmax = ah ? b[3 + c] : 0.0f;
    out[t * 3 + c] = pmin;
    out[3 * n + t * 3 + c] = pmax;
    out[6 * n + t * 3 + c] = cam[12 + c] - pmax;
    out[9 * n + t * 3 + c] = cam[12 + c] - pmin;
  }
  const bool ok = ah && (b[13] > kEps || b[14] < -kEps);
  out[12 * n + t] = ok ? b[9] : -kBig;
  out[13 * n + t] = ok ? b[10] : kBig;
  out[14 * n + t] = ok ? b[11] : -kBig;
  out[15 * n + t] = ok ? b[12] : kBig;
  excl[t] = ah && b[7] == b[8] ? static_cast<int>(rintf(b[7])) : -2;
  live[t] = ah;
}

}  // namespace

// The plan [n_tiles, plan_w] i32 of windows of wb blocks over nb blocks
// (bmin, bmax [nb, 3] f32, bobj [nb] i32), from the operands `ops`: a host
// array of kNumOps (pointer, stride 0, stride 1) triples in the order of
// enum Op (a null pointer where unused; excl null: no own-object drop).
// apex: 0 none, 1 the primary-apex test, 2 the light-apex test; hourglass:
// 0 the interval test (omin, omax, dmin, dmax), 1 the hourglass test (omin,
// omax, qmin, qmax).  Columns 4/5: the origins of the tile grid (tiles_x,
// tile_px, half_w, half_h) (tiles_x 0: zeros).  Scratch: `blocks` [nb * 5]
// words (apex tests), `scratch` [n_tiles * nb / wb] f32 where nb / wb >
// kSmemWindows (plan.py::SMEM_WINDOWS).
extern "C" int srt_plan(const long long* ops, const void* bmin,
                        const void* bmax, const void* bobj, int nb, int wb,
                        int apex, int hourglass, int maxv, int plan_w,
                        int n_tiles, int tiles_x, int tile_px, int half_w,
                        int half_h, void* blocks, void* scratch, void* out,
                        void* stream) {
  if (nb <= 0 || wb <= 0 || nb % wb || nb / wb > 65536 || n_tiles < 0 ||
      plan_w <= srt::kPlanAux || apex < 0 || apex > 2 || hourglass < 0 ||
      hourglass > 1 || (apex && !blocks) ||
      (nb / wb > kSmemWindows && !scratch) || tiles_x < 0 ||
      (tiles_x > 0 && tile_px <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  Operands op;
  for (int i = 0; i < kNumOps; ++i) {
    op.p[i] = reinterpret_cast<const void*>(ops[3 * i]);
    op.s0[i] = ops[3 * i + 1];
    op.s1[i] = ops[3 * i + 2];
  }
  const auto* bn = static_cast<const float*>(bmin);
  const auto* bx = static_cast<const float*>(bmax);
  const auto* bo = static_cast<const int*>(bobj);
  auto* sc = static_cast<float*>(scratch);
  auto* pl = static_cast<int*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool hg = hourglass != 0;
  const Grid org{tiles_x, tile_px, half_w, half_h};
  cudaError_t e;
  if (apex == kPrimary)
    e = build_plan<kPrimary>(op, org, hg, bn, bx, bo, nb, wb, maxv, plan_w,
                             n_tiles, blocks, sc, pl, st);
  else if (apex == kLight)
    e = build_plan<kLight>(op, org, hg, bn, bx, bo, nb, wb, maxv, plan_w,
                           n_tiles, blocks, sc, pl, st);
  else
    e = build_plan<kNoApex>(op, org, hg, bn, bx, bo, nb, wb, maxv, plan_w,
                            n_tiles, blocks, sc, pl, st);
  return static_cast<int>(e);
}

// The frame's camera row cam [24] (plan.py::camera): view V f32 (rows 0-2,
// columns 0-3 at strides vs0, vs1; null: the origin camera), focal, light L
// [3] f32 at stride ls (null: no light and a zero shadow frame), the block
// boxes bmin, bmax [nb, 3] f32 for the shadow frame.  One launch.
extern "C" int srt_camera(const void* V, long long vs0, long long vs1,
                          float focal, const void* light, long long ls,
                          const void* bmin, const void* bmax, int nb,
                          void* cam, void* stream) {
  if (!cam || (light && (nb <= 0 || !bmin || !bmax)))
    return static_cast<int>(cudaErrorInvalidValue);
  camera_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(V), vs0, vs1, focal,
      static_cast<const float*>(light), ls, static_cast<const float*>(bmin),
      static_cast<const float*>(bmax), nb, static_cast<float*>(cam));
  return static_cast<int>(cudaGetLastError());
}

// The bounds of the n primary tiles of a width x height frame in tiles of
// tile_px (plan.py::tile_bounds) from the camera row cam [24]: out [9 + 11 n]
// f32 and tile_bad [n] (tile_bounds_kernel's layout); scratch [12 n] f32
// where 4 n > kSumRows (plan.py::SUM_SMEM_ROWS).  One launch.
extern "C" int srt_tile_bounds(const void* cam, int width, int height,
                               int tile_px, int n, void* out, void* tile_bad,
                               void* scratch, void* stream) {
  if (n <= 0 || n > (1 << 26) || tile_px <= 0 || width <= 0 || height <= 0 ||
      (4 * n > kSumRows && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{(width + tile_px - 1) / tile_px, tile_px, width / 2,
               height / 2};
  tile_bounds_kernel<<<1, kBoundsThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam), g, n, static_cast<float*>(out),
      static_cast<bool*>(tile_bad), static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// The hard-shadow bounds of n tiles (plan.py::shadow_bounds) from K1's rows
// [n, 15] f32 and the camera row cam [24]: out [16 n] f32, excl [n] i32,
// live [n] (shadow_bounds_kernel's layout).  One launch.
extern "C" int srt_shadow_bounds(const void* rows, int n, const void* cam,
                                 void* out, void* excl, void* live,
                                 void* stream) {
  if (n < 0 || n > (1 << 26)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  shadow_bounds_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), n, static_cast<const float*>(cam),
      static_cast<float*>(out), static_cast<int*>(excl),
      static_cast<bool*>(live));
  return static_cast<int>(cudaGetLastError());
}
