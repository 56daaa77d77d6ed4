// The bf16 classification walk (K3), as work items.
//
// For each position of a tile's plan, one flag: 1 when the window there may
// hold the nearest hit of some ray of the tile.  Replaces the TPU kernel
// simple_raytracer_tpu/kernels/tiled_t.py::_prepass_kernel_t (reached
// through tiled_prepass_t from hits with SRT_TILED_PREPASS=1; here
// KernelConfig.prepass).  Plain PyTorch version, a model of the items:
// kernels/prepass.py::tiled_prepass_plain.  The nearest walk then reruns
// only the flagged windows (kernels/prepass.py::refine_plan) and gives the
// same (t, idx) as the walk of the whole plan.
//
// Each ray's Gram features F = (d, o x d, o, 1) and each staged triangle's
// Gram factors G [10, 4] (accel/prepared.py::gram) are rounded to bf16, round
// to nearest even; the four MT numerators (det, u, v, t) of a pair are the
// f32 sums of the ten bf16 products, k = 0 to 9 in that order.  A product of
// two bf16 values (8 significant bits each) is exact in f32, so each sum is
// written as a product and nine __fmaf_rn: the same roundings as separate
// multiplies and adds (and as the plain version), in fewer instructions.
// The error of each sum against the exact contraction is below
// PREPASS_M * sum_k |G_k| * alpha_k (alpha: the largest |F_k| of the item's
// rays), the per-triangle margin staged once per window in f32.  A pair is
// confident-valid when every MT test holds over its whole error interval
// (its t upper bound then caps the ray's nearest t, best_hi) and
// maybe-valid when some value in the intervals passes them all; a window is
// flagged when some ray's maybe-valid pair has a t lower bound within
// best_hi as it stood at the window's start (sign-uncertain determinants
// always).
//
// Two launches over work items (tile, ray slice, span), on the schedule of
// the other walks (srt::schedule_rows).  prepass_schedule_kernel zeroes the
// flags and lists the (tile, span) rows longest first: range rows in spans
// of range_span windows, lists in spans of list_span entries
// (kernels/prepass.py PREPASS_RANGE_SPAN, PREPASS_LIST_SPAN), and no row for
// a range row longer than the plan's entries (refine_plan keeps its plan
// whole).  prepass_items_kernel<RPT> is a persistent grid of 256-thread
// CTAs; each takes the next item, a row times a slice of min(512, M) lanes
// (srt::Slice).  It loads its RPT rays a thread once (their bf16 features
// and best_hi in registers), takes alpha over its live rays (one block
// reduction), and walks its span from best_hi = +inf: per window it stages
// bf16(G) and the four margins in shared memory and tests every ray against
// each triangle, reading the triangle's 40 factors once for its RPT rays;
// t_hi is divided only for confident pairs.  A list span stops once every
// live ray's best_hi is below the next entry's bound.  A window's flag is an
// OR of byte stores (one thread of each item that flags it stores 1; the
// race is benign, every writer writes 1), so items run in any order and the
// result is deterministic.
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores, about 70
// instructions a ray-triangle pair (40 for the four ten-term sums, the rest
// the interval classification), not memory: a window is 10 KB of Gram rows
// read from L2 once per item.  One block per tile would leave a frame
// waiting on its deepest tile's SM; the items cut every walk to a span over
// one slice, longest first on all SMs.  Per-slice alpha is sound (every ray
// of the slice has |F_k| <= alpha_k) and tighter than the tile's; each span
// starting from best_hi = +inf flags more windows than one walk of the
// whole row would, which the refined nearest walk then pays for.  The
// products could take the tensor cores (bf16 mma with f32 accumulation),
// but their accumulation order would break the flags' equality with the
// plain version: later work.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kGramW = 40;   // Gram factors per triangle: 10 features x 4
constexpr int kFeat = 10;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The f32 features F = (d, o x d, o, 1) of ray `ray`.
__device__ __forceinline__ void features(const float* __restrict__ o_in,
                                         const float* __restrict__ d_in,
                                         size_t ray, float* f) {
  const float ox = o_in[3 * ray + 0], oy = o_in[3 * ray + 1],
              oz = o_in[3 * ray + 2];
  const float dx = d_in[3 * ray + 0], dy = d_in[3 * ray + 1],
              dz = d_in[3 * ray + 2];
  f[0] = dx;
  f[1] = dy;
  f[2] = dz;
  f[3] = oy * dz - oz * dy;
  f[4] = oz * dx - ox * dz;
  f[5] = ox * dy - oy * dx;
  f[6] = ox;
  f[7] = oy;
  f[8] = oz;
  f[9] = 1.0f;
}

// Every block zeroes flags (n bytes, 4-byte aligned); block 0
// (srt::kBuckets threads) lists the rows, none for a range row longer than
// the plan's entries.
__global__ void __launch_bounds__(srt::kBuckets) prepass_schedule_kernel(
    const int* __restrict__ plan, int plan_w, int n_tiles, int n_windows,
    srt::Spans spans, int rows_max, int* __restrict__ sched,
    unsigned char* __restrict__ flags, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  for (long long i = i0; i < n / 4; i += stride)
    reinterpret_cast<unsigned*>(flags)[i] = 0u;
  if (i0 < n % 4) flags[n / 4 * 4 + i0] = 0;
  if (blockIdx.x != 0) return;
  srt::schedule_rows(plan, plan_w, n_tiles, n_windows, spans, rows_max,
                     sched, plan_w - srt::kPlanAux);
}

// The persistent walk: each CTA takes the next item from sched[0]; item i
// is row i / slices, slice i % slices.  Shared memory: the window's
// bf16(G) as wt x 10 float4 (feature k's factors of det, u, v, t), then its
// wt margins as float4.
template <int RPT>
__global__ void __launch_bounds__(srt::kItemThreads) prepass_items_kernel(
    const int* __restrict__ plan, int plan_w, const float* __restrict__ gram,
    int n_windows, const float* __restrict__ o_in,
    const float* __restrict__ d_in, int m, int wt, float eps, float margin,
    srt::Spans spans, int* __restrict__ sched,
    unsigned char* __restrict__ flags) {
  extern __shared__ __align__(16) float smem[];
  float4* s_g = reinterpret_cast<float4*>(smem);
  float4* s_err = s_g + wt * kFeat;
  __shared__ float s_red[srt::kItemThreads / 32][kFeat];
  __shared__ float s_alpha[kFeat];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int slices = srt::slices_per_tile(m, 1);
  const int items = sched[1] * slices;
  for (;;) {
    if (tid == 0) s_item = atomicAdd(&sched[0], 1);
    __syncthreads();
    const int item = s_item;
    if (item >= items) break;                    // block-uniform
    const int row = item / slices;
    const srt::Slice S(item - row * slices, m, 1);
    const int tile = sched[2 + 2 * row];
    const srt::TilePlan P(plan, plan_w, tile);
    const int k0 = sched[3 + 2 * row] * spans.of(P);
    const int k1 = min(P.cnt, k0 + spans.of(P));
    const size_t base = static_cast<size_t>(tile) * m + S.first;

    // the item's rays, once: bf16 features, best_hi, alpha over live rays
    float fb[RPT][kFeat], bh[RPT], fa[kFeat];
    bool live[RPT];
#pragma unroll
    for (int k = 0; k < kFeat; ++k) fa[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int l = tid + r * srt::kItemThreads;
      live[r] = l < S.live;
      float f[kFeat];
      features(o_in, d_in, base + (live[r] ? l : 0), f);
#pragma unroll
      for (int k = 0; k < kFeat; ++k) {
        if (live[r]) fa[k] = fmaxf(fa[k], fabsf(f[k]));
        fb[r][k] = bf16r(f[k]);
      }
      bh[r] = INFINITY;
    }
    const int warp = tid >> 5, wl = tid & 31;
#pragma unroll
    for (int k = 0; k < kFeat; ++k) {
      float v = fa[k];
      for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (wl == 0) s_red[warp][k] = v;
    }
    __syncthreads();
    if (tid < kFeat) {
      float v = s_red[0][tid];
      for (int i = 1; i < srt::kItemThreads / 32; ++i)
        v = fmaxf(v, s_red[i][tid]);
      s_alpha[tid] = v;
    }

    for (int k = k0; k < k1; ++k) {
      const int w = P.window(k);
      if (w < 0 || w >= n_windows) continue;     // block-uniform
      __syncthreads();                           // tables free, alpha set
      const float* gw = gram + static_cast<size_t>(w) * wt * kGramW;
      float* sg = reinterpret_cast<float*>(s_g);
      for (int i = tid; i < wt * kGramW; i += srt::kItemThreads)
        sg[i] = bf16r(gw[i]);
      float* se = reinterpret_cast<float*>(s_err);
      for (int i = tid; i < wt * 4; i += srt::kItemThreads) {
        const float* gj = gw + (i >> 2) * kGramW + (i & 3);
        float s = 0.0f;
        for (int f = 0; f < kFeat; ++f) s = s + fabsf(gj[4 * f]) * s_alpha[f];
        se[i] = margin * s;
      }
      __syncthreads();
      float nb[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) nb[r] = bh[r];
      int cand = 0;
      for (int j = 0; j < wt; ++j) {
        const float4* G = s_g + j * kFeat;
        float4 q[RPT];
        {
          const float4 g = G[0];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            q[r] = make_float4(g.x * fb[r][0], g.y * fb[r][0],
                               g.z * fb[r][0], g.w * fb[r][0]);
        }
#pragma unroll
        for (int f = 1; f < kFeat; ++f) {
          const float4 g = G[f];
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            q[r].x = __fmaf_rn(g.x, fb[r][f], q[r].x);
            q[r].y = __fmaf_rn(g.y, fb[r][f], q[r].y);
            q[r].z = __fmaf_rn(g.z, fb[r][f], q[r].z);
            q[r].w = __fmaf_rn(g.w, fb[r][f], q[r].w);
          }
        }
        const float4 e = s_err[j];               // margins of det, u, v, t
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float sgn = q[r].x >= 0.0f ? 1.0f : -1.0f;
          const float adet = q[r].x * sgn, un = q[r].y * sgn,
                      vn = q[r].z * sgn, tn = q[r].w * sgn;
          const float uL = un - e.y, uH = un + e.y, vL = vn - e.z,
                      vH = vn + e.z;
          const float tL = tn - e.w, tH = tn + e.w;
          const float aL = adet - e.x, aH = adet + e.x;
          const float conf_m = fminf(
              fminf(uL, vL), fminf(aL - (uH + vH), fminf(tL, aL - eps)));
          if (conf_m >= 0.0f) {
            const float t_hi = tH / fmaxf(aL, 1e-30f);
            if (t_hi < nb[r]) nb[r] = t_hi;
          }
          const float mb_m = fminf(
              fminf(uH, vH), fminf(aH - (uL + vL), fminf(tH, aH - eps)));
          cand |= live[r] &&
                  ((mb_m >= 0.0f && fmaxf(tL, 0.0f) <= bh[r] * aH) ||
                   (!(adet > e.x) && aH >= eps));
        }
      }
      if (__syncthreads_or(cand) && tid == 0)
        flags[static_cast<size_t>(tile) * plan_w + k] = 1;
#pragma unroll
      for (int r = 0; r < RPT; ++r) bh[r] = nb[r];
      if (P.use_list && k + 1 < k1) {
        const unsigned nb16 = P.bound16(k + 1);
        int ok = 1;
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          ok &= !live[r] || (__float_as_uint(bh[r]) >> 16) < nb16;
        if (__syncthreads_and(ok)) break;
      }
    }
    __syncthreads();             // s_item and the tables free for the next
  }
}

size_t items_smem(int wt) {
  return static_cast<size_t>(wt) * (kGramW + 4) * sizeof(float);
}

template <int RPT>
int launch_items(const void* plan, int plan_w, const void* gram,
                 int n_windows, const void* o_in, const void* d_in, int m,
                 int wt, float eps, float margin, srt::Spans spans,
                 void* sched, void* flags, cudaStream_t s) {
  const size_t smem = items_smem(wt);
  prepass_items_kernel<RPT>
      <<<srt::persistent_grid(prepass_items_kernel<RPT>, srt::kItemThreads,
                              smem),
         srt::kItemThreads, smem, s>>>(
          static_cast<const int*>(plan), plan_w,
          static_cast<const float*>(gram), n_windows,
          static_cast<const float*>(o_in), static_cast<const float*>(d_in),
          m, wt, eps, margin, spans, static_cast<int*>(sched),
          static_cast<unsigned char*>(flags));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Window flags of every tile: plan [n_tiles, plan_w] i32 over windows of wt
// triangles, gram [n_windows * wt, 40] f32, rays o, d [n_tiles, m, 3] f32
// -> flags [n_tiles, plan_w] u8.  Scratch: sched [2 + 2 * rows_max] i32,
// rows_max at least n_tiles * (1 + max(n_windows / range_span, (plan_w - 8)
// / list_span)).  `stages`: 1 schedule and zero flags, 2 walk; 3 for both.
extern "C" int srt_prepass(const void* plan, int plan_w, int n_tiles,
                           const void* gram, int n_windows, const void* o_in,
                           const void* d_in, int m, int wt, float eps,
                           float margin, void* flags, void* sched,
                           int rows_max, int range_span, int list_span,
                           int stages, void* stream) {
  if (n_tiles == 0) return 0;
  if (m <= 0 || wt <= 0 || plan_w <= srt::kPlanAux ||
      srt::bad_spans(range_span, list_span) || items_smem(wt) > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(flags) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const srt::Spans spans{range_span, list_span};
  if (stages & 1) {
    const long long n = static_cast<long long>(n_tiles) * plan_w;
    prepass_schedule_kernel<<<srt::fill_blocks(n / 4, srt::kBuckets),
                              srt::kBuckets, 0, s>>>(
        static_cast<const int*>(plan), plan_w, n_tiles, n_windows, spans,
        rows_max, static_cast<int*>(sched),
        static_cast<unsigned char*>(flags), n);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  if (stages & 2)
    return srt::slice_rays(m, 1) > srt::kItemThreads
               ? launch_items<2>(plan, plan_w, gram, n_windows, o_in, d_in, m,
                                 wt, eps, margin, spans, sched, flags, s)
               : launch_items<1>(plan, plan_w, gram, n_windows, o_in, d_in, m,
                                 wt, eps, margin, spans, sched, flags, s);
  return static_cast<int>(cudaGetLastError());
}

// The walk on this card for windows of wt triangles and m rays a tile: out
// = (CTAs per SM, registers per thread, SMs, rays per slice, threads per
// CTA).
extern "C" int srt_prepass_shape(int wt, int m, int* out) {
  const int sr = srt::slice_rays(m, 1);
  const size_t smem = items_smem(wt);
  return sr > srt::kItemThreads
             ? srt::walk_shape(prepass_items_kernel<2>, srt::kItemThreads,
                               smem, sr, out)
             : srt::walk_shape(prepass_items_kernel<1>, srt::kItemThreads,
                               smem, sr, out);
}
