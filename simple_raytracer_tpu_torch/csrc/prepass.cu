// The bf16 classification walk (K3), one thread block per ray tile.
//
// prepass_kernel: for each position of the tile's plan, one flag: 1 when the
// window there may hold the nearest hit of some ray of the tile.  Replaces the
// TPU kernel simple_raytracer_tpu/kernels/tiled_t.py::_prepass_kernel_t
// (reached through tiled_prepass_t from hits with SRT_TILED_PREPASS=1; here
// KernelConfig.prepass).  Plain PyTorch version:
// kernels/prepass.py::tiled_prepass_plain.  The nearest walk then reruns only
// the flagged windows (kernels/prepass.py::refine_plan) and gives the same
// (t, idx) as the walk of the whole plan.
//
// Each ray's Gram features F = (d, o x d, o, 1) and each staged triangle's
// Gram factors G [10, 4] (accel/prepared.py::gram) are rounded to bf16, round
// to nearest even; the four MT numerators (det, u, v, t) of a pair are the
// f32 sums of the ten exact bf16 products, k = 0 to 9 in that order.  The
// error of each against the exact contraction is below
// PREPASS_M * sum_k |G_k| * alpha_k (alpha: the tile's largest |F_k|), the
// per-triangle margin the block computes once per window in f32.  A pair is
// confident-valid when every MT test holds over its whole error interval (its
// t upper bound then caps the ray's nearest t, best_hi) and maybe-valid when
// some value in the intervals passes them all; a window is flagged when some
// ray's maybe-valid pair has a t lower bound within best_hi (sign-uncertain
// determinants always).  The candidate test reads best_hi as it stood at the
// window's start (fresher than the TPU kernel's per-step value, and as
// sound).  A list row stops once every ray's best_hi is below the next
// entry's bound; range rows longer than the plan's entry count are not
// walked (refine_plan keeps their plans whole).
//
// The products are taken on CUDA cores (bf16 operands held as f32), so the
// plain version repeats them bit for bit; Hopper's tensor cores compute the
// same products (bf16 mma with f32 accumulation) and are later work.  What
// bounds it on the H100: f32 arithmetic, 96 additions, multiplications and
// divisions per pair (76 for the four ten-term sums, the rest the interval
// classification) besides its comparisons, not memory: a window is 10 KB of
// Gram rows read once per tile.  Each thread takes its lanes one at a time,
// rebuilding a lane's features at each window and keeping its best_hi in
// shared memory, so its registers (48, no spills) do not grow with the rays
// per thread; a tile holds at most 8,192 rays (32 KB of best_hi).

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

// Each thread walks the lanes tid, tid + blockDim.x, ... of the tile, one at
// a time: a lane's features are rebuilt from o, d at each window (a few
// dozen operations against the window's 64 x 96) and its best_hi lives in
// shared memory.
__global__ void prepass_kernel(const int* __restrict__ plan, int plan_w,
                               const float* __restrict__ gram, int n_windows,
                               const float* __restrict__ o_in,
                               const float* __restrict__ d_in, int m, int wt,
                               float eps, float margin,
                               unsigned char* __restrict__ flags_out) {
  extern __shared__ float s_g[];   // wt * 40 bf16-rounded G, wt * 4 margins,
  float* s_err = s_g + wt * kGramW;  // then m best_hi
  float* s_bh = s_err + wt * 4;
  __shared__ float s_red[srt::kMaxWarps][kFeat];
  __shared__ float s_alpha[kFeat];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const srt::TilePlan P(plan, plan_w, tile);
  const size_t ray0 = (size_t)tile * m;
  unsigned char* flags = flags_out + (size_t)tile * plan_w;
  for (int i = tid; i < plan_w; i += nthr) flags[i] = 0;

  // the tile's alpha_k = max |F_k| (f32 features)
  float fa[kFeat];
#pragma unroll
  for (int k = 0; k < kFeat; ++k) fa[k] = 0.0f;
  for (int lane = tid; lane < m; lane += nthr) {
    float f[kFeat];
    features(o_in, d_in, ray0 + lane, f);
#pragma unroll
    for (int k = 0; k < kFeat; ++k) fa[k] = fmaxf(fa[k], fabsf(f[k]));
    s_bh[lane] = INFINITY;
  }
  const int warp = tid >> 5, wl = tid & 31, nwarps = nthr >> 5;
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
    for (int i = 1; i < nwarps; ++i) v = fmaxf(v, s_red[i][tid]);
    s_alpha[tid] = v;
  }
  if (!P.use_list && P.cnt > P.mv) return;       // kept whole by refine_plan

  for (int k = 0; k < P.cnt; ++k) {
    const int w = P.window(k);
    __syncthreads();                             // shared tables free
    if (w < 0 || w >= n_windows) continue;       // block-uniform
    const float* gw = gram + (size_t)w * wt * kGramW;
    for (int i = tid; i < wt * kGramW; i += nthr) s_g[i] = bf16r(gw[i]);
    for (int i = tid; i < wt * 4; i += nthr) {
      const float* gj = gw + (i >> 2) * kGramW + (i & 3);
      float s = 0.0f;
      for (int f = 0; f < kFeat; ++f) s = s + fabsf(gj[4 * f]) * s_alpha[f];
      s_err[i] = margin * s;
    }
    __syncthreads();
    int cand_any = 0;
    for (int lane = tid; lane < m; lane += nthr) {
      float fb[kFeat];
      features(o_in, d_in, ray0 + lane, fb);
#pragma unroll
      for (int f = 0; f < kFeat; ++f) fb[f] = bf16r(fb[f]);
      const float b0 = s_bh[lane];               // best_hi at the window start
      float nb = b0;
      for (int j = 0; j < wt; ++j) {
        const float* G = s_g + j * kGramW;
        const float eD = s_err[4 * j + 0], eU = s_err[4 * j + 1],
                    eV = s_err[4 * j + 2], eT = s_err[4 * j + 3];
        float q[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float acc = G[c] * fb[0];
#pragma unroll
          for (int f = 1; f < kFeat; ++f) acc = acc + G[4 * f + c] * fb[f];
          q[c] = acc;
        }
        const float sgn = q[0] >= 0.0f ? 1.0f : -1.0f;
        const float adet = q[0] * sgn, un = q[1] * sgn, vn = q[2] * sgn,
                    tn = q[3] * sgn;
        const float uL = un - eU, uH = un + eU, vL = vn - eV, vH = vn + eV;
        const float tL = tn - eT, tH = tn + eT;
        const float aL = adet - eD, aH = adet + eD;
        const float conf_m = fminf(fminf(uL, vL),
                                   fminf(aL - (uH + vH), fminf(tL, aL - eps)));
        const float t_hi = tH / fmaxf(aL, 1e-30f);
        if (conf_m >= 0.0f && t_hi < nb) nb = t_hi;
        const float mb_m = fminf(fminf(uH, vH),
                                 fminf(aH - (uL + vL), fminf(tH, aH - eps)));
        cand_any |= (mb_m >= 0.0f && fmaxf(tL, 0.0f) <= b0 * aH) ||
                    (!(adet > eD) && aH >= eps);
      }
      s_bh[lane] = nb;
    }
    const int flag = __syncthreads_or(cand_any);
    if (tid == 0) flags[k] = flag ? 1 : 0;
    if (P.use_list && k + 1 < P.cnt) {
      const unsigned nb16 = P.bound16(k + 1);
      int ok = 1;
      for (int lane = tid; lane < m; lane += nthr)
        ok &= (__float_as_uint(s_bh[lane]) >> 16) < nb16;
      if (__syncthreads_and(ok)) break;
    }
  }
}

}  // namespace

extern "C" int srt_prepass(const void* plan, int plan_w, int n_tiles,
                           const void* gram, int n_windows, const void* o_in,
                           const void* d_in, int m, int wt, float eps,
                           float margin, void* flags, int threads,
                           void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem =
      (static_cast<size_t>(wt) * (kGramW + 4) + static_cast<size_t>(m)) *
      sizeof(float);
  if (threads <= 0 || threads > 1024 || threads % 32 || m <= 0 || wt <= 0 ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  prepass_kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(plan), plan_w, static_cast<const float*>(gram),
      n_windows, static_cast<const float*>(o_in),
      static_cast<const float*>(d_in), m, wt, eps, margin,
      static_cast<unsigned char*>(flags));
  return static_cast<int>(cudaGetLastError());
}
