// Shared device code of the tiled kernels (nearest.cu, anyhit.cu,
// prepass.cu): the plan row, the ray and triangle helpers, the occlusion
// predicate, and the work-item schedule and staging of the walks.
//
// Built with --fmad=false (kernels/build.py): every expression below rounds
// each multiply and add on its own, in the order written, which is the order
// of the plain PyTorch versions (ops/intersect.py, kernels/nearest.py,
// kernels/anyhit.py, kernels/prepass.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace srt {

constexpr int kPlanAux = 8;   // plan columns before the entries (kernels/plan.py)
constexpr int kCamLen = 24;   // A, B, C, origin, light, frame s, v, w
constexpr int kTriW = 9;      // v0, e1, e2 per triangle
constexpr int kMaxWarps = 32;

// One tile's row of the plan: columns (lo, range_cnt, list_cnt, use_list,
// px0, py0, 0, 0), then entries window | bound16 << 16 in walk order.  A
// grouped plan (groups > 1, kernels/plan.py::group_mask_words) holds
// mv = (plan_w - 8) * 8 / 9 entries, then one mask word per 8 entries: 4 bits
// per entry, bit g set when sub-group g of the tile's rays may reach the
// entry's window.
struct TilePlan {
  const int* row;
  int lo, cnt, mv, px0, py0, groups;
  bool use_list;

  __device__ TilePlan(const int* plan, int plan_w, int tile, int groups_ = 1)
      : row(plan + (size_t)tile * plan_w), groups(groups_) {
    lo = row[0];
    use_list = row[3] == 1;
    cnt = use_list ? row[2] : row[1];
    px0 = row[4];
    py0 = row[5];
    mv = groups > 1 ? (plan_w - kPlanAux) * 8 / 9 : plan_w - kPlanAux;
  }
  __device__ int entry(int k) const { return row[kPlanAux + min(k, mv - 1)]; }
  // list tiles walk their entries; range tiles the covering window range
  __device__ int window(int k) const {
    return use_list ? (entry(k) & 0xFFFF) : lo + k;
  }
  // top 16 bits of a non-negative f32 lower bound on every later hit's t
  __device__ unsigned bound16(int k) const {
    return static_cast<unsigned>(entry(k)) >> 16;
  }
  // bit g: sub-group g may reach entry k's window (every group for range
  // rows and ungrouped plans)
  __device__ unsigned gmask(int k) const {
    const unsigned full = (1u << groups) - 1u;
    if (groups <= 1 || !use_list) return full;
    const int kc = min(k, mv - 1);
    return (static_cast<unsigned>(row[kPlanAux + mv + kc / 8]) >>
            (4 * (kc % 8))) & full;
  }
};

// Primary ray of tile lane `lane`: d = fx * A + fy * B + C with (fx, fy)
// the pixel relative to the image centre (ops/camera.py::tile_ray_dirs).
__device__ __forceinline__ void ray_dir(const float* cam, int px0, int py0,
                                        int tile_px, int lane, float& dx,
                                        float& dy, float& dz) {
  const float fx = static_cast<float>(px0 + lane % tile_px);
  const float fy = static_cast<float>(py0 + lane / tile_px);
  dx = fx * cam[0] + fy * cam[3] + cam[6];
  dy = fx * cam[1] + fy * cam[4] + cam[7];
  dz = fx * cam[2] + fy * cam[5] + cam[8];
}

// Copy `n` floats from global to shared memory, block-strided.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// One staged triangle row: first vertex and the two edges.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
  __device__ explicit Tri(const float* g)
      : v0x(g[0]), v0y(g[1]), v0z(g[2]), e1x(g[3]), e1y(g[4]), e1z(g[5]),
        e2x(g[6]), e2y(g[7]), e2z(g[8]) {}
};

// The any-hit walks' occlusion predicate (both anyhit.cu kernels): does the
// ray o + t*d, t >= 0 (t <= 1 too unless no_max_t), meet the triangle?
// Division-free Möller–Trumbore on the numerators: u >= 0 <=> u_num*det >= 0,
// u <= 1 <=> |u_num| <= |det| given the sign test, likewise for u + v and t
// (ops/intersect.py::mt_numerators, mt_occludes).
__device__ __forceinline__ bool occludes(const Tri& g, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float eps, int no_max_t) {
  const float px = dy * g.e2z - dz * g.e2y;
  const float py = dz * g.e2x - dx * g.e2z;
  const float pz = dx * g.e2y - dy * g.e2x;
  const float det = g.e1x * px + g.e1y * py + g.e1z * pz;
  const float tx = ox - g.v0x, ty = oy - g.v0y, tz = oz - g.v0z;
  const float u_num = tx * px + ty * py + tz * pz;
  const float qx = ty * g.e1z - tz * g.e1y;
  const float qy = tz * g.e1x - tx * g.e1z;
  const float qz = tx * g.e1y - ty * g.e1x;
  const float v_num = dx * qx + dy * qy + dz * qz;
  const float t_num = g.e2x * qx + g.e2y * qy + g.e2z * qz;
  const float adet = fabsf(det);
  return adet >= eps && u_num * det >= 0.0f && fabsf(u_num) <= adet &&
         v_num * det >= 0.0f && fabsf(u_num + v_num) <= adet &&
         t_num * det >= 0.0f && (no_max_t || fabsf(t_num) <= adet);
}

// ---- Work items: the schedule shared by the walks of nearest.cu,
// anyhit.cu and prepass.cu (K1, nearest_rays, anyhit_rays, K3) ----
//
// A walk's work items are (tile, ray slice, span).  A row (tile, span) is a
// span of the tile's plan row: a range row's covering range in spans of
// `range` windows, a list in spans of `list` entries, each span walked from
// its own first entry.  One block of the schedule launch lists the rows
// longest first (a counting sort by walk length, on the device: the host
// reads nothing); each row is as many items as the tile has slices.

constexpr int kBuckets = 1024;     // span lengths 0..1023, a bucket each
constexpr int kItemThreads = 256;  // a CTA of the walks
constexpr int kItemSlice = 512;    // the most rays of one of their items

// The spans' length of a row, in entries (list) or windows (range).
struct Spans {
  int range, list;
  __device__ int of(const TilePlan& P) const {
    return P.use_list ? list : range;
  }
};

// Windows a row walks: its list, or its covering range clamped to the
// windows that exist (later ones are skipped by the walks anyway).
__device__ __forceinline__ int walk_len(const TilePlan& P, int n_windows) {
  return P.use_list ? P.cnt : min(P.cnt, max(0, n_windows - P.lo));
}

// Schedule bucket of a walk of `len` windows: ascending buckets are
// descending lengths.
__device__ __forceinline__ int bucket(int len) {
  return kBuckets - 1 - min(len, kBuckets - 1);
}

// Windows a row walks, none for a range row of more than `range_max`
// windows (K3 leaves those whole; the other walks pass no limit).
__device__ __forceinline__ int row_len(const TilePlan& P, int n_windows,
                                       int range_max) {
  return !P.use_list && P.cnt > range_max ? 0 : walk_len(P, n_windows);
}

// sched (int32): [0] the item counter (zeroed), [1] the rows, then (tile,
// span) per row, longest walk first; rows of equal length land in any
// order.  Run by one block of kBuckets threads: it counts the rows by walk
// length, scans the counts longest first and scatters the rows.
__device__ __forceinline__ void schedule_rows(const int* __restrict__ plan,
                                              int plan_w, int n_tiles,
                                              int n_windows, Spans spans,
                                              int rows_max,
                                              int* __restrict__ sched,
                                              int range_max = 0x7fffffff) {
  __shared__ int off[kBuckets];
  __shared__ int s_warp[kBuckets / 32];
  const int tid = threadIdx.x;
  off[tid] = 0;
  __syncthreads();
  for (int t = tid; t < n_tiles; t += kBuckets) {
    const TilePlan P(plan, plan_w, t);
    const int len = row_len(P, n_windows, range_max), span = spans.of(P);
    if (len <= 0) continue;
    const int full = len / span, rem = len - full * span;
    if (full) atomicAdd(&off[bucket(span)], full);
    if (rem) atomicAdd(&off[bucket(rem)], 1);
  }
  __syncthreads();
  // exclusive scan of off: warp scans, then a scan of the warp sums
  const int v = off[tid];
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if ((tid & 31) >= d) x += y;
  }
  if ((tid & 31) == 31) s_warp[tid >> 5] = x;
  __syncthreads();
  if (tid < 32) {
    int w = s_warp[tid];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (tid >= d) w += y;
    }
    s_warp[tid] = w;
  }
  __syncthreads();
  const int excl = x - v + (tid >= 32 ? s_warp[(tid >> 5) - 1] : 0);
  off[tid] = excl;
  if (tid == kBuckets - 1) {
    sched[0] = 0;
    sched[1] = min(excl + v, rows_max);
  }
  __syncthreads();
  for (int t = tid; t < n_tiles; t += kBuckets) {
    const TilePlan P(plan, plan_w, t);
    const int len = row_len(P, n_windows, range_max), span = spans.of(P);
    for (int s = 0; s * span < len; ++s) {
      const int pos = atomicAdd(&off[bucket(min(span, len - s * span))], 1);
      if (pos < rows_max) {
        sched[2 + 2 * pos] = t;
        sched[3 + 2 * pos] = s;
      }
    }
  }
}

// Rays of a work item over a tile of m explicit rays in `groups` sub-groups
// of m / groups lanes: slices of slice_r consecutive lanes (min(kItemSlice,
// the group rounded up to whole warps)) never cross a group.  Slice `sl` is
// group g = sl / per_group's lanes [first, first + live) ; its lanes past the
// group are not live.
__host__ __device__ __forceinline__ int slice_rays(int m, int groups) {
  const int glanes = (m / groups + 31) / 32 * 32;
  return glanes < kItemSlice ? glanes : kItemSlice;
}

__host__ __device__ __forceinline__ int slices_per_tile(int m, int groups) {
  const int sr = slice_rays(m, groups);
  return groups * ((m / groups + sr - 1) / sr);
}

struct Slice {
  int first, live, group;
  __device__ Slice(int sl, int m, int groups) {
    const int glanes = m / groups, sr = slice_rays(m, groups);
    const int per_group = (glanes + sr - 1) / sr;
    group = sl / per_group;
    const int j = sl - group * per_group;
    first = group * glanes + j * sr;
    live = min(sr, glanes - j * sr);
  }
};

// Asynchronous copies into shared memory (sm_80+): a window is staged while
// the one before it is tested.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying window w's triangle rows into dst (wt * kTriW floats, a
// multiple of 4: 16-byte copies; tri 16-byte aligned).  The caller commits.
__device__ __forceinline__ void stage_window_async(
    float* dst, const float* __restrict__ tri, int w, int wt) {
  const float* src = tri + static_cast<size_t>(w) * wt * kTriW;
  for (int i = threadIdx.x; i < wt * kTriW / 4; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i);
}

// ---- Host helpers of the launches ----

// Blocks of a grid-stride fill or decode of n elements, per_block a block.
inline int fill_blocks(long long n, int per_block) {
  const long long want = (n + per_block - 1) / per_block;
  return static_cast<int>(want < 1 ? 1 : want > 512 ? 512 : want);
}

// The persistent grid of `kernel`: as many CTAs as fit on every SM.
template <typename K>
int persistent_grid(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return per_sm * sms > 1 ? per_sm * sms : 1;
}

// out = (CTAs per SM, registers per thread, SMs, rays per slice, threads
// per CTA) of the walk `kernel` with `smem` bytes of dynamic shared memory.
template <typename K>
int walk_shape(K kernel, int threads, size_t smem, int slice_r, int* out) {
  int dev = 0;
  cudaFuncAttributes fa;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads,
                                                smem);
  cudaFuncGetAttributes(&fa, kernel);
  out[1] = fa.numRegs;
  out[3] = slice_r;
  out[4] = threads;
  return static_cast<int>(cudaGetLastError());
}

inline bool bad_spans(int range_span, int list_span) {
  return range_span < 1 || range_span >= kBuckets || list_span < 1 ||
         list_span >= kBuckets;
}

}  // namespace srt
