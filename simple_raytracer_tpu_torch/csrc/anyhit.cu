// The any-hit (occlusion) walk, over one of two ray sources.
//
// Replaces the TPU kernel simple_raytracer_tpu/kernels/tiled_t.py::
// _anyhit_kernel_t in both its forms, tiled_t.py::_anyhit_kernel_g and
// kernels/tiled.py::_anyhit_kernel:
//
// * from t (K2, srt_anyhit_from_t; reached through tiled_anyhit_from_t from
//   anyhit_from_t on the fused frame's path; plain version kernels/
//   anyhit.py::tiled_anyhit_from_t_plain): each shadow ray is rebuilt from
//   its pixel, the nearest pass's t and the light, p = o + t*d (t pinned to
//   0 on a miss), direction light - p, unnormalized, its self object the
//   winner's.  Miss lanes start found = 1, so they never hold back an
//   item's exit; callers mask them.
// * explicit rays (srt_anyhit_rays): rays (o, d, self object) [n, m]; K2′
//   (reached through tiled_anyhit_t from anyhit, on the legacy hard-shadow,
//   soft-shadow and gather paths; plain version kernels/anyhit.py::
//   tiled_anyhit_plain), K5 (_anyhit_kernel_g, groups_ah > 1: the plan
//   carries a 4-bit sub-group mask per entry, kernels/plan.py::
//   group_mask_words; plain version tiled_anyhit_grouped_plain) and K7
//   (page windows, reached through tiled_anyhit from the paged frame; plain
//   version kernels/paged.py::tiled_anyhit_plain).
//
// A tile holds m rays (tile_px^2 pixels; or S light samples x ts points
// when folded).  Both sources run the same two launches over work items
// (tile, ray slice, span), the schedule of nearest.cu's walks
// (srt::schedule_rows): anyhit_schedule_kernel starts found (0, or from t
// !isfinite(t), so that a tile with an empty plan is complete after it) and
// lists the rows longest first; the persistent anyhit_items_kernel<RPT,
// Rays> walks the items, its rays taken from the source Rays.  A slice is
// min(512, the sub-group) lanes, so it lies in one sub-group and skips the
// entries whose mask bit that group lacks; lanes past the group are not
// live.  found is the OR of the same predicate over the same windows, so
// items may run in any order and the result is the plain walk's, bit for
// bit: an item stores 1 for each ray it finds occluded by a plain byte store
// (the race is benign: every writer writes 1), reads its rays' flags (past
// L1) when it starts and once a window, skips rays already found, and ends
// once all its live rays are found.
//
// Every walk skips a block of the ray's own object (blocks are
// single-object by construction, accel/prepared.py) and tests the others
// with srt::occludes, the division-free Möller–Trumbore predicate, with no
// max-t unless configured (the reference's quirks, simple_raytracer.cpp:
// 321-342).
//
// What bounds them on the H100: the MT arithmetic of rays that stay
// unoccluded (they walk the whole plan), not memory: a window is 4.6 KB of
// triangles read from L2, and a ray is read once.  A tile's plan can be
// hundreds of windows deep (a range row, or a tile whose shadow falls under
// a dense mesh), so one block per tile would leave a frame waiting on its
// deepest tile's SM: the items cut every walk to a span over one slice,
// longest first on all SMs, in CTAs of 256 threads, several to an SM,
// staging the next window with cp.async while the current one is tested.

#include "common.cuh"

namespace {

// The ray sources of the walk.  stage() runs once per CTA before the items
// (its writes are read after the item loop's first barrier); load() gives
// the ray of tile lane `lane`, element `o` = tile * m + lane of the [n, m]
// inputs.

// Explicit rays: o, d [n, m, 3] f32, self objects [n, m] i32.
struct RaysIn {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const int* __restrict__ self;
  __device__ void stage(float*) const {}
  __device__ __forceinline__ void load(const float*, const srt::TilePlan&,
                                       int, size_t i, float& hx, float& hy,
                                       float& hz, float& sx, float& sy,
                                       float& sz, int& so) const {
    hx = o[3 * i + 0];
    hy = o[3 * i + 1];
    hz = o[3 * i + 2];
    sx = d[3 * i + 0];
    sy = d[3 * i + 1];
    sz = d[3 * i + 2];
    so = self[i];
  }
};

// Shadow rays rebuilt from the nearest pass: t and the winner's object
// [n, tile_px^2], the camera and light cam [kCamLen] (kernels/plan.py::
// make_cam), the tile's pixel origin from its plan row.  The expressions
// and their order are tiled_anyhit_from_t_plain's (--fmad=false).
struct RaysFromT {
  const float* __restrict__ t;
  const int* __restrict__ obj;
  const float* __restrict__ cam;
  int tile_px;
  __device__ void stage(float* s_cam) const {
    for (int i = threadIdx.x; i < srt::kCamLen; i += blockDim.x)
      s_cam[i] = cam[i];
  }
  __device__ __forceinline__ void load(const float* s_cam,
                                       const srt::TilePlan& P, int lane,
                                       size_t i, float& hx, float& hy,
                                       float& hz, float& sx, float& sy,
                                       float& sz, int& so) const {
    float dx, dy, dz;
    srt::ray_dir(s_cam, P.px0, P.py0, tile_px, lane, dx, dy, dz);
    const float tv = t[i];
    const float ts = isfinite(tv) ? tv : 0.0f;
    hx = s_cam[9] + ts * dx;
    hy = s_cam[10] + ts * dy;
    hz = s_cam[11] + ts * dz;
    sx = s_cam[12] - hx;
    sy = s_cam[13] - hy;
    sz = s_cam[14] - hz;
    so = obj[i];
  }
};

// Every block starts found (n bytes, 4-byte aligned): 0, or with t_in
// !isfinite(t_in) (a miss lane starts found); block 0 (srt::kBuckets
// threads) lists the rows (srt::schedule_rows).
__global__ void __launch_bounds__(srt::kBuckets) anyhit_schedule_kernel(
    const int* __restrict__ plan, int plan_w, int n_tiles, int n_windows,
    srt::Spans spans, int rows_max, int* __restrict__ sched,
    const float* __restrict__ t_in, unsigned char* __restrict__ found,
    long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  for (long long i = i0; i < n / 4; i += stride) {
    unsigned v = 0u;
    if (t_in)
      for (int j = 0; j < 4; ++j)
        v |= static_cast<unsigned>(!isfinite(t_in[4 * i + j])) << (8 * j);
    reinterpret_cast<unsigned*>(found)[i] = v;
  }
  if (i0 < n % 4) {
    const long long k = n / 4 * 4 + i0;
    found[k] = t_in ? !isfinite(t_in[k]) : 0;
  }
  if (blockIdx.x != 0) return;
  srt::schedule_rows(plan, plan_w, n_tiles, n_windows, spans, rows_max,
                     sched);
}

// The persistent walk: each CTA takes the next item from sched[0]; item i
// is row i / slices, slice i % slices (srt::Slice).  Shared memory: two
// staged windows (triangles and block object ids), the next one in flight,
// and the camera of RaysFromT.
template <int RPT, class Rays>
__global__ void __launch_bounds__(srt::kItemThreads) anyhit_items_kernel(
    const int* __restrict__ plan, int plan_w, int groups,
    const float* __restrict__ tri, const int* __restrict__ block_obj,
    int n_windows, Rays rays, int m, int wt, int bs, float eps,
    int no_max_t, srt::Spans spans, int* __restrict__ sched,
    unsigned char* found) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                             // 2 x wt * kTriW
  int* s_bobj = reinterpret_cast<int*>(smem + 2 * wt * srt::kTriW);
  __shared__ int s_item;
  __shared__ float s_cam[srt::kCamLen];
  const int tid = threadIdx.x;
  const int wb = wt / bs;
  const int slices = srt::slices_per_tile(m, groups);
  const int items = sched[1] * slices;
  const int win_f = wt * srt::kTriW;
  rays.stage(s_cam);
  for (;;) {
    if (tid == 0) s_item = atomicAdd(&sched[0], 1);
    __syncthreads();
    const int item = s_item;
    if (item >= items) break;                    // block-uniform
    const int row = item / slices;
    const srt::Slice S(item - row * slices, m, groups);
    const int tile = sched[2 + 2 * row];
    const srt::TilePlan P(plan, plan_w, tile, groups);
    const int k0 = sched[3 + 2 * row] * spans.of(P);
    const int k1 = min(P.cnt, k0 + spans.of(P));
    const unsigned gbit = 1u << S.group;
    const size_t base = static_cast<size_t>(tile) * m + S.first;

    float hx[RPT], hy[RPT], hz[RPT], sx[RPT], sy[RPT], sz[RPT];
    int self_obj[RPT];
    bool open[RPT];                              // live and not yet found
    int done = 1;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int l = tid + r * srt::kItemThreads;
      const bool live = l < S.live;
      const int lane = S.first + (live ? l : 0);
      const size_t o = static_cast<size_t>(tile) * m + lane;
      rays.load(s_cam, P, lane, o, hx[r], hy[r], hz[r], sx[r], sy[r], sz[r],
                self_obj[r]);
      open[r] = live && !__ldcg(found + o);
      done &= !open[r];
    }
    if (__syncthreads_and(done)) continue;       // found by other items
    auto walks = [&](int k) {
      const int w = P.window(k);
      return w >= 0 && w < n_windows && (P.gmask(k) & gbit);
    };
    auto stage = [&](int k) {
      const int w = P.window(k), b = (k - k0) & 1;
      srt::stage_window_async(raw + b * win_f, tri, w, wt);
      for (int i = tid; i < wb; i += srt::kItemThreads)
        srt::cp_async4(s_bobj + b * wb + i, block_obj + w * wb + i);
      srt::cp_async_commit();
    };
    if (k0 < k1 && walks(k0)) stage(k0);
    for (int k = k0; k < k1; ++k) {
      const float* cur = raw + ((k - k0) & 1) * win_f;
      const int* cbo = s_bobj + ((k - k0) & 1) * wb;
      srt::cp_async_wait_all();
      __syncthreads();                           // window k landed
      if (k + 1 < k1 && walks(k + 1)) stage(k + 1);
      bool seen[RPT];                            // found by other items
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        seen[r] = open[r] && __ldcg(found + base + tid + r * srt::kItemThreads);
      if (walks(k)) {                            // block-uniform
        for (int j = 0; j < wt; ++j) {
          const int bo = cbo[j / bs];
          const srt::Tri g(cur + j * srt::kTriW);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            if (!open[r] || bo == self_obj[r]) continue;
            if (srt::occludes(g, hx[r], hy[r], hz[r], sx[r], sy[r], sz[r],
                              eps, no_max_t)) {
              open[r] = false;
              found[base + tid + r * srt::kItemThreads] = 1;
            }
          }
        }
      }
      done = 1;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        open[r] = open[r] && !seen[r];
        done &= !open[r];
      }
      if (__syncthreads_and(done)) break;
    }
    srt::cp_async_wait_all();                    // no copy outlives the item
    __syncthreads();             // s_item and the buffers free for the next
  }
}

size_t items_smem(int wt, int bs) {
  return 2 * (static_cast<size_t>(wt) * srt::kTriW * sizeof(float) +
              static_cast<size_t>(wt / bs) * sizeof(int));
}

template <int RPT, class Rays>
int launch_items(const void* plan, int plan_w, int groups, const void* tri,
                 const void* block_obj, int n_windows, Rays rays, int m,
                 int wt, int bs, float eps, int no_max_t, srt::Spans spans,
                 void* sched, void* found, cudaStream_t s) {
  const size_t smem = items_smem(wt, bs);
  anyhit_items_kernel<RPT, Rays>
      <<<srt::persistent_grid(anyhit_items_kernel<RPT, Rays>,
                              srt::kItemThreads, smem),
         srt::kItemThreads, smem, s>>>(
          static_cast<const int*>(plan), plan_w, groups,
          static_cast<const float*>(tri), static_cast<const int*>(block_obj),
          n_windows, rays, m, wt, bs, eps, no_max_t, spans,
          static_cast<int*>(sched), static_cast<unsigned char*>(found));
  return static_cast<int>(cudaGetLastError());
}

// The two launches of either source: `stages` 1 the schedule (found
// started from t_in, or zeroed without it), 2 the walk; 3 for both.
template <class Rays>
int anyhit_walk(const void* plan, int plan_w, int n_tiles, int groups,
                const void* tri, const void* block_obj, int n_windows,
                Rays rays, const float* t_in, int m, int wt, int bs,
                float eps, int no_max_t, void* found, void* sched,
                int rows_max, int range_span, int list_span, int stages,
                void* stream) {
  if (n_tiles == 0) return 0;
  if (m <= 0 || groups < 1 || groups > 4 || m % groups ||
      (groups > 1 && (m / groups) % 32) || bs <= 0 || wt % bs || wt % 4 ||
      srt::bad_spans(range_span, list_span) || items_smem(wt, bs) > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(tri) % 16 ||
      reinterpret_cast<uintptr_t>(found) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const srt::Spans spans{range_span, list_span};
  if (stages & 1) {
    const long long n = static_cast<long long>(n_tiles) * m;
    anyhit_schedule_kernel<<<srt::fill_blocks(n / 4, srt::kBuckets),
                             srt::kBuckets, 0, s>>>(
        static_cast<const int*>(plan), plan_w, n_tiles, n_windows, spans,
        rows_max, static_cast<int*>(sched), t_in,
        static_cast<unsigned char*>(found), n);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  if (stages & 2)
    return srt::slice_rays(m, groups) > srt::kItemThreads
               ? launch_items<2>(plan, plan_w, groups, tri, block_obj,
                                 n_windows, rays, m, wt, bs, eps, no_max_t,
                                 spans, sched, found, s)
               : launch_items<1>(plan, plan_w, groups, tri, block_obj,
                                 n_windows, rays, m, wt, bs, eps, no_max_t,
                                 spans, sched, found, s);
  return static_cast<int>(cudaGetLastError());
}

template <class Rays>
int shape(int wt, int bs, int m, int groups, int* out) {
  const int sr = srt::slice_rays(m, groups);
  const size_t smem = items_smem(wt, bs);
  return sr > srt::kItemThreads
             ? srt::walk_shape(anyhit_items_kernel<2, Rays>,
                               srt::kItemThreads, smem, sr, out)
             : srt::walk_shape(anyhit_items_kernel<1, Rays>,
                               srt::kItemThreads, smem, sr, out);
}

}  // namespace

// Hard-shadow occlusion of every tile of a fused frame: t, obj [n_tiles,
// tile_px^2] from the nearest pass, cam [kCamLen] the camera and light, the
// plan's columns 4/5 the tiles' pixel origins; windows of wt triangles (wt
// / bs blocks) -> found [n_tiles, tile_px^2] u8 (miss lanes 1).  Scratch and
// `stages` as srt_anyhit_rays.
extern "C" int srt_anyhit_from_t(
    const void* plan, int plan_w, int n_tiles, const void* tri,
    const void* block_obj, int n_windows, const void* t_in,
    const void* obj_in, const void* cam, int tile_px, int wt, int bs,
    float eps, int no_max_t, void* found, void* sched, int rows_max,
    int range_span, int list_span, int stages, void* stream) {
  if (tile_px <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const RaysFromT rays{static_cast<const float*>(t_in),
                       static_cast<const int*>(obj_in),
                       static_cast<const float*>(cam), tile_px};
  return anyhit_walk(plan, plan_w, n_tiles, 1, tri, block_obj, n_windows,
                     rays, static_cast<const float*>(t_in), tile_px * tile_px,
                     wt, bs, eps, no_max_t, found, sched, rows_max,
                     range_span, list_span, stages, stream);
}

// Occlusion of explicit rays o, d [n_tiles, m, 3] f32 with self objects
// [n_tiles, m] i32 over a plan of windows of wt triangles (wt / bs blocks)
// -> found [n_tiles, m] u8.  groups > 1: the plan carries the sub-group
// masks of `groups` groups of m / groups lanes (a multiple of 32).
// Scratch: sched [2 + 2 * rows_max] i32, rows_max at least n_tiles * (1 +
// max(n_windows / range_span, entries / list_span)).  `stages`: 1 schedule
// and zero found, 2 walk; 3 for both.
extern "C" int srt_anyhit_rays(
    const void* plan, int plan_w, int n_tiles, int groups, const void* tri,
    const void* block_obj, int n_windows, const void* o_in, const void* d_in,
    const void* self_in, int m, int wt, int bs, float eps, int no_max_t,
    void* found, void* sched, int rows_max, int range_span, int list_span,
    int stages, void* stream) {
  const RaysIn rays{static_cast<const float*>(o_in),
                    static_cast<const float*>(d_in),
                    static_cast<const int*>(self_in)};
  return anyhit_walk(plan, plan_w, n_tiles, groups, tri, block_obj,
                     n_windows, rays, nullptr, m, wt, bs, eps, no_max_t,
                     found, sched, rows_max, range_span, list_span, stages,
                     stream);
}

// The walk on this card for windows of wt triangles (wt / bs blocks) and m
// rays a tile in `groups` sub-groups: out = (CTAs per SM, registers per
// thread, SMs, rays per slice, threads per CTA); over explicit rays, or
// from t (srt_anyhit_from_t_shape, one group).
extern "C" int srt_anyhit_rays_shape(int wt, int bs, int m, int groups,
                                     int* out) {
  return shape<RaysIn>(wt, bs, m, groups, out);
}

extern "C" int srt_anyhit_from_t_shape(int wt, int bs, int m, int* out) {
  return shape<RaysFromT>(wt, bs, m, 1, out);
}
