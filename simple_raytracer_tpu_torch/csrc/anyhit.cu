// The any-hit (occlusion) walks, one thread block per shadow tile.
//
// anyhit_from_t_kernel: hard-shadow occlusion rebuilt from the nearest pass.
// Replaces the TPU kernel simple_raytracer_tpu/kernels/tiled_t.py::
// _anyhit_kernel_t in its from-t form (reached through tiled_anyhit_from_t
// from anyhit_from_t) on the fused frame's path.  Plain PyTorch version:
// kernels/anyhit.py::tiled_anyhit_from_t_plain.  A shadow ray is rebuilt from
// its pixel, the nearest pass's t and the light: p = o + t*d (t pinned to 0
// on a miss), direction light - p, unnormalized.  Miss lanes start found = 1,
// so they never hold back the exit; callers mask them.
//
// anyhit_rays_kernel: the same walk over explicit rays (o, d, self object).
// Replaces the same TPU kernel in its rays-as-input form (reached through
// tiled_anyhit_t from anyhit) on the legacy hard-shadow and the soft-shadow
// paths.  Plain PyTorch version: kernels/anyhit.py::tiled_anyhit_plain.  A
// tile holds M rays (S light samples x ts points when folded); M need not be
// a multiple of the block size: lanes past M start found and are not written.
// With groups > 1 it replaces the TPU kernel tiled_t.py::_anyhit_kernel_g
// (K5, reached through tiled_anyhit_t with groups_ah > 1): the plan carries
// a 4-bit sub-group mask per entry (kernels/plan.py::group_mask_words); a
// sub-group of M / groups lanes skips the windows its bit clears, and the
// block stops once every group is all-found or has no window left.  Plain
// PyTorch version: kernels/anyhit.py::tiled_anyhit_grouped_plain.
//
// Both run anyhit_walk: each thread owns RPT rays, strided by the block size.
// For each plan entry the block stages the window's triangles and block
// object ids in shared memory; a ray skips a block of its own object (blocks
// are single-object by construction, accel/prepared.py) and tests the others
// with srt::occludes, the division-free Möller–Trumbore predicate, with no
// max-t unless configured (the reference's quirks, simple_raytracer.cpp:
// 321-342).  The block stops as soon as every ray has found an occluder
// (__syncthreads_and).
//
// What bounds them on the H100: the MT arithmetic of rays that stay
// unoccluded (they walk the whole plan), not memory: a window is 4.6 KB of
// triangles read once per tile, and a ray is read once.  The design drops the
// division of the nearest test, skips finished rays and own-object blocks per
// thread, and exits per tile; K5 also skips a window's staging when no
// group that still has an unoccluded ray may reach it.

#include "common.cuh"

namespace {

// Walk the tile's plan; found[r] |= "ray r meets a triangle of another
// object".  Ray r has origin h[r] and direction s[r].  kGrouped: lane r
// belongs to the sub-group of bit gbit[r]; a window is staged when some
// group with an unoccluded ray may reach it and tested only by such groups.
template <int RPT, bool kGrouped = false>
__device__ __forceinline__ void anyhit_walk(
    const srt::TilePlan& P, const float* __restrict__ tri,
    const int* __restrict__ block_obj, int n_windows, int wt, int bs,
    float eps, int no_max_t, const float* hx, const float* hy,
    const float* hz, const float* sx, const float* sy, const float* sz,
    const int* self_obj, bool* found, float* s_tri, int* s_bobj,
    const unsigned* gbit = nullptr) {
  const int wb = wt / bs;
  const unsigned full = (1u << P.groups) - 1u;
  unsigned done = 0;                             // groups all found
  for (int k = 0; k < P.cnt; ++k) {
    const int w = P.window(k);
    __syncthreads();                             // shared tables free
    if (w < 0 || w >= n_windows) continue;       // block-uniform
    const unsigned need = kGrouped ? P.gmask(k) & ~done & full : full;
    if (need) {                                  // block-uniform
      srt::stage(s_tri, tri + (size_t)w * wt * srt::kTriW, wt * srt::kTriW);
      for (int i = threadIdx.x; i < wb; i += blockDim.x)
        s_bobj[i] = block_obj[w * wb + i];
      __syncthreads();
      for (int j = 0; j < wt; ++j) {
        const int bo = s_bobj[j / bs];
        const srt::Tri g(s_tri + j * srt::kTriW);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if constexpr (kGrouped) {
            if (!(need & gbit[r])) continue;     // warp-uniform
          }
          if (found[r] || bo == self_obj[r]) continue;
          found[r] = srt::occludes(g, hx[r], hy[r], hz[r], sx[r], sy[r],
                                   sz[r], eps, no_max_t);
        }
      }
    }
    if constexpr (!kGrouped) {
      int all = 1;
#pragma unroll
      for (int r = 0; r < RPT; ++r) all &= found[r];
      if (__syncthreads_and(all)) break;
    } else {
      unsigned open = 0;                         // groups with a ray unfound
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        if (!found[r]) open |= gbit[r];
      for (int g = 0; g < P.groups; ++g)
        if (__syncthreads_and(!((open >> g) & 1u))) done |= 1u << g;
      if (done == full) break;
    }
  }
}

template <int RPT>
__global__ void anyhit_from_t_kernel(
    const int* __restrict__ plan, int plan_w, const float* __restrict__ tri,
    const int* __restrict__ block_obj, int n_windows,
    const float* __restrict__ t_in, const int* __restrict__ obj_in,
    const float* __restrict__ cam_g, int tile_px, int wt, int bs, float eps,
    int no_max_t, unsigned char* __restrict__ found_out) {
  extern __shared__ float s_tri[];        // wt * kTriW floats, then wt/bs ids
  int* s_bobj = reinterpret_cast<int*>(s_tri + wt * srt::kTriW);
  __shared__ float s_cam[srt::kCamLen];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int tile_r = nthr * RPT;
  for (int i = tid; i < srt::kCamLen; i += nthr) s_cam[i] = cam_g[i];
  __syncthreads();
  const srt::TilePlan P(plan, plan_w, tile);

  float hx[RPT], hy[RPT], hz[RPT], sx[RPT], sy[RPT], sz[RPT];
  int self_obj[RPT];
  bool found[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lane = tid + r * nthr;
    const size_t o = (size_t)tile * tile_r + lane;
    float dx, dy, dz;
    srt::ray_dir(s_cam, P.px0, P.py0, tile_px, lane, dx, dy, dz);
    const float t = t_in[o];
    const bool hit = isfinite(t);
    const float ts = hit ? t : 0.0f;
    hx[r] = s_cam[9] + ts * dx;
    hy[r] = s_cam[10] + ts * dy;
    hz[r] = s_cam[11] + ts * dz;
    sx[r] = s_cam[12] - hx[r];
    sy[r] = s_cam[13] - hy[r];
    sz[r] = s_cam[14] - hz[r];
    self_obj[r] = obj_in[o];
    found[r] = !hit;
  }
  anyhit_walk<RPT>(P, tri, block_obj, n_windows, wt, bs, eps, no_max_t, hx,
                   hy, hz, sx, sy, sz, self_obj, found, s_tri, s_bobj);
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    found_out[(size_t)tile * tile_r + tid + r * nthr] = found[r] ? 1 : 0;
}

// rays o, d [n, m, 3] f32 and self_obj [n, m] i32 -> found [n, m] u8;
// kGrouped: the plan carries masks for `groups` groups of m / groups lanes
template <int RPT, bool kGrouped>
__global__ void anyhit_rays_kernel(
    const int* __restrict__ plan, int plan_w, const float* __restrict__ tri,
    const int* __restrict__ block_obj, int n_windows,
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    const int* __restrict__ self_in, int m, int wt, int bs, float eps,
    int no_max_t, int groups, unsigned char* __restrict__ found_out) {
  extern __shared__ float s_tri[];        // wt * kTriW floats, then wt/bs ids
  int* s_bobj = reinterpret_cast<int*>(s_tri + wt * srt::kTriW);
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const srt::TilePlan P(plan, plan_w, tile, kGrouped ? groups : 1);

  float hx[RPT], hy[RPT], hz[RPT], sx[RPT], sy[RPT], sz[RPT];
  int self_obj[RPT];
  bool found[RPT];
  unsigned gbit[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lane = tid + r * nthr;
    const bool live = lane < m;
    const size_t o = (size_t)tile * m + (live ? lane : 0);
    hx[r] = o_in[3 * o + 0];
    hy[r] = o_in[3 * o + 1];
    hz[r] = o_in[3 * o + 2];
    sx[r] = d_in[3 * o + 0];
    sy[r] = d_in[3 * o + 1];
    sz[r] = d_in[3 * o + 2];
    self_obj[r] = self_in[o];
    found[r] = !live;                     // tail lanes never hold the exit
  }
  if constexpr (kGrouped) srt::group_bits<RPT>(m / groups, gbit);
  anyhit_walk<RPT, kGrouped>(P, tri, block_obj, n_windows, wt, bs, eps,
                             no_max_t, hx, hy, hz, sx, sy, sz, self_obj,
                             found, s_tri, s_bobj, gbit);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lane = tid + r * nthr;
    if (lane < m) found_out[(size_t)tile * m + lane] = found[r] ? 1 : 0;
  }
}

bool bad_launch(int threads, int wt, int bs) {
  return threads <= 0 || threads > 1024 || threads % 32 || bs <= 0 ||
         wt % bs;
}

size_t walk_smem(int wt, int bs) {
  return static_cast<size_t>(wt) * srt::kTriW * sizeof(float) +
         static_cast<size_t>(wt / bs) * sizeof(int);
}

}  // namespace

#define SRT_ANYHIT_CASE(R)                                                     \
  case R:                                                                      \
    anyhit_from_t_kernel<R><<<n_tiles, threads, smem, s>>>(                    \
        static_cast<const int*>(plan), plan_w,                                 \
        static_cast<const float*>(tri), static_cast<const int*>(block_obj),    \
        n_windows, static_cast<const float*>(t_in),                            \
        static_cast<const int*>(obj_in), static_cast<const float*>(cam),       \
        tile_px, wt, bs, eps, no_max_t,                                        \
        static_cast<unsigned char*>(found));                                   \
    break;

extern "C" int srt_anyhit_from_t(
    const void* plan, int plan_w, int n_tiles, const void* tri,
    const void* block_obj, int n_windows, const void* t_in,
    const void* obj_in, const void* cam, int tile_px, int wt, int bs,
    float eps, int no_max_t, void* found, int threads, void* stream) {
  if (n_tiles == 0) return 0;
  const int tile_r = tile_px * tile_px;
  if (bad_launch(threads, wt, bs) || tile_r % threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = walk_smem(wt, bs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_r / threads) {
    SRT_ANYHIT_CASE(1)
    SRT_ANYHIT_CASE(2)
    SRT_ANYHIT_CASE(4)
    SRT_ANYHIT_CASE(8)
    SRT_ANYHIT_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#define SRT_ANYHIT_RAYS_LAUNCH(R, G)                                           \
  anyhit_rays_kernel<R, G><<<n_tiles, threads, smem, s>>>(                     \
      static_cast<const int*>(plan), plan_w, static_cast<const float*>(tri),   \
      static_cast<const int*>(block_obj), n_windows,                           \
      static_cast<const float*>(o_in), static_cast<const float*>(d_in),        \
      static_cast<const int*>(self_in), m, wt, bs, eps, no_max_t, groups,      \
      static_cast<unsigned char*>(found))

#define SRT_ANYHIT_RAYS_CASE(R)                                                \
  case R:                                                                      \
    if (groups > 1)                                                            \
      SRT_ANYHIT_RAYS_LAUNCH(R, true);                                         \
    else                                                                       \
      SRT_ANYHIT_RAYS_LAUNCH(R, false);                                        \
    break;

extern "C" int srt_anyhit_rays(
    const void* plan, int plan_w, int n_tiles, const void* tri,
    const void* block_obj, int n_windows, const void* o_in, const void* d_in,
    const void* self_in, int m, int wt, int bs, float eps, int no_max_t,
    int groups, void* found, int threads, void* stream) {
  if (n_tiles == 0) return 0;
  if (bad_launch(threads, wt, bs) || m <= 0 || groups < 1 || groups > 4 ||
      m % groups || (groups > 1 && (m / groups) % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = walk_smem(wt, bs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (srt::rays_per_thread(m, threads)) {
    SRT_ANYHIT_RAYS_CASE(1)
    SRT_ANYHIT_RAYS_CASE(2)
    SRT_ANYHIT_RAYS_CASE(4)
    SRT_ANYHIT_RAYS_CASE(8)
    SRT_ANYHIT_RAYS_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
