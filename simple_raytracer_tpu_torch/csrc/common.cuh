// Shared device code of the tiled kernels (nearest.cu, anyhit.cu,
// prepass.cu).
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

// Sub-group bit of each of a thread's RPT lanes (lane = tid + r * nthr):
// groups of `glanes` consecutive lanes, a multiple of 32 (the wrappers
// check), so a group is whole warps and its skips and breaks are
// warp-uniform.
template <int RPT>
__device__ __forceinline__ void group_bits(int glanes, unsigned* gbit) {
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    gbit[r] = 1u << ((threadIdx.x + r * blockDim.x) / glanes);
}

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

// Rays per thread for a tile of `tile_r` rays over `threads` threads: the
// least of 1, 2, 4, 8, 16 that covers the tile (0 if none does).  The kernels
// are instantiated for these counts; lanes past the tile are masked.
inline int rays_per_thread(int tile_r, int threads) {
  for (int r = 1; r <= 16; r *= 2)
    if (r * threads >= tile_r) return r;
  return 0;
}

}  // namespace srt
