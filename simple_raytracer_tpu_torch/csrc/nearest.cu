// The nearest-hit walks.
//
// K1 (schedule_kernel, k1_walk_kernel, k1_epilogue_kernel<kMode>):
// nearest hit + fused Phong + per-tile shadow bounds, or, in its fetch
// mode, nearest hit + the winner's attribute row.  Replaces the TPU kernel
// simple_raytracer_tpu/kernels/tiled_t.py::_nearest_kernel_t, reached
// through tiled_nearest_t from hits_shaded (the fused modes, on the fused
// frame's path: flat, textured or smooth-normal scenes) and from hits_attrs
// and hits with cam_spec (the fetch mode, on the soft-shadow and sublane
// gather paths; the gather drops the attribute rows).  Plain PyTorch
// versions: kernels/nearest.py::tiled_nearest_shaded_plain and
// tiled_nearest_attrs_plain.  Every mode shares the walk and is one
// instance of the epilogue template (kMode), so their walks cannot drift
// apart.  Tiles are 64x64 or 32x32 pixels; rays are rebuilt from the pixel
// index and the camera constants, so no ray array exists.
//
// nearest_rays (schedule_kernel, rays_walk_kernel<RPT>,
// rays_decode_kernel<kFetch>): nearest hit (t, id) of explicit rays o, d
// [n, m, 3] over a plan of windows of wt consecutive triangles.  It replaces
// three TPU kernels: simple_raytracer_tpu/kernels/tiled.py::_nearest_kernel
// (K6: pages of page_tris triangles, reached through tiled_nearest from
// tiled_hits: tiled_impl="paged"; plain version kernels/paged.py::
// tiled_nearest_plain), tiled_t.py::_nearest_kernel_t over explicit rays
// (K1's rays mode: 64-triangle windows, the refined plan of the prepass
// walk and every range-only plan; plain version kernels/nearest.py::
// tiled_nearest_rays_plain; and its fetch mode over explicit rays, the
// decode also writing the winner's tri_attr row, reached through
// hits_attrs with no cam on the flat frames of hit_tile sub-tiles and of
// normalized directions; plain version tiled_nearest_rays_attrs_plain) and,
// with groups > 1, tiled_t.py::_nearest_kernel_g (K4: sub-groups of
// m / groups lanes skip the entries their mask bit clears and stop on
// their own bound test; plain version kernels/nearest.py::
// tiled_nearest_grouped_plain).  The TPU kernels compute their MT
// numerators as one Gram contraction per window; here they are the cross
// products of ops/intersect.py, as in K1.
//
// Both are three launches over work items (tile, ray slice, span).  The
// schedule launch fills one 64-bit key per ray with the miss key and, in
// its first block, lists the frame's rows (tile, span) longest first
// (srt::schedule_rows: a range row's covering range in spans of
// `range_span` windows, a list in spans of `list_span` entries, each walked
// from its own first entry with its own front-to-back break; with sound
// entry bounds the merged result is the whole list's, and
// kernels/nearest.py::walk_plain models the split exactly).  Each row is
// one item per slice of the tile's rays: K1's 512 lanes (a 64x8 strip of
// a 64-pixel tile); for explicit rays min(512, the sub-group) lanes, so
// a slice never crosses a sub-group and takes that group's mask bit and
// break.  The walk launch is a persistent grid, as many CTAs as fit on
// every SM, that take items from a device counter in that order; an item
// walks its span over its slice's rays, breaking on its own rays alone,
// and merges each found hit into the ray's key by atomicMin: key = bits(t)
// << 32 | id, exact and order-independent, ties to the lowest id.  The
// last launch decodes the keys (K1's epilogue, one block per tile, also
// runs the mode's fused epilogue and the tile's bounds row).
//
// The walks test Möller–Trumbore in f32 with each thread owning one or two
// rays of the slice, strided by the block size so a warp's rays (and its
// key updates) are adjacent; they keep the least t and, on equal t, the
// lowest triangle id, and stop a list span once every ray of the slice has
// its best t below the next entry's bound (misses, t = inf, never stop
// it).  K1's fused modes fetch the winner's flat normal and object id as
// one float4 load by id and evaluate the Phong term of the JAX kernel's
// _fused_phong (abs(n.l), the extra n.l on specular, pow through exp/log
// with the shininess-0 case); last, a block reduction writes the tile's
// 15-float bounds row: hit-point box, any-hit flag, object min/max and the
// ru/rv/dw extremes of the shadow directions in the shared frame.  The
// smooth mode first replaces the flat normal by normalize(cn + An p) from
// the winner's 48-byte tri_nrm_map row; the textured mode writes the Phong
// factors and the texel coordinates of its tri_tex_map row instead of rgb.
// The fetch mode instead stores the winner's tri_attr row as one float4.
//
// What bounds them on the H100: the MT arithmetic (about 45 f32 operations
// per ray-triangle pair with per-ray origins, 29 with one origin, plus an
// IEEE division, no contraction), not memory: a window is 2.3 KB (K1) or
// 4.6 KB (a K6 page), read from L2, each ray reads 24 bytes (explicit rays)
// and its key takes 8 more, in L2.  Tiles walk very unequal lengths (on a
// 1080p frame from none to 64 windows, a range row over a thousand), so one
// block per tile would leave a frame waiting on its deepest tiles' SMs; the
// items cut every walk to at most a span over one slice and run longest
// first on all SMs, in CTAs small enough for several per SM.  A walk stages
// the next window with cp.async while the current one is tested.  Where
// every ray of an item leaves one origin (K1; the primary rays of K4, K6
// and K1's rays mode, found per item on the card), the ray-independent
// terms of each triangle (tvec, qvec, t_num) are computed once, at staging,
// into shared memory: the same expressions on the same values, so t keeps
// every bit.  Tensor cores and TMA are left for later work.

#include "common.cuh"

namespace {

// K1's walk: CTAs of srt::kItemThreads threads x kK1Rpt rays over slices
// of srt::kItemSlice rays (kernels/nearest.py mirrors it as K1_SLICE)
constexpr int kK1Rpt = srt::kItemSlice / srt::kItemThreads;
constexpr int kTermW = 16;                       // floats of a staged term row
constexpr int kEpiThreads = 256;                 // an epilogue block
constexpr int kDecodeThreads = 256;              // a key-decode block
constexpr unsigned long long kMissKey = ~0ull;

constexpr int kBoundsW = 15;
// bounds slots reduced by max (the rest by min): p max xyz, any-hit,
// obj max, ru max, rv max, dw max
constexpr unsigned kBoundsMaxMask = 0x5578u;

__device__ __forceinline__ bool is_max_slot(int q) {
  return (kBoundsMaxMask >> q) & 1u;
}

// A hit as its key: t >= 0 (-0.0 packed as +0.0, whose bits sort first)
// over the id, so the unsigned minimum is the least t, then the lowest id.
__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  const unsigned tb = __float_as_uint(t == 0.0f ? 0.0f : t);
  return (static_cast<unsigned long long>(tb) << 32) |
         static_cast<unsigned>(id);
}

// Every block fills keys with the miss key; block 0 (srt::kBuckets threads)
// lists the rows (srt::schedule_rows).
__global__ void __launch_bounds__(srt::kBuckets) schedule_kernel(
    const int* __restrict__ plan, int plan_w, int n_tiles, int n_windows,
    srt::Spans spans, int rows_max, int* __restrict__ sched,
    unsigned long long* __restrict__ keys, long long n_keys) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_keys; i += stride)
    keys[i] = kMissKey;
  if (blockIdx.x != 0) return;
  srt::schedule_rows(plan, plan_w, n_tiles, n_windows, spans, rows_max,
                     sched);
}

// A staged triangle's ray-independent terms for the one origin o: e1, e2,
// tvec = o - v0, qvec = tvec x e1, t_num = e2 . qvec (ops/intersect.py's
// expressions, in its order), as four float4.
__device__ __forceinline__ void stage_terms(const float* g, float* out,
                                            float ox, float oy, float oz) {
  const srt::Tri T(g);
  const float tx = ox - T.v0x, ty = oy - T.v0y, tz = oz - T.v0z;
  const float qx = ty * T.e1z - tz * T.e1y;
  const float qy = tz * T.e1x - tx * T.e1z;
  const float qz = tx * T.e1y - ty * T.e1x;
  const float t_num = T.e2x * qx + T.e2y * qy + T.e2z * qz;
  float4* o4 = reinterpret_cast<float4*>(out);
  o4[0] = make_float4(T.e1x, T.e1y, T.e1z, T.e2x);
  o4[1] = make_float4(T.e2y, T.e2z, tx, ty);
  o4[2] = make_float4(tz, qx, qy, qz);
  o4[3] = make_float4(t_num, 0.0f, 0.0f, 0.0f);
}

// One staged term row, read as four float4.
struct Terms {
  float e1x, e1y, e1z, e2x, e2y, e2z, tx, ty, tz, qx, qy, qz, t_num;
  __device__ explicit Terms(const float* row) {
    const float4* g4 = reinterpret_cast<const float4*>(row);
    const float4 a = g4[0], b = g4[1], c = g4[2];
    e1x = a.x; e1y = a.y; e1z = a.z; e2x = a.w;
    e2y = b.x; e2z = b.y; tx = b.z; ty = b.w;
    tz = c.x; qx = c.y; qy = c.z; qz = c.w;
    t_num = g4[3].x;
  }
};

// Keep (t, id) in (bt, bi) when it is a valid hit nearer than the best, or
// as near with a lower id.
__device__ __forceinline__ void keep(float det, float u, float v, float t,
                                     int id, float eps, float& bt, int& bi) {
  const bool valid = fabsf(det) >= eps && u >= 0.0f && u <= 1.0f &&
                     v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
  if (valid && (t < bt || (t == bt && id < bi))) {
    bt = t;
    bi = id;
  }
}

// The nearest test of ray direction d against a term row (its origin's),
// in K1's order (v's products after the division).
__device__ __forceinline__ void test_terms(const Terms& T, int id, float eps,
                                           float dx, float dy, float dz,
                                           float& bt, int& bi) {
  const float px = dy * T.e2z - dz * T.e2y;
  const float py = dz * T.e2x - dx * T.e2z;
  const float pz = dx * T.e2y - dy * T.e2x;
  const float det = T.e1x * px + T.e1y * py + T.e1z * pz;
  const float u_num = T.tx * px + T.ty * py + T.tz * pz;
  const float inv = 1.0f / det;
  const float u = u_num * inv;
  const float v = (dx * T.qx + dy * T.qy + dz * T.qz) * inv;
  const float t = T.t_num * inv;
  keep(det, u, v, t, id, eps, bt, bi);
}

// The nearest test of ray o + t d against a staged triangle row: the same
// expressions as stage_terms + test_terms, per ray.
__device__ __forceinline__ void test_ray(const srt::Tri& g, int id, float eps,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& bt, int& bi) {
  const float px = dy * g.e2z - dz * g.e2y;
  const float py = dz * g.e2x - dx * g.e2z;
  const float pz = dx * g.e2y - dy * g.e2x;
  const float det = g.e1x * px + g.e1y * py + g.e1z * pz;
  const float tx = ox - g.v0x, ty = oy - g.v0y, tz = oz - g.v0z;
  const float u_num = tx * px + ty * py + tz * pz;
  const float qx = ty * g.e1z - tz * g.e1y;
  const float qy = tz * g.e1x - tx * g.e1z;
  const float qz = tx * g.e1y - ty * g.e1x;
  const float t_num = g.e2x * qx + g.e2y * qy + g.e2z * qz;
  const float inv = 1.0f / det;
  const float u = u_num * inv;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  const float t = t_num * inv;
  keep(det, u, v, t, id, eps, bt, bi);
}

// The front-to-back break of a list span after entry k: every live ray's
// best t (its top 16 bits; a logical shift, so -0.0 does not pass as small)
// below the next entry's bound.  Block-wide.
template <int RPT>
__device__ __forceinline__ bool past_bound(unsigned nb16, const float* bt,
                                           const bool* live) {
  int ok = 1;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    ok &= !live[r] || (__float_as_uint(bt[r]) >> 16) < nb16;
  return __syncthreads_and(ok);
}

// K1's persistent walk: each CTA takes the next item from sched[0] until
// none is left.  Item i is row i / slices, slice i % slices.  Shared
// memory: two staged windows (the next one in flight) and the current
// window's term rows.
__global__ void __launch_bounds__(srt::kItemThreads) k1_walk_kernel(
    const int* __restrict__ plan, int plan_w, const float* __restrict__ tri,
    int n_windows, const float* __restrict__ cam_g, int tile_px, int wt,
    float eps, srt::Spans spans, int* __restrict__ sched,
    unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                             // 2 x wt * kTriW
  float* terms = smem + 2 * wt * srt::kTriW;     // wt * kTermW
  __shared__ float s_cam[12];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  if (tid < 12) s_cam[tid] = cam_g[tid];
  const int tile_r = tile_px * tile_px;
  const int slice_r = min(tile_r, srt::kItemSlice);
  const int slices = tile_r / slice_r;
  const int items = sched[1] * slices;
  const int win_f = wt * srt::kTriW;
  for (;;) {
    if (tid == 0) s_item = atomicAdd(&sched[0], 1);
    __syncthreads();
    const int item = s_item;
    if (item >= items) break;                    // block-uniform
    const int row = item / slices, slice = item - row * slices;
    const int tile = sched[2 + 2 * row];
    const srt::TilePlan P(plan, plan_w, tile);
    const int k0 = sched[3 + 2 * row] * spans.of(P);
    const int k1 = min(P.cnt, k0 + spans.of(P));
    const float ox = s_cam[9], oy = s_cam[10], oz = s_cam[11];
    const int base = slice * slice_r;

    float dx[kK1Rpt], dy[kK1Rpt], dz[kK1Rpt], bt[kK1Rpt];
    int bi[kK1Rpt];
    bool live[kK1Rpt];
#pragma unroll
    for (int r = 0; r < kK1Rpt; ++r) {
      const int l = tid + r * srt::kItemThreads;
      live[r] = l < slice_r;
      srt::ray_dir(s_cam, P.px0, P.py0, tile_px, base + (live[r] ? l : 0),
                   dx[r], dy[r], dz[r]);
      bt[r] = INFINITY;
      bi[r] = -1;
    }
    auto exists = [&](int w) { return w >= 0 && w < n_windows; };
    if (k0 < k1 && exists(P.window(k0))) {
      srt::stage_window_async(raw, tri, P.window(k0), wt);
      srt::cp_async_commit();
    }
    for (int k = k0; k < k1; ++k) {
      const int w = P.window(k);                 // block-uniform
      float* cur = raw + ((k - k0) & 1) * win_f;
      srt::cp_async_wait_all();
      __syncthreads();           // window k landed; the term rows are free
      if (k + 1 < k1 && exists(P.window(k + 1))) {
        srt::stage_window_async(raw + ((k + 1 - k0) & 1) * win_f, tri,
                                P.window(k + 1), wt);
        srt::cp_async_commit();
      }
      if (exists(w)) {
        for (int j = tid; j < wt; j += srt::kItemThreads)
          stage_terms(cur + j * srt::kTriW, terms + j * kTermW, ox, oy, oz);
        __syncthreads();
        // the test_terms expressions written out: K1 keeps 48 registers
        // (5 CTAs an SM) this way, 57 through the helpers
        const int id0 = w * wt;
        for (int j = 0; j < wt; ++j) {
          const float4* g4 = reinterpret_cast<const float4*>(terms) +
                             j * (kTermW / 4);
          const float4 a = g4[0], b = g4[1], c = g4[2];
          const float e1x = a.x, e1y = a.y, e1z = a.z, e2x = a.w;
          const float e2y = b.x, e2z = b.y, tx = b.z, ty = b.w;
          const float tz = c.x, qx = c.y, qy = c.z, qz = c.w;
          const float t_num = g4[3].x;
          const int id = id0 + j;
#pragma unroll
          for (int r = 0; r < kK1Rpt; ++r) {
            const float px = dy[r] * e2z - dz[r] * e2y;
            const float py = dz[r] * e2x - dx[r] * e2z;
            const float pz = dx[r] * e2y - dy[r] * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const float u_num = tx * px + ty * py + tz * pz;
            const float inv = 1.0f / det;
            const float u = u_num * inv;
            const float v = (dx[r] * qx + dy[r] * qy + dz[r] * qz) * inv;
            const float t = t_num * inv;
            const bool valid = fabsf(det) >= eps && u >= 0.0f && u <= 1.0f &&
                               v >= 0.0f && u + v <= 1.0f && t >= 0.0f;
            if (valid && (t < bt[r] || (t == bt[r] && id < bi[r]))) {
              bt[r] = t;
              bi[r] = id;
            }
          }
        }
      }
      // the front-to-back break, on this slice's rays (logical shift: -0.0
      // must not pass as small)
      if (P.use_list && k + 1 < k1) {
        const unsigned nb16 = P.bound16(k + 1);
        int ok = 1;
#pragma unroll
        for (int r = 0; r < kK1Rpt; ++r)
          ok &= !live[r] || (__float_as_uint(bt[r]) >> 16) < nb16;
        if (__syncthreads_and(ok)) break;
      }
    }
    srt::cp_async_wait_all();                    // no copy outlives the item
#pragma unroll
    for (int r = 0; r < kK1Rpt; ++r)
      if (live[r] && bi[r] >= 0)
        atomicMin(&keys[static_cast<size_t>(tile) * tile_r + base + tid +
                        r * srt::kItemThreads],
                  hit_key(bt[r], bi[r]));
    __syncthreads();             // s_item and the buffers free for the next
  }
}

// K1's modes.  kFetch writes the winner's tri_attr row (flat normal, object
// id; (0, 0, 0, -1) on a miss) to attr_out and reads no mat, amap, obj,
// shade or bounds.  The fused modes are JAX _fused_phong's attribute modes:
// kFlat shades with the flat normal of tri_attr and writes rgb; kSmooth
// takes the normal normalize(cn + An p) from the winner's tri_nrm_map row
// and writes rgb; kTextured writes the colour-free Phong factors and the
// texel coordinates A p + c of the winner's tri_tex_map row, (dw, sw, texu,
// texv, obj, tex id), for the texel finish in kernels/tiled.py.  A map row
// is 12 floats, read as three float4 loads.
enum : int { kFetch = -1, kFlat = 0, kTextured = 1, kSmooth = 2 };

// One block per tile: each key decoded (a non-finite t, the miss key's
// among them, is a miss: t = inf, idx = -1), then the mode's outputs and,
// in the fused modes, the block reduction of the tile's bounds row.
template <int kMode>
__global__ void __launch_bounds__(kEpiThreads) k1_epilogue_kernel(
    const int* __restrict__ plan, int plan_w,
    const unsigned long long* __restrict__ keys,
    const float4* __restrict__ attr, const float* __restrict__ mat,
    int n_obj, const float* __restrict__ cam_g, int tile_px,
    int double_sided, int specular_nl, const float4* __restrict__ amap,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    int* __restrict__ obj_out, float* __restrict__ shade_out,
    float* __restrict__ bounds_out, float4* __restrict__ attr_out) {
  constexpr int kOutW = kMode == kTextured ? 6 : 3;   // shade_out columns
  __shared__ float s_cam[srt::kCamLen];
  __shared__ float s_red[srt::kMaxWarps][kBoundsW];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int tile_r = tile_px * tile_px;
  for (int i = tid; i < srt::kCamLen; i += kEpiThreads) s_cam[i] = cam_g[i];
  __syncthreads();
  const int px0 = plan[static_cast<size_t>(tile) * plan_w + 4];
  const int py0 = plan[static_cast<size_t>(tile) * plan_w + 5];
  const float ox = s_cam[9], oy = s_cam[10], oz = s_cam[11];
  const float Lx = s_cam[12], Ly = s_cam[13], Lz = s_cam[14];
  const float fsx = s_cam[15], fsy = s_cam[16], fsz = s_cam[17];
  const float fvx = s_cam[18], fvy = s_cam[19], fvz = s_cam[20];
  const float fwx = s_cam[21], fwy = s_cam[22], fwz = s_cam[23];
  float acc[kBoundsW];
#pragma unroll
  for (int q = 0; q < kBoundsW; ++q)
    acc[q] = is_max_slot(q) ? -INFINITY : INFINITY;
  acc[6] = 0.0f;                                 // any-hit flag

  for (int lane = tid; lane < tile_r; lane += kEpiThreads) {
    const size_t o = static_cast<size_t>(tile) * tile_r + lane;
    const unsigned long long key = keys[o];
    const float kt = __uint_as_float(static_cast<unsigned>(key >> 32));
    const bool hit = isfinite(kt);
    const float bt = hit ? kt : INFINITY;
    const int id = hit ? static_cast<int>(static_cast<unsigned>(key)) : -1;
    t_out[o] = bt;
    idx_out[o] = id;
    if constexpr (kMode == kFetch) {
      attr_out[o] = hit ? attr[id] : make_float4(0.0f, 0.0f, 0.0f, -1.0f);
      continue;
    }
    float dx, dy, dz;
    srt::ray_dir(s_cam, px0, py0, tile_px, lane, dx, dy, dz);
    float out[kOutW];
#pragma unroll
    for (int q = 0; q < kOutW; ++q) out[q] = 0.0f;
    if constexpr (kMode == kTextured) out[4] = out[5] = -1.0f;
    int obj = -1;
    if (hit) {
      const float4 a = attr[id];
      obj = static_cast<int>(a.w);
      const float t = bt;
      const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
      float nx = a.x, ny = a.y, nz = a.z;
      float4 m0, m1, m2;                         // the winner's map row
      if constexpr (kMode != kFlat) {
        const float4* row = amap + static_cast<size_t>(id) * 3;
        m0 = row[0];
        m1 = row[1];
        m2 = row[2];
      }
      if constexpr (kMode == kSmooth) {
        // cn = m0.xyz, An row-major from m0.w (JAX _fused_phong mode 2)
        nx = m0.x + m0.w * hx + m1.x * hy + m1.y * hz;
        ny = m0.y + m1.z * hx + m1.w * hy + m2.x * hz;
        nz = m0.z + m2.y * hx + m2.z * hy + m2.w * hz;
        const float ni = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
        nx = nx * ni;
        ny = ny * ni;
        nz = nz * ni;
      }
      // Phong (JAX kernels/tiled_t.py::_fused_phong)
      float lx = Lx - hx, ly = Ly - hy, lz = Lz - hz;
      const float li = rsqrtf(fmaxf(lx * lx + ly * ly + lz * lz, 1e-30f));
      lx = lx * li;
      ly = ly * li;
      lz = lz * li;
      const float nl = nx * lx + ny * ly + nz * lz;
      const float nla = double_sided ? fabsf(nl) : fmaxf(nl, 0.0f);
      const float di = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
      const float vx = -dx * di, vy = -dy * di, vz = -dz * di;
      const float rx = -lx + 2.0f * nl * nx;
      const float ry = -ly + 2.0f * nl * ny;
      const float rz = -lz + 2.0f * nl * nz;
      const float rv = fmaxf(rx * vx + ry * vy + rz * vz, 0.0f);
      // the object's material (pc[3], sc[3], amb, shin); zeros outside the
      // table, as JAX's unrolled select gives
      const bool known = obj >= 0 && obj < n_obj;
      const float* m = mat + (known ? obj : 0) * 8;
      const float amb = known ? m[6] : 0.0f, shin = known ? m[7] : 0.0f;
      const float pw = (rv > 0.0f || shin == 0.0f)
                           ? expf(shin * logf(fmaxf(rv, 1e-30f)))
                           : 0.0f;
      const float sw = (specular_nl ? nla : 1.0f) * pw;
      const float dw = nla + amb;
      if constexpr (kMode == kTextured) {
        out[0] = dw;
        out[1] = sw;
        out[2] = m0.x * hx + m0.y * hy + m0.z * hz + m0.w;
        out[3] = m1.x * hx + m1.y * hy + m1.z * hz + m1.w;
        out[4] = static_cast<float>(obj);
        out[5] = m2.x;
      } else if (known) {
        out[0] = m[0] * dw + m[3] * sw;
        out[1] = m[1] * dw + m[4] * sw;
        out[2] = m[2] * dw + m[5] * sw;
      }
      // shadow bounds: hit point box, object range, and the shadow
      // direction light - p projected in the shared frame
      const float ux = Lx - hx, uy = Ly - hy, uz = Lz - hz;
      const float dwl = ux * fwx + uy * fwy + uz * fwz;
      const float dsl = ux * fsx + uy * fsy + uz * fsz;
      const float dvl = ux * fvx + uy * fvy + uz * fvz;
      const float dws = fabsf(dwl) > 1e-12f ? dwl : 1e-12f;
      const float ru = dsl / dws, rvv = dvl / dws;
      const float of = static_cast<float>(obj);
      acc[0] = fminf(acc[0], hx);
      acc[1] = fminf(acc[1], hy);
      acc[2] = fminf(acc[2], hz);
      acc[3] = fmaxf(acc[3], hx);
      acc[4] = fmaxf(acc[4], hy);
      acc[5] = fmaxf(acc[5], hz);
      acc[6] = 1.0f;
      acc[7] = fminf(acc[7], of);
      acc[8] = fmaxf(acc[8], of);
      acc[9] = fminf(acc[9], ru);
      acc[10] = fmaxf(acc[10], ru);
      acc[11] = fminf(acc[11], rvv);
      acc[12] = fmaxf(acc[12], rvv);
      acc[13] = fminf(acc[13], dwl);
      acc[14] = fmaxf(acc[14], dwl);
    }
    obj_out[o] = obj;
#pragma unroll
    for (int q = 0; q < kOutW; ++q) shade_out[kOutW * o + q] = out[q];
  }
  if constexpr (kMode == kFetch) return;

  // block reduction of the bounds row: warp shuffles, then across warps
  const int warp = tid >> 5, wl = tid & 31;
#pragma unroll
  for (int q = 0; q < kBoundsW; ++q) {
    float v = acc[q];
    for (int off = 16; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max_slot(q) ? fmaxf(v, other) : fminf(v, other);
    }
    if (wl == 0) s_red[warp][q] = v;
  }
  __syncthreads();
  if (tid < kBoundsW) {
    float v = s_red[0][tid];
    for (int i = 1; i < kEpiThreads / 32; ++i)
      v = is_max_slot(tid) ? fmaxf(v, s_red[i][tid]) : fminf(v, s_red[i][tid]);
    bounds_out[static_cast<size_t>(tile) * kBoundsW + tid] = v;
  }
}

// Shared memory of the walks: two staged windows and the term rows.
size_t walk_smem(int wt) {
  return static_cast<size_t>(wt) * (2 * srt::kTriW + kTermW) * sizeof(float);
}

// The persistent walk over explicit rays o, d [n, m, 3]: each CTA takes the
// next item from sched[0]; item i is row i / slices, slice i % slices
// (srt::Slice: the slice's lanes in its sub-group; lanes past the group walk
// the slice's first ray, never hold back the break and are not written).
// An item skips the entries whose mask bit its group lacks (every entry of
// a range row or an ungrouped plan has every bit).  When all its live rays
// leave one origin (compared bit for bit) it tests against term rows staged
// from that origin, else each ray against the raw triangle rows.  Shared
// memory: two staged windows and the term rows.
template <int RPT>
__global__ void __launch_bounds__(srt::kItemThreads) rays_walk_kernel(
    const int* __restrict__ plan, int plan_w, int groups,
    const float* __restrict__ tri, int n_windows,
    const float* __restrict__ o_in, const float* __restrict__ d_in, int m,
    int wt, float eps, srt::Spans spans, int* __restrict__ sched,
    unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                             // 2 x wt * kTriW
  float* terms = smem + 2 * wt * srt::kTriW;     // wt * kTermW
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int slices = srt::slices_per_tile(m, groups);
  const int items = sched[1] * slices;
  const int win_f = wt * srt::kTriW;
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
    const float o0x = o_in[3 * base], o0y = o_in[3 * base + 1],
                o0z = o_in[3 * base + 2];

    float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT], bt[RPT];
    int bi[RPT];
    bool live[RPT];
    int one = 1;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int l = tid + r * srt::kItemThreads;
      live[r] = l < S.live;
      const size_t o = base + (live[r] ? l : 0);
      ox[r] = o_in[3 * o + 0];
      oy[r] = o_in[3 * o + 1];
      oz[r] = o_in[3 * o + 2];
      dx[r] = d_in[3 * o + 0];
      dy[r] = d_in[3 * o + 1];
      dz[r] = d_in[3 * o + 2];
      bt[r] = INFINITY;
      bi[r] = -1;
      one &= __float_as_uint(ox[r]) == __float_as_uint(o0x) &&
             __float_as_uint(oy[r]) == __float_as_uint(o0y) &&
             __float_as_uint(oz[r]) == __float_as_uint(o0z);
    }
    const bool uni = __syncthreads_and(one);     // one origin: term rows
    auto walks = [&](int k) {
      const int w = P.window(k);
      return w >= 0 && w < n_windows && (P.gmask(k) & gbit);
    };
    if (k0 < k1 && walks(k0)) {
      srt::stage_window_async(raw, tri, P.window(k0), wt);
      srt::cp_async_commit();
    }
    for (int k = k0; k < k1; ++k) {
      float* cur = raw + ((k - k0) & 1) * win_f;
      srt::cp_async_wait_all();
      __syncthreads();           // window k landed; the term rows are free
      if (k + 1 < k1 && walks(k + 1)) {
        srt::stage_window_async(raw + ((k + 1 - k0) & 1) * win_f, tri,
                                P.window(k + 1), wt);
        srt::cp_async_commit();
      }
      if (walks(k)) {                            // block-uniform
        const int id0 = P.window(k) * wt;
        if (uni) {
          for (int j = tid; j < wt; j += srt::kItemThreads)
            stage_terms(cur + j * srt::kTriW, terms + j * kTermW, o0x, o0y,
                        o0z);
          __syncthreads();
          for (int j = 0; j < wt; ++j) {
            const Terms T(terms + j * kTermW);
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              test_terms(T, id0 + j, eps, dx[r], dy[r], dz[r], bt[r], bi[r]);
          }
        } else {
          for (int j = 0; j < wt; ++j) {
            const srt::Tri g(cur + j * srt::kTriW);
#pragma unroll
            for (int r = 0; r < RPT; ++r)
              test_ray(g, id0 + j, eps, ox[r], oy[r], oz[r], dx[r], dy[r],
                       dz[r], bt[r], bi[r]);
          }
        }
      }
      if (P.use_list && k + 1 < k1 &&
          past_bound<RPT>(P.bound16(k + 1), bt, live))
        break;
    }
    srt::cp_async_wait_all();                    // no copy outlives the item
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (live[r] && bi[r] >= 0)
        atomicMin(&keys[base + tid + r * srt::kItemThreads],
                  hit_key(bt[r], bi[r]));
    __syncthreads();             // s_item and the buffers free for the next
  }
}

// keys [n] -> t [n] f32, idx [n] i32: a key whose t is not finite (the miss
// key's bits are a NaN) is a miss, t = inf, idx = -1.  kFetch (the fetch
// mode over explicit rays) also writes the winner's tri_attr row to
// attr_out [n] as one float4, (0, 0, 0, -1) on a miss, as K1's fetch
// epilogue does.
template <bool kFetch>
__global__ void __launch_bounds__(kDecodeThreads) rays_decode_kernel(
    const unsigned long long* __restrict__ keys, long long n,
    const float4* __restrict__ attr, float* __restrict__ t_out,
    int* __restrict__ idx_out, float4* __restrict__ attr_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long key = keys[i];
    const float kt = __uint_as_float(static_cast<unsigned>(key >> 32));
    const bool hit = isfinite(kt);
    const int id = hit ? static_cast<int>(static_cast<unsigned>(key)) : -1;
    t_out[i] = hit ? kt : INFINITY;
    idx_out[i] = id;
    if constexpr (kFetch)
      attr_out[i] = hit ? attr[id] : make_float4(0.0f, 0.0f, 0.0f, -1.0f);
  }
}

// Rays a thread of the walk over explicit rays owns: one up to
// kItemThreads rays a slice, else two.
int rays_rpt(int slice_r) { return slice_r > srt::kItemThreads ? 2 : 1; }

template <int kMode>
int launch_k1(const void* plan, int plan_w, int n_tiles, const void* tri,
              const void* attr, int n_windows, const void* mat, int n_obj,
              const void* cam, int tile_px, int wt, float eps,
              int double_sided, int specular_nl, const void* amap, void* t,
              void* idx, void* obj, void* shade, void* bounds,
              void* attr_out, void* keys, void* sched, int rows_max,
              srt::Spans spans, int stages, cudaStream_t s) {
  const long long n_keys = static_cast<long long>(n_tiles) * tile_px * tile_px;
  if (stages & 1) {
    schedule_kernel<<<srt::fill_blocks(n_keys, srt::kBuckets), srt::kBuckets,
                      0, s>>>(
        static_cast<const int*>(plan), plan_w, n_tiles, n_windows, spans,
        rows_max, static_cast<int*>(sched),
        static_cast<unsigned long long*>(keys), n_keys);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  if (stages & 2) {
    const size_t smem = walk_smem(wt);
    k1_walk_kernel<<<srt::persistent_grid(k1_walk_kernel, srt::kItemThreads,
                                          smem),
                     srt::kItemThreads, smem, s>>>(
        static_cast<const int*>(plan), plan_w,
        static_cast<const float*>(tri), n_windows,
        static_cast<const float*>(cam), tile_px, wt, eps, spans,
        static_cast<int*>(sched), static_cast<unsigned long long*>(keys));
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  if (stages & 4) {
    k1_epilogue_kernel<kMode><<<n_tiles, kEpiThreads, 0, s>>>(
        static_cast<const int*>(plan), plan_w,
        static_cast<const unsigned long long*>(keys),
        static_cast<const float4*>(attr), static_cast<const float*>(mat),
        n_obj, static_cast<const float*>(cam), tile_px, double_sided,
        specular_nl, static_cast<const float4*>(amap),
        static_cast<float*>(t), static_cast<int*>(idx),
        static_cast<int*>(obj), static_cast<float*>(shade),
        static_cast<float*>(bounds), static_cast<float4*>(attr_out));
  }
  return static_cast<int>(cudaGetLastError());
}


template <int RPT>
int launch_rays_walk(const void* plan, int plan_w, int groups,
                     const void* tri, int n_windows, const void* o_in,
                     const void* d_in, int m, int wt, float eps,
                     srt::Spans spans, void* sched, void* keys,
                     cudaStream_t s) {
  const size_t smem = walk_smem(wt);
  rays_walk_kernel<RPT>
      <<<srt::persistent_grid(rays_walk_kernel<RPT>, srt::kItemThreads,
                              smem),
         srt::kItemThreads, smem, s>>>(
          static_cast<const int*>(plan), plan_w, groups,
          static_cast<const float*>(tri), n_windows,
          static_cast<const float*>(o_in), static_cast<const float*>(d_in), m,
          wt, eps, spans, static_cast<int*>(sched),
          static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 in attribute mode `mode`: -1 fetch (attr_out [R, 4]; mat, amap, obj,
// shade and bounds not read), 0 flat (rgb), 1 textured (amap = tri_tex_map;
// shade [R, 6]), 2 smooth normals (amap = tri_nrm_map; rgb).  Scratch:
// keys [n_tiles * tile_px**2] u64 and sched [2 + 2 * rows_max] i32, rows_max
// at least n_tiles * (1 + max(n_windows / range_span, (plan_w - 8) /
// list_span)).  `stages` picks the launches
// (1 schedule and key fill, 2 walk, 4 epilogue; 7 for all): the walk reads
// the schedule launch's rows and consumes its counter.
extern "C" int srt_nearest_k1(
    const void* plan, int plan_w, int n_tiles, const void* tri,
    const void* attr, int n_windows, const void* mat, int n_obj,
    const void* cam, int tile_px, int wt, float eps, int double_sided,
    int specular_nl, int mode, const void* amap, void* t, void* idx,
    void* obj, void* shade, void* bounds, void* attr_out, void* keys,
    void* sched, int rows_max, int range_span, int list_span, int stages,
    void* stream) {
  if (n_tiles == 0) return 0;
  const int tile_r = tile_px * tile_px;
  if (tile_r <= 0 || tile_r % 32 ||
      (tile_r > srt::kItemSlice && tile_r % srt::kItemSlice) ||
      wt <= 0 || wt % 4 || srt::bad_spans(range_span, list_span) ||
      plan_w - srt::kPlanAux >= srt::kBuckets ||
      walk_smem(wt) > 48 * 1024 || reinterpret_cast<uintptr_t>(tri) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define SRT_K1_MODE(M)                                                         \
  case M:                                                                      \
    return launch_k1<M>(plan, plan_w, n_tiles, tri, attr, n_windows, mat,      \
                        n_obj, cam, tile_px, wt, eps, double_sided,            \
                        specular_nl, amap, t, idx, obj, shade, bounds,         \
                        attr_out, keys, sched, rows_max,                       \
                        srt::Spans{range_span, list_span}, stages, s);
    SRT_K1_MODE(kFetch)
    SRT_K1_MODE(kFlat)
    SRT_K1_MODE(kTextured)
    SRT_K1_MODE(kSmooth)
#undef SRT_K1_MODE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1's walk on this card for windows of wt triangles: out = (CTAs per SM,
// registers per thread, SMs, rays per slice, threads per CTA).
extern "C" int srt_k1_shape(int wt, int* out) {
  return srt::walk_shape(k1_walk_kernel, srt::kItemThreads, walk_smem(wt),
                         srt::kItemSlice, out);
}

// Nearest hit of explicit rays o, d [n_tiles, m, 3] f32 over a plan of
// windows of wt triangles -> t [n_tiles, m] f32 (inf on a miss), idx
// [n_tiles, m] i32 (-1 on a miss).  groups > 1: the plan carries the
// sub-group masks of `groups` groups of m / groups lanes (a multiple of 32).
// attr_out [n_tiles * m] float4 (the fetch mode over explicit rays; null
// for none): the winner's row of attr [Tp] float4 (tri_attr), (0, 0, 0, -1)
// on a miss.  Scratch: keys [n_tiles * m] u64 and sched [2 + 2 * rows_max]
// i32, as K1's.  `stages`: 1 schedule and key fill, 2 walk, 4 decode; 7 for
// all.
extern "C" int srt_nearest_rays(
    const void* plan, int plan_w, int n_tiles, int groups, const void* tri,
    int n_windows, const void* o_in, const void* d_in, int m, int wt,
    float eps, void* t, void* idx, const void* attr, void* attr_out,
    void* keys, void* sched, int rows_max, int range_span, int list_span,
    int stages, void* stream) {
  if (n_tiles == 0) return 0;
  if (m <= 0 || groups < 1 || groups > 4 || m % groups ||
      (groups > 1 && (m / groups) % 32) || wt <= 0 || wt % 4 ||
      srt::bad_spans(range_span, list_span) || walk_smem(wt) > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(tri) % 16 ||
      (attr_out && (!attr || reinterpret_cast<uintptr_t>(attr) % 16 ||
                    reinterpret_cast<uintptr_t>(attr_out) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_keys = static_cast<long long>(n_tiles) * m;
  const srt::Spans spans{range_span, list_span};
  if (stages & 1) {
    schedule_kernel<<<srt::fill_blocks(n_keys, srt::kBuckets), srt::kBuckets,
                      0, s>>>(static_cast<const int*>(plan), plan_w, n_tiles,
                              n_windows, spans, rows_max,
                              static_cast<int*>(sched),
                              static_cast<unsigned long long*>(keys), n_keys);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  if (stages & 2) {
    const int rc = rays_rpt(srt::slice_rays(m, groups)) == 2
        ? launch_rays_walk<2>(plan, plan_w, groups, tri, n_windows, o_in,
                              d_in, m, wt, eps, spans, sched, keys, s)
        : launch_rays_walk<1>(plan, plan_w, groups, tri, n_windows, o_in,
                              d_in, m, wt, eps, spans, sched, keys, s);
    if (rc) return rc;
  }
  if (stages & 4) {
    const int blocks = srt::fill_blocks(n_keys, kDecodeThreads);
    const auto* k = static_cast<const unsigned long long*>(keys);
    const auto* a = static_cast<const float4*>(attr);
    auto* ao = static_cast<float4*>(attr_out);
    if (ao)
      rays_decode_kernel<true><<<blocks, kDecodeThreads, 0, s>>>(
          k, n_keys, a, static_cast<float*>(t), static_cast<int*>(idx), ao);
    else
      rays_decode_kernel<false><<<blocks, kDecodeThreads, 0, s>>>(
          k, n_keys, a, static_cast<float*>(t), static_cast<int*>(idx), ao);
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk over explicit rays on this card for windows of wt triangles and
// m rays a tile in `groups` sub-groups: out as srt_k1_shape's.
extern "C" int srt_nearest_rays_shape(int wt, int m, int groups, int* out) {
  const int sr = srt::slice_rays(m, groups);
  const size_t smem = walk_smem(wt);
  return rays_rpt(sr) == 2 ? srt::walk_shape(rays_walk_kernel<2>,
                                             srt::kItemThreads, smem, sr, out)
                           : srt::walk_shape(rays_walk_kernel<1>,
                                             srt::kItemThreads, smem, sr, out);
}
