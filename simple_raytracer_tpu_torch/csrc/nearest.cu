// The nearest-hit walks, one thread block per ray tile.
//
// nearest_shaded_kernel: nearest hit + fused Phong + per-tile shadow bounds,
// or, in its fetch mode, nearest hit + the winner's attribute row.
// Replaces the TPU kernel simple_raytracer_tpu/kernels/tiled_t.py::
// _nearest_kernel_t, reached through tiled_nearest_t from hits_shaded (the
// fused modes, on the fused frame's path: flat, textured or smooth-normal
// scenes) and from hits_attrs and hits with cam_spec (the fetch mode, on the
// soft-shadow and sublane gather paths; the gather drops the attribute
// rows).  Plain PyTorch versions: kernels/nearest.py::
// tiled_nearest_shaded_plain and tiled_nearest_attrs_plain.  Every mode is
// one instance of the template (kMode), so their walks cannot drift apart.
// Tiles are 64x64 or 32x32 pixels; rays are rebuilt from the pixel index
// and the camera constants, so no ray array exists.
//
// nearest_rays_kernel: nearest hit (t, id) of explicit rays o, d [n, m, 3]
// over a plan of windows of wt consecutive triangles.  It replaces three TPU
// kernels: simple_raytracer_tpu/kernels/tiled.py::_nearest_kernel (K6: pages
// of page_tris triangles, reached through tiled_nearest from tiled_hits:
// tiled_impl="paged"; plain version kernels/paged.py::tiled_nearest_plain),
// tiled_t.py::_nearest_kernel_t over explicit rays (K1's rays mode: 64-
// triangle windows, the refined plan of the prepass walk; plain version
// kernels/nearest.py::tiled_nearest_rays_plain) and, with groups > 1,
// tiled_t.py::_nearest_kernel_g (K4: each sub-group of m / groups lanes
// skips the entries its mask clears and stops on its own bound test; plain
// version kernels/nearest.py::tiled_nearest_grouped_plain).  The TPU kernels
// compute their MT numerators as one Gram contraction per window; here they
// are the cross products of ops/intersect.py, as in K1.
//
// Both run nearest_walk: each thread owns RPT rays, strided by the block size
// so a warp's rays (and its output writes) are adjacent.  For each plan entry
// the block stages the window's triangles (v0, e1, e2: 9 floats each) in
// shared memory and every thread runs Möller–Trumbore in f32 against its
// rays, keeping the least t and, on equal t, the lowest triangle id.  After
// each window the block stops once every ray's best t is below the next
// entry's bound (__syncthreads_and); misses (t = inf) never stop it.  With
// one shared origin (K1) the ray-independent part of each triangle's test is
// computed once per triangle.  K1's fused mode then fetches the winner's flat
// normal and object id as one float4 load by id and evaluates the Phong term
// of the JAX kernel's _fused_phong (abs(n.l), the extra n.l on specular, pow
// through exp/log with the shininess-0 case); last, a block reduction writes
// the tile's 15-float bounds row: hit-point box, any-hit flag, object
// min/max and the ru/rv/dw extremes of the shadow directions in the shared
// frame.  The smooth mode first replaces the flat normal by normalize(cn +
// An p) from the winner's 48-byte tri_nrm_map row; the textured mode writes
// the Phong factors and the texel coordinates of its tri_tex_map row instead
// of rgb.  The fetch mode instead stores the winner's tri_attr row as one
// float4.
//
// What bounds them on the H100: the MT arithmetic (about 45 f32 operations
// per ray-triangle pair, with an IEEE division; K6 recomputes the
// origin-dependent part per ray), not memory — a window is 2.3 KB (K1) or
// 4.6 KB (a K6 page), read once per tile from L2, and each ray reads 24
// bytes (K6) and writes 8-28.  The design keeps each pair's work in
// registers and amortises every staged triangle over all rays of the tile;
// the break skips the windows behind the first surface.  K4's sub-groups
// skip a window's staging when no group needs it and its tests for the
// groups whose bit is clear, so one deep region of a tile no longer drags
// the other groups through its list.  Tensor cores, TMA and persistence are
// left for later work.

#include "common.cuh"

namespace {

// Walk the tile's plan: bt[r], bi[r] become the least t and its lowest
// triangle id over every window walked.  Ray r has direction d[r] and origin
// o[r], or o[0] for every ray with kOneOrigin.  Lanes that are not live never
// hold back the break.  kGrouped: lane r belongs to the sub-group of bit
// gbit[r]; a window is staged when some group not yet past its break may
// reach it, tested only by the rays of such groups, and each group stops at
// its own bound test.
template <int RPT, bool kOneOrigin, bool kGrouped = false>
__device__ __forceinline__ void nearest_walk(
    const srt::TilePlan& P, const float* __restrict__ tri, int n_windows,
    int wt, float eps, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const bool* live,
    float* bt, int* bi, float* s_tri, const unsigned* gbit = nullptr) {
  const unsigned full = (1u << P.groups) - 1u;
  unsigned done = 0;                             // groups past their break
  for (int k = 0; k < P.cnt; ++k) {
    const int w = P.window(k);
    __syncthreads();                             // s_tri free to overwrite
    if (w < 0 || w >= n_windows) continue;       // block-uniform
    const unsigned need = kGrouped ? P.gmask(k) & ~done & full : full;
    if (need) {                                  // block-uniform
      srt::stage(s_tri, tri + (size_t)w * wt * srt::kTriW, wt * srt::kTriW);
      __syncthreads();
      const int id0 = w * wt;
      for (int j = 0; j < wt; ++j) {
        const srt::Tri g(s_tri + j * srt::kTriW);
        const int id = id0 + j;
        // ray-independent with one origin: tvec = o - v0, qvec = tvec x e1,
        // t_num
        float tx = 0.0f, ty = 0.0f, tz = 0.0f, qx = 0.0f, qy = 0.0f,
              qz = 0.0f;
        float t_num = 0.0f;
        if constexpr (kOneOrigin) {
          tx = ox[0] - g.v0x;
          ty = oy[0] - g.v0y;
          tz = oz[0] - g.v0z;
          qx = ty * g.e1z - tz * g.e1y;
          qy = tz * g.e1x - tx * g.e1z;
          qz = tx * g.e1y - ty * g.e1x;
          t_num = g.e2x * qx + g.e2y * qy + g.e2z * qz;
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if constexpr (kGrouped) {
            if (!(need & gbit[r])) continue;     // warp-uniform
          }
          const float px = dy[r] * g.e2z - dz[r] * g.e2y;
          const float py = dz[r] * g.e2x - dx[r] * g.e2z;
          const float pz = dx[r] * g.e2y - dy[r] * g.e2x;
          const float det = g.e1x * px + g.e1y * py + g.e1z * pz;
          if constexpr (!kOneOrigin) {
            tx = ox[r] - g.v0x;
            ty = oy[r] - g.v0y;
            tz = oz[r] - g.v0z;
          }
          const float u_num = tx * px + ty * py + tz * pz;
          if constexpr (!kOneOrigin) {
            qx = ty * g.e1z - tz * g.e1y;
            qy = tz * g.e1x - tx * g.e1z;
            qz = tx * g.e1y - ty * g.e1x;
            t_num = g.e2x * qx + g.e2y * qy + g.e2z * qz;
          }
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
    if (P.use_list && k + 1 < P.cnt) {
      const unsigned nb16 = P.bound16(k + 1);
      if constexpr (!kGrouped) {
        int ok = 1;
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          ok &= !live[r] || (__float_as_uint(bt[r]) >> 16) < nb16;
        if (__syncthreads_and(ok)) break;
      } else {
        unsigned bad = 0;                        // groups this thread holds
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          if (live[r] && (__float_as_uint(bt[r]) >> 16) >= nb16)
            bad |= gbit[r];
        for (int g = 0; g < P.groups; ++g)
          if (__syncthreads_and(!((bad >> g) & 1u))) done |= 1u << g;
        if (done == full) break;
      }
    }
  }
}

constexpr int kBoundsW = 15;
// bounds slots reduced by max (the rest by min): p max xyz, any-hit,
// obj max, ru max, rv max, dw max
constexpr unsigned kBoundsMaxMask = 0x5578u;

__device__ __forceinline__ bool is_max_slot(int q) {
  return (kBoundsMaxMask >> q) & 1u;
}

// K1's modes.  kFetch writes the winner's tri_attr row (flat normal, object
// id; (0, 0, 0, -1) on a miss) to attr_out and reads no mat, amap, obj,
// shade or bounds.  The fused modes are JAX _fused_phong's attribute modes:
// kFlat shades with the flat normal of tri_attr and writes rgb; kSmooth
// takes the normal normalize(cn + An p) from the winner's tri_nrm_map row
// and writes rgb; kTextured writes the colour-free Phong factors and the
// texel coordinates A p + c of the winner's tri_tex_map row, (dw, sw, texu,
// texv, obj, tex id), for the texel finish in kernels/tiled.py.  A map row
// is 12 floats, read as three float4 loads after the walk.
enum : int { kFetch = -1, kFlat = 0, kTextured = 1, kSmooth = 2 };

template <int RPT, int kMode>
__global__ void nearest_shaded_kernel(
    const int* __restrict__ plan, int plan_w,
    const float* __restrict__ tri, const float4* __restrict__ attr,
    int n_windows, const float* __restrict__ mat, int n_obj,
    const float* __restrict__ cam_g, int tile_px, int wt, float eps,
    int double_sided, int specular_nl, const float4* __restrict__ amap,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    int* __restrict__ obj_out, float* __restrict__ shade_out,
    float* __restrict__ bounds_out, float4* __restrict__ attr_out) {
  constexpr int kOutW = kMode == kTextured ? 6 : 3;   // shade_out columns
  extern __shared__ float s_tri[];               // wt * kTriW floats
  __shared__ float s_cam[srt::kCamLen];
  __shared__ float s_red[srt::kMaxWarps][kBoundsW];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int tile_r = nthr * RPT;
  for (int i = tid; i < srt::kCamLen; i += nthr) s_cam[i] = cam_g[i];
  __syncthreads();
  const srt::TilePlan P(plan, plan_w, tile);
  const float ox = s_cam[9], oy = s_cam[10], oz = s_cam[11];

  float dx[RPT], dy[RPT], dz[RPT], bt[RPT];
  int bi[RPT];
  bool live[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    srt::ray_dir(s_cam, P.px0, P.py0, tile_px, tid + r * nthr, dx[r], dy[r],
                 dz[r]);
    bt[r] = INFINITY;
    bi[r] = -1;
    live[r] = true;
  }
  nearest_walk<RPT, true>(P, tri, n_windows, wt, eps, &ox, &oy, &oz, dx, dy,
                          dz, live, bt, bi, s_tri);

  if constexpr (kMode == kFetch) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const size_t o = (size_t)tile * tile_r + tid + r * nthr;
      const bool hit = isfinite(bt[r]);
      t_out[o] = bt[r];
      idx_out[o] = hit ? bi[r] : -1;
      attr_out[o] = hit ? attr[bi[r]] : make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    }
    return;
  }
  const float Lx = s_cam[12], Ly = s_cam[13], Lz = s_cam[14];
  const float fsx = s_cam[15], fsy = s_cam[16], fsz = s_cam[17];
  const float fvx = s_cam[18], fvy = s_cam[19], fvz = s_cam[20];
  const float fwx = s_cam[21], fwy = s_cam[22], fwz = s_cam[23];
  float acc[kBoundsW];
#pragma unroll
  for (int q = 0; q < kBoundsW; ++q)
    acc[q] = is_max_slot(q) ? -INFINITY : INFINITY;
  acc[6] = 0.0f;                                 // any-hit flag

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lane = tid + r * nthr;
    const size_t o = (size_t)tile * tile_r + lane;
    const bool hit = isfinite(bt[r]);
    const int id = hit ? bi[r] : -1;
    t_out[o] = bt[r];
    idx_out[o] = id;
    float out[kOutW];
#pragma unroll
    for (int q = 0; q < kOutW; ++q) out[q] = 0.0f;
    if constexpr (kMode == kTextured) out[4] = out[5] = -1.0f;
    int obj = -1;
    if (hit) {
      const float4 a = attr[id];
      obj = static_cast<int>(a.w);
      const float t = bt[r];
      const float hx = ox + t * dx[r], hy = oy + t * dy[r], hz = oz + t * dz[r];
      float nx = a.x, ny = a.y, nz = a.z;
      float4 m0, m1, m2;                         // the winner's map row
      if constexpr (kMode != kFlat) {
        const float4* row = amap + (size_t)id * 3;
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
      const float di =
          rsqrtf(fmaxf(dx[r] * dx[r] + dy[r] * dy[r] + dz[r] * dz[r], 1e-30f));
      const float vx = -dx[r] * di, vy = -dy[r] * di, vz = -dz[r] * di;
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

  // block reduction of the bounds row: warp shuffles, then across warps
  const int warp = tid >> 5, wl = tid & 31, nwarps = nthr >> 5;
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
    for (int i = 1; i < nwarps; ++i)
      v = is_max_slot(tid) ? fmaxf(v, s_red[i][tid]) : fminf(v, s_red[i][tid]);
    bounds_out[(size_t)tile * kBoundsW + tid] = v;
  }
}

// rays o, d [n, m, 3] f32 -> t [n, m] f32 (inf on a miss), idx [n, m] i32
// (-1 on a miss).  m need not fill the block: lanes past m walk the tile's
// first ray, never hold back the break and are not written.  kGrouped: the
// plan carries sub-group masks for `groups` groups of m / groups lanes.
template <int RPT, bool kGrouped>
__global__ void nearest_rays_kernel(
    const int* __restrict__ plan, int plan_w, const float* __restrict__ tri,
    int n_windows, const float* __restrict__ o_in,
    const float* __restrict__ d_in, int m, int wt, float eps, int groups,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  extern __shared__ float s_tri[];               // wt * kTriW floats
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const srt::TilePlan P(plan, plan_w, tile, kGrouped ? groups : 1);

  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT], bt[RPT];
  int bi[RPT];
  bool live[RPT];
  unsigned gbit[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lane = tid + r * nthr;
    live[r] = lane < m;
    const size_t o = (size_t)tile * m + (live[r] ? lane : 0);
    ox[r] = o_in[3 * o + 0];
    oy[r] = o_in[3 * o + 1];
    oz[r] = o_in[3 * o + 2];
    dx[r] = d_in[3 * o + 0];
    dy[r] = d_in[3 * o + 1];
    dz[r] = d_in[3 * o + 2];
    bt[r] = INFINITY;
    bi[r] = -1;
  }
  if constexpr (kGrouped) srt::group_bits<RPT>(m / groups, gbit);
  nearest_walk<RPT, false, kGrouped>(P, tri, n_windows, wt, eps, ox, oy, oz,
                                     dx, dy, dz, live, bt, bi, s_tri, gbit);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int lane = tid + r * nthr;
    if (!live[r]) continue;
    const size_t o = (size_t)tile * m + lane;
    t_out[o] = bt[r];
    idx_out[o] = isfinite(bt[r]) ? bi[r] : -1;
  }
}

}  // namespace

#define SRT_NEAREST_CASE(R, MODE)                                              \
  case R:                                                                      \
    nearest_shaded_kernel<R, MODE><<<n_tiles, threads, smem, s>>>(             \
        static_cast<const int*>(plan), plan_w,                                 \
        static_cast<const float*>(tri), static_cast<const float4*>(attr),      \
        n_windows, static_cast<const float*>(mat), n_obj,                      \
        static_cast<const float*>(cam), tile_px, wt, eps, double_sided,        \
        specular_nl, static_cast<const float4*>(amap),                         \
        static_cast<float*>(t), static_cast<int*>(idx),                        \
        static_cast<int*>(obj), static_cast<float*>(shade),                    \
        static_cast<float*>(bounds), static_cast<float4*>(attr_out));          \
    break;

namespace {

template <int kMode>
int launch_nearest(const void* plan, int plan_w, int n_tiles, const void* tri,
                   const void* attr, int n_windows, const void* mat,
                   int n_obj, const void* cam, int tile_px, int wt, float eps,
                   int double_sided, int specular_nl, const void* amap,
                   void* t, void* idx, void* obj, void* shade, void* bounds,
                   void* attr_out, int threads, void* stream) {
  if (n_tiles == 0) return 0;
  const int tile_r = tile_px * tile_px;
  if (threads <= 0 || threads > 1024 || threads % 32 || tile_r % threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(wt) * srt::kTriW * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_r / threads) {
    SRT_NEAREST_CASE(1, kMode)
    SRT_NEAREST_CASE(2, kMode)
    SRT_NEAREST_CASE(4, kMode)
    SRT_NEAREST_CASE(8, kMode)
    SRT_NEAREST_CASE(16, kMode)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 flat (rgb), 1 textured (amap = tri_tex_map; shade [R, 6]), 2
// smooth normals (amap = tri_nrm_map; rgb)
extern "C" int srt_nearest_shaded(
    const void* plan, int plan_w, int n_tiles, const void* tri,
    const void* attr, int n_windows, const void* mat, int n_obj,
    const void* cam, int tile_px, int wt, float eps, int double_sided,
    int specular_nl, int mode, const void* amap, void* t, void* idx,
    void* obj, void* shade, void* bounds, int threads, void* stream) {
  switch (mode) {
#define SRT_NEAREST_MODE(M)                                                    \
  case M:                                                                      \
    return launch_nearest<M>(plan, plan_w, n_tiles, tri, attr, n_windows, mat, \
                             n_obj, cam, tile_px, wt, eps, double_sided,       \
                             specular_nl, amap, t, idx, obj, shade, bounds,    \
                             nullptr, threads, stream);
    SRT_NEAREST_MODE(kFlat)
    SRT_NEAREST_MODE(kTextured)
    SRT_NEAREST_MODE(kSmooth)
#undef SRT_NEAREST_MODE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int srt_nearest_attrs(
    const void* plan, int plan_w, int n_tiles, const void* tri,
    const void* attr, int n_windows, const void* cam, int tile_px, int wt,
    float eps, void* t, void* idx, void* attr_out, int threads,
    void* stream) {
  return launch_nearest<kFetch>(plan, plan_w, n_tiles, tri, attr, n_windows,
                                nullptr, 0, cam, tile_px, wt, eps, 0, 0,
                                nullptr, t, idx, nullptr, nullptr, nullptr,
                                attr_out, threads, stream);
}

#define SRT_NEAREST_RAYS_LAUNCH(R, G)                                          \
  nearest_rays_kernel<R, G><<<n_tiles, threads, smem, s>>>(                    \
      static_cast<const int*>(plan), plan_w, static_cast<const float*>(tri),   \
      n_windows, static_cast<const float*>(o_in),                              \
      static_cast<const float*>(d_in), m, wt, eps, groups,                     \
      static_cast<float*>(t), static_cast<int*>(idx))

#define SRT_NEAREST_RAYS_CASE(R)                                               \
  case R:                                                                      \
    if (groups > 1)                                                            \
      SRT_NEAREST_RAYS_LAUNCH(R, true);                                        \
    else                                                                       \
      SRT_NEAREST_RAYS_LAUNCH(R, false);                                       \
    break;

extern "C" int srt_nearest_rays(
    const void* plan, int plan_w, int n_tiles, const void* tri,
    int n_windows, const void* o_in, const void* d_in, int m, int wt,
    float eps, int groups, void* t, void* idx, int threads, void* stream) {
  if (n_tiles == 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % 32 || m <= 0 || wt <= 0 ||
      groups < 1 || groups > 4 || m % groups || (groups > 1 &&
                                                 (m / groups) % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(wt) * srt::kTriW * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (srt::rays_per_thread(m, threads)) {
    SRT_NEAREST_RAYS_CASE(1)
    SRT_NEAREST_RAYS_CASE(2)
    SRT_NEAREST_RAYS_CASE(4)
    SRT_NEAREST_RAYS_CASE(8)
    SRT_NEAREST_RAYS_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
