// The fixed-cost probes of K1: stripped copies of the nearest kernel's
// per-tile work, timed one part at a time.
//
// Replaces the TPU probes scripts/fixed_probe.py (io_body, feat_body,
// acc_body: pl.pallas_call at :63), scripts/fixed_probe2.py (base_kern :78,
// noin_kern :99, noout_kern :114, none_kern :130, none2_kern :145, feati_kern
// :169) and scripts/fixed_probe3.py (empty_kern, write_kern, grid1_kern,
// grid1f_kern: :98).  fixed_probe.py's win_body is K1 itself on a cut plan
// (probes/fixed.py::k1_points).  Plain PyTorch versions:
// probes/fixed.py::fixed_probe_plain.
//
// Each variant is one instance of fixed_probe_kernel<V, RPT>, chosen at
// compile time by spec(V): where the rays come from (read from o, d
// [n, tile, 3] as K1's rays mode, K6 and K2' read them, rebuilt from the
// pixel index as K1 rebuilds them, or no rays), what each lane computes (the
// TPU probe's expression over the ten feature rows F10 = d, o x d, o, 1 of
// tiled_t._build_feats, in f32), whether it keeps the least of the ten rows
// with its lowest id as K1 keeps its best hit, where it stores (tile-major
// [n, tile], or the pixel's place in the [H, W] image: the untile folded into
// the store), whether it writes an idx, and the grid (one block per tile;
// one block per tile of which only block 0 stores; or persistent, one block
// per SM striding over the tiles).  Every value depends on every stage its
// variant claims, so the compiler cannot drop one.
//
// K1's launch shape: one block of `threads` threads per tile, each thread
// owning RPT lanes strided by the block size (lane = tid + r * threads).
// The TPU probes walked a ray-major stream of 4096-ray steps; the card's
// tiles are K1's 64x64-pixel tiles, so each variant measures a part of K1.
//
// What bounds them on the H100: bytes, not operations (a few f32 operations
// per lane against 4-28 bytes moved).  The design keeps each lane's work in
// registers, its loads and stores coalesced across a warp, and nothing else:
// the probes measure, they do not optimise.

#include "common.cuh"

namespace {

enum Variant : int {
  kIo, kFeat, kFeat3, kAcc, kNoin, kNoout, kNone, kNone2, kFeatI, kEmpty,
  kWrite, kGrid1, kGrid1f, kNumVariants
};
enum Rays : int { kNoRays, kReadO, kReadD, kReadOD, kRebuilt };
enum Value : int { kOxPlus1, kSumF10, kSumDir, kKeep, kRows0369, kDxPlus1,
                   kRow };
enum Idx : int { kNoIdx, kArgmin, kTileId };
enum Grid : int { kPerTile, kBlock0, kPersistent };

struct Spec {
  int rays, value, idx, grid;
  bool image;
};

// Each variant's switches (probes/fixed.py::VARIANTS lists them in Variant
// order).  A constexpr function rather than a table, so that device code may
// read it in constant expressions.
__host__ __device__ constexpr Spec spec(int v) {
  switch (v) {
    case kIo: return {kReadO, kOxPlus1, kNoIdx, kPerTile, false};
    case kFeat: return {kReadOD, kSumF10, kNoIdx, kPerTile, false};
    case kFeat3: return {kReadD, kSumDir, kNoIdx, kPerTile, false};
    case kAcc: return {kReadOD, kKeep, kArgmin, kPerTile, false};
    case kNoin: return {kRebuilt, kRows0369, kNoIdx, kPerTile, false};
    case kNoout: return {kReadO, kOxPlus1, kNoIdx, kPerTile, true};
    case kNone: return {kRebuilt, kDxPlus1, kNoIdx, kPerTile, true};
    case kNone2: return {kRebuilt, kDxPlus1, kTileId, kPerTile, true};
    case kFeatI: return {kRebuilt, kSumF10, kTileId, kPerTile, true};
    case kEmpty: return {kNoRays, kRow, kNoIdx, kBlock0, false};
    case kWrite: return {kNoRays, kRow, kNoIdx, kPerTile, false};
    case kGrid1: return {kNoRays, kRow, kNoIdx, kPersistent, false};
    default: return {kRebuilt, kSumF10, kNoIdx, kPersistent, false};  // grid1f
  }
}

template <int V, int RPT>
__global__ void fixed_probe_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ cam_g, const int* __restrict__ origins,
    float a, int n_tiles, int tile_px, int width, int height,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  constexpr Spec S = spec(V);
  __shared__ float s_cam[srt::kCamLen];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int tile_r = nthr * RPT;
  if constexpr (S.rays == kRebuilt) {
    for (int i = tid; i < srt::kCamLen; i += nthr) s_cam[i] = cam_g[i];
    __syncthreads();
  }
  if constexpr (S.grid == kBlock0) {
    if (blockIdx.x != 0) return;
  }
  // one pass per block, or, persistent, the tiles blockIdx.x + k * gridDim.x
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int px0 = 0, py0 = 0;
    if constexpr (S.rays == kRebuilt || S.image) {
      px0 = origins[2 * tile];
      py0 = origins[2 * tile + 1];
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int lane = tid + r * nthr;
      const size_t g = (size_t)tile * tile_r + lane;
      float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
      if constexpr (S.rays == kReadO || S.rays == kReadOD) {
        ox = o[3 * g + 0];
        oy = o[3 * g + 1];
        oz = o[3 * g + 2];
      }
      if constexpr (S.rays == kReadD || S.rays == kReadOD) {
        dx = d[3 * g + 0];
        dy = d[3 * g + 1];
        dz = d[3 * g + 2];
      }
      if constexpr (S.rays == kRebuilt) {
        srt::ray_dir(s_cam, px0, py0, tile_px, lane, dx, dy, dz);
        ox = s_cam[9];
        oy = s_cam[10];
        oz = s_cam[11];
      }
      // F10 = [d, o x d, o, 1] (JAX tiled_t._build_feats)
      const float F[10] = {dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
                           ox * dy - oy * dx, ox, oy, oz, 1.0f};
      float t = 0.0f;
      int id = -1;
      if constexpr (S.value == kOxPlus1) {
        t = ox + 1.0f;
      } else if constexpr (S.value == kSumF10) {
#pragma unroll
        for (int k = 0; k < 10; ++k) t = t + F[k];
      } else if constexpr (S.value == kSumDir) {
#pragma unroll
        for (int k = 0; k < 3; ++k) t = t + F[k];
      } else if constexpr (S.value == kRows0369) {
#pragma unroll
        for (int k = 0; k < 10; k += 3) t = t + F[k];
      } else if constexpr (S.value == kDxPlus1) {
        t = dx + 1.0f;
      } else if constexpr (S.value == kRow) {
        t = static_cast<float>(lane) + a + static_cast<float>(tile);
      } else {                                   // kKeep: K1's best update
        float bt = INFINITY;
        int bi = -1;
#pragma unroll
        for (int k = 0; k < 10; ++k) {
          if (F[k] < bt || (F[k] == bt && k < bi)) {
            bt = F[k];
            bi = k;
          }
        }
        t = bt;
        id = isfinite(bt) ? bi : -1;
      }
      if constexpr (S.idx == kTileId) id = tile;
      if constexpr (S.image) {
        const int x = px0 + width / 2 + lane % tile_px;
        const int y = py0 + height / 2 + lane / tile_px;
        if (x < width && y < height) {
          const size_t p = (size_t)y * width + x;
          t_out[p] = t;
          if constexpr (S.idx != kNoIdx) idx_out[p] = id;
        }
      } else {
        t_out[g] = t;
        if constexpr (S.idx != kNoIdx) idx_out[g] = id;
      }
    }
  }
}

#define SRT_PROBE_RPT(R)                                                       \
  case R:                                                                      \
    fixed_probe_kernel<V, R><<<grid, threads, 0, s>>>(                         \
        static_cast<const float*>(o), static_cast<const float*>(d),            \
        static_cast<const float*>(cam), static_cast<const int*>(origins), a,   \
        n_tiles, tile_px, width, height, static_cast<float*>(t),               \
        static_cast<int*>(idx));                                               \
    break;

template <int V>
int launch_probe(const void* o, const void* d, const void* cam,
                 const void* origins, float a, int n_tiles, int tile_px,
                 int width, int height, void* t, void* idx, int threads,
                 cudaStream_t s) {
  int grid = n_tiles;
  if constexpr (spec(V).grid == kPersistent) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    grid = sms < n_tiles ? sms : n_tiles;
  }
  switch (tile_px * tile_px / threads) {
    SRT_PROBE_RPT(1)
    SRT_PROBE_RPT(2)
    SRT_PROBE_RPT(4)
    SRT_PROBE_RPT(8)
    SRT_PROBE_RPT(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: the index of probes/fixed.py::VARIANTS.  o, d [n, tile, 3] f32
// (read-ray variants), cam [24] f32 and origins [n, 2] i32 (rebuilt rays and
// image stores); t and idx: [n, tile] (tile-major) or [height, width]
// (image order); idx may be null where the variant writes none.
extern "C" int srt_fixed_probe(int variant, const void* o, const void* d,
                               const void* cam, const void* origins, float a,
                               int n_tiles, int tile_px, int width,
                               int height, void* t, void* idx, int threads,
                               void* stream) {
  if (n_tiles <= 0) return 0;
  const int tile_r = tile_px * tile_px;
  if (threads <= 0 || threads > 1024 || threads % 32 || tile_r % threads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
#define SRT_PROBE_VARIANT(V)                                                   \
  case V:                                                                      \
    return launch_probe<V>(o, d, cam, origins, a, n_tiles, tile_px, width,     \
                           height, t, idx, threads, s);
    SRT_PROBE_VARIANT(kIo)
    SRT_PROBE_VARIANT(kFeat)
    SRT_PROBE_VARIANT(kFeat3)
    SRT_PROBE_VARIANT(kAcc)
    SRT_PROBE_VARIANT(kNoin)
    SRT_PROBE_VARIANT(kNoout)
    SRT_PROBE_VARIANT(kNone)
    SRT_PROBE_VARIANT(kNone2)
    SRT_PROBE_VARIANT(kFeatI)
    SRT_PROBE_VARIANT(kEmpty)
    SRT_PROBE_VARIANT(kWrite)
    SRT_PROBE_VARIANT(kGrid1)
    SRT_PROBE_VARIANT(kGrid1f)
#undef SRT_PROBE_VARIANT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
