// The winner-fetch probes: each ray's attribute row, looked up by its winning
// triangle id.
//
// attr_gather_kernel replaces the TPU probe scripts/attr_probe.py::
// _attr_kernel (pl.pallas_call at :77): per ray, the winner id bid in
// [-1, T) -> the id's attribute column of A [16, T], zeros on a miss.  The
// TPU kernel had no gather: per 128-triangle chunk it built a one-hot of the
// ids and contracted it with the chunk on the matrix unit.  Here the id is an
// address: the kernel reads the row of At = A^T [T, 16] (64 bytes, four
// float4) that the id names, one float4 per thread, so a warp stores eight
// whole rows.  Plain version: probes/attr.py::attr_gather_plain.
//
// attr_window_kernel replaces the TPU probe scripts/attr_fetch_probe.py's
// inner kernel (pl.pallas_call at :77): per tile i and ray lane r with winner
// id b = bid[i, r], the sum over the tile's windows k of the attribute column
// of A [16, NB * 128] bf16 at the window lanes l of s = starts[i, k] whose
// triangle (2s + l / 128) * 32 + l % 128 is b (only lanes with l % 128 < 32
// carry a triangle), added in k order in f32.  The TPU kernel contracted a
// [256, tile] bf16 one-hot per window on the matrix unit.  Here the one lane
// that can match is computed from b and s directly (b - 64 s in [0, 64):
// lane (b - 64 s) / 32 * 128 + (b - 64 s) % 32), and its row of At = A^T
// [NB * 128, 16] bf16 (32 bytes) is read, or zeros are added where none
// matches.  Plain version: probes/attr.py::attr_window_plain.
//
// What bounds them on the H100: bytes.  The outputs (64 bytes per ray) are
// most of them; each thread's loads and stores are coalesced across the warp
// and the tables' rows are read by id, once per ray that needs them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAttrW = 16;           // attribute rows of A (floats per ray)
constexpr int kBS = 32;              // triangles of a block
constexpr int kWB = 2;               // blocks of a window
constexpr int kRPB = 4 * kBS;        // window lanes per block
constexpr int kWL = kWB * kRPB;      // lanes of a window (256)

// one thread per float4 of a ray's row
__global__ void attr_gather_kernel(const int* __restrict__ bid,
                                   const float4* __restrict__ at,
                                   long long rays, float4* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= rays * (kAttrW / 4)) return;
  const int b = bid[q / (kAttrW / 4)];
  const int part = static_cast<int>(q % (kAttrW / 4));
  out[q] = b >= 0 ? at[(size_t)b * (kAttrW / 4) + part]
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// bf16 bits -> f32: the bf16 value is the f32 of its bits shifted up
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// one thread per ray lane; blockIdx.y is the tile
__global__ void attr_window_kernel(const int* __restrict__ starts, int nw,
                                   const int* __restrict__ bid,
                                   const uint4* __restrict__ at, int tile_r,
                                   float* __restrict__ out) {
  const int tile = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= tile_r) return;
  const int b = bid[(size_t)tile * tile_r + r];
  float acc[kAttrW];
#pragma unroll
  for (int c = 0; c < kAttrW; ++c) acc[c] = 0.0f;
  for (int k = 0; k < nw; ++k) {
    const int s = starts[(size_t)tile * nw + k];
    const int off = b - s * (kWB * kBS);
    uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
    if (off >= 0 && off < kWB * kBS) {
      const int lane = off / kBS * kRPB + off % kBS;
      const uint4* row = at + ((size_t)s * kWL + lane) * 2;   // 32-byte rows
      w0 = row[0];
      w1 = row[1];
    }
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[2 * c] = acc[2 * c] + bf16_lo(w[c]);
      acc[2 * c + 1] = acc[2 * c + 1] + bf16_hi(w[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kAttrW; ++c)
    out[((size_t)tile * kAttrW + c) * tile_r + r] = acc[c];
}

}  // namespace

// bid [rays] i32, at [T, 16] f32 (16-byte aligned) -> out [rays, 16] f32
extern "C" int srt_attr_gather(const void* bid, const void* at,
                               long long rays, void* out, int threads,
                               void* stream) {
  if (rays <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long work = rays * (kAttrW / 4);
  const long long blocks = (work + threads - 1) / threads;
  attr_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bid), static_cast<const float4*>(at), rays,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// starts [tiles, nw] i32, bid [tiles, tile_r] i32, at [NB * 128, 16] bf16
// (16-byte aligned) -> out [tiles, 16, tile_r] f32
extern "C" int srt_attr_window(const void* starts, int nw, const void* bid,
                               const void* at, int tiles, int tile_r,
                               void* out, int threads, void* stream) {
  if (tiles <= 0 || tile_r <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % 32 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((tile_r + threads - 1) / threads, tiles);
  attr_window_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), nw, static_cast<const int*>(bid),
      static_cast<const uint4*>(at), tile_r, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
