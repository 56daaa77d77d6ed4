// The shading of a frame's hits: ray, t and triangle id -> tone-mapped
// radiance over S light samples, one thread a ray, in one launch.
//
// Replaces no TPU kernel: the JAX package shades in jnp
// (render/integrator.py::shade_records), and XLA fuses it.  The port shaded
// one PyTorch op at a time (render/integrator.py::shade_plain, its plain
// version: a [T, ~32] record table rebuilt and gathered each frame, then
// some 25 ops a light sample), about 500 small launches a frame at S = 16,
// which held the card idle while the host dispatched them.  Reached through
// render/integrator.py::shade for CUDA tensors, no record given and no
// gradient to carry (integrator.shade_route).
//
// What bounds it on this card: bytes, about 190 a ray at S = 16 (the ray,
// t and id, a shadow flag a sample, the hit triangle's rows, one texel,
// the radiance); its ~1,000 f32 operations a ray take less time.
// Design: one thread a ray; the hit triangle's rows are read-only gathers
// by id from the scene's own tensors (no per-frame table); the shadow
// flags are sample-major, so each sample's read is coalesced over a warp.
//
// The arithmetic is ops/shading.py's, in its order, built with
// --fmad=false (kernels/build.py): each multiply and add rounds on its own,
// as PyTorch's elementwise kernels round each op.  Its 3-term sums are
// those of PyTorch's CUDA reduction (ATen/native/cuda/Reduce.cuh), whose
// terms start from the identity 0 (so -0 becomes +0): a sum over the last
// axis of [..., 3] splits its terms over two threads, (x + z) + y
// (sum_last; the 2-norm likewise, over the squares); a sum over the
// vertex axis of [..., 3, k] runs in order, (a + b) + c (sum_vertices).
// A division by a host scalar is a multiplication by its f32 reciprocal,
// as torch's division by a Python number is (inv_dim).  The powers are
// CUDA's powf, as torch.pow's, with torch.pow's special exponents of the
// tone map (pow_gamma).  Divisions and square roots are IEEE.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInvPi = 0.3183098861837907f;  // ops/shading.py::INV_PI

// torch.pow(x, gamma) with a host exponent: its special cases
// (ATen's pow_tensor_scalar), else powf.  kind: 0 powf, 1 x^2, 2 x^3,
// 3 x^-2, 4 x^0.5, 5 x^-0.5, 6 x^-1 (render/integrator.py::POW_KINDS).
__device__ __forceinline__ float pow_gamma(float x, float g, int kind) {
  switch (kind) {
    case 1: return x * x;
    case 2: return x * x * x;
    case 3: return static_cast<float>(1.0 / static_cast<double>(x * x));
    case 4: return sqrtf(x);
    case 5: return rsqrtf(x);
    case 6: return 1.0f / x;
    default: return powf(x, g);
  }
}

// sum over the last axis of a [..., 3] tensor
__device__ __forceinline__ float sum_last(float x, float y, float z) {
  return ((0.0f + x) + (0.0f + z)) + (0.0f + y);
}

// sum over the vertex axis of a [..., 3, k] tensor
__device__ __forceinline__ float sum_vertices(float a, float b, float c) {
  return ((0.0f + a) + (0.0f + b)) + (0.0f + c);
}

// torch.linalg.norm over the last axis
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(sum_last(x * x, y * y, z * z));
}

// clamp_min(x, 0): NaN in, NaN out
__device__ __forceinline__ float clamp0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

struct ShadeArgs {
  const float* o;           // [R, 3]
  const float* d;           // [R, 3]
  const float* t;           // [R], inf on a miss
  const int* idx;           // [R], -1 on a miss (reads triangle 0)
  const float* verts;       // [T, 3, 4] homogeneous
  const float* normals;     // [T, 3, 3] vertex normals, or [T, 3] flat
  const float* uvs;         // [T, 3, 2] texel coordinates
  const int* tri_obj;       // [T]
  const int* tri_tex;       // [T], -1: no texture
  const float* obj_color;   // [O, 3]
  const float* obj_ambient;
  const float* obj_specular;
  const float* obj_shininess;
  const float* tex_data;    // [P, 3]
  const int* tex_offset;    // [K]
  const int* tex_width;
  const int* tex_height;
  const float* samples;     // [S, 3] light sample positions
  const unsigned char* found;  // [S, R] bool, sample-major
  float* out;               // [R, 3]
  float light[3];
  float inv_dim, offset, gamma;
  int n_rays, n_samples, gamma_kind, double_sided, specular_nl;
};

template <bool Smooth, bool Textured, bool Shadow, bool Tonemap>
__global__ void __launch_bounds__(kThreads) shade_kernel(const ShadeArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n_rays) return;
  const int tri = max(__ldg(a.idx + r), 0);
  const float tv = __ldg(a.t + r);
  const float ts = isfinite(tv) ? tv : 0.0f;
  float p[3], dir[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dir[k] = __ldg(a.d + 3 * r + k);
    p[k] = __ldg(a.o + 3 * r + k) + ts * dir[k];
  }
  // barycentrics (ops/shading.py::barycentric) of smooth or textured hits
  float bu = 0.0f, bv = 0.0f, bw = 0.0f;
  if (Smooth || Textured) {
    float c[3][3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float* row = a.verts + 12 * tri + 4 * v;
      const float w = __ldg(row + 3);
#pragma unroll
      for (int k = 0; k < 3; ++k) c[v][k] = __ldg(row + k) / w;
    }
    float e0[3], e1[3], e2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e0[k] = c[1][k] - c[0][k];
      e1[k] = c[2][k] - c[0][k];
      e2[k] = p[k] - c[0][k];
    }
    const float d00 = sum_last(e0[0] * e0[0], e0[1] * e0[1], e0[2] * e0[2]);
    const float d01 = sum_last(e0[0] * e1[0], e0[1] * e1[1], e0[2] * e1[2]);
    const float d11 = sum_last(e1[0] * e1[0], e1[1] * e1[1], e1[2] * e1[2]);
    const float d20 = sum_last(e2[0] * e0[0], e2[1] * e0[1], e2[2] * e0[2]);
    const float d21 = sum_last(e2[0] * e1[0], e2[1] * e1[1], e2[2] * e1[2]);
    const float denom = d00 * d11 - d01 * d01;
    bv = (d11 * d20 - d01 * d21) / denom;
    bw = (d00 * d21 - d01 * d20) / denom;
    bu = 1.0f - bv - bw;
  }
  // material, and the texel of a textured hit (ops/shading.py::
  // texture_fetch: truncation, no wrap, clamp to the texture)
  const int obj = __ldg(a.tri_obj + tri);
  float base[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) base[k] = __ldg(a.obj_color + 3 * obj + k);
  if (Textured) {
    const int tex = __ldg(a.tri_tex + tri);
    if (tex >= 0) {
      const float* uv = a.uvs + 6 * tri;
      const float tx = sum_vertices(bu * __ldg(uv), bv * __ldg(uv + 2),
                                    bw * __ldg(uv + 4));
      const float ty = sum_vertices(bu * __ldg(uv + 1), bv * __ldg(uv + 3),
                                    bw * __ldg(uv + 5));
      const long long w = __ldg(a.tex_width + tex);
      const long long h = __ldg(a.tex_height + tex);
      const long long x = min(max(static_cast<long long>(
                                      static_cast<int>(tx)), 0LL), w - 1);
      const long long y = min(max(static_cast<long long>(
                                      static_cast<int>(ty)), 0LL), h - 1);
      const float* texel =
          a.tex_data + 3 * (__ldg(a.tex_offset + tex) + y * w + x);
#pragma unroll
      for (int k = 0; k < 3; ++k) base[k] = __ldg(texel + k);
    }
  }
  // the normal: interpolated vertex normals, or the flat one
  float n[3];
  if (Smooth) {
    const float* vn = a.normals + 9 * tri;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      n[k] = sum_vertices(bu * __ldg(vn + k), bv * __ldg(vn + 3 + k),
                          bw * __ldg(vn + 6 + k));
    const float len = norm3(n[0], n[1], n[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = n[k] / len;
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = __ldg(a.normals + 3 * tri + k);
  }
  // ops/shading.py::phong's terms that do not depend on the sample
  const float amb = __ldg(a.obj_ambient + obj);
  const float spec = __ldg(a.obj_specular + obj);
  const float shin = __ldg(a.obj_shininess + obj);
  const float dn = norm3(dir[0], dir[1], dir[2]);
  float view[3], diff[3], ambient[3], spec_c[3], acc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    view[k] = -dir[k] / dn;
    diff[k] = kInvPi * base[k] * a.light[k];
    ambient[k] = kInvPi * amb * base[k] * a.light[k];
    spec_c[k] = a.light[k] * spec;
    acc[k] = 0.0f;
  }
  for (int s = 0; s < a.n_samples; ++s) {
    float l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) l[k] = __ldg(a.samples + 3 * s + k) - p[k];
    const float ll = norm3(l[0], l[1], l[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) l[k] = l[k] / ll;
    float nl = sum_last(n[0] * l[0], n[1] * l[1], n[2] * l[2]);
    nl = a.double_sided ? fabsf(nl) : clamp0(nl);
    // reflect(-l, n) = -l - 2 (n . -l) n
    const float two = 2.0f * sum_last(n[0] * -l[0], n[1] * -l[1],
                                      n[2] * -l[2]);
    float rf[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rf[k] = -l[k] - two * n[k];
    const float rv = clamp0(sum_last(rf[0] * view[0], rf[1] * view[1],
                                     rf[2] * view[2]));
    const float pw = powf(rv, shin);
    const float nlf = a.specular_nl ? nl : 1.0f;
    const bool dim = Shadow && a.found[(long long)s * a.n_rays + r];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float c = diff[k] * nl + spec_c[k] * nlf * pw + ambient[k];
      if (dim) c = c * a.inv_dim;
      acc[k] = acc[k] + c;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float c = acc[k];
    if (Tonemap)
      c = pow_gamma(clamp0(c / (c + a.offset)), a.gamma, a.gamma_kind);
    a.out[3 * r + k] = c;
  }
}

template <bool Smooth, bool Textured>
cudaError_t launch(const ShadeArgs& a, bool shadow, bool tonemap,
                   cudaStream_t stream) {
  const int grid = (a.n_rays + kThreads - 1) / kThreads;
  if (shadow && tonemap)
    shade_kernel<Smooth, Textured, true, true>
        <<<grid, kThreads, 0, stream>>>(a);
  else if (shadow)
    shade_kernel<Smooth, Textured, true, false>
        <<<grid, kThreads, 0, stream>>>(a);
  else if (tonemap)
    shade_kernel<Smooth, Textured, false, true>
        <<<grid, kThreads, 0, stream>>>(a);
  else
    shade_kernel<Smooth, Textured, false, false>
        <<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Radiance `out` [R, 3] of R rays (o, d [R, 3], t [R], idx [R]) against the
// scene's tensors (normals: vertex normals [T, 3, 3] with `smooth`, else
// the flat normals [T, 3]; uvs and the texture atlas read with `textured`
// alone), S light samples [S, 3] of colour `light` [3], each divided by
// `shadow_dim` (times its reciprocal inv_dim) where `found` [S, R] is set
// (null: no shadow), summed, then with `tonemap` the Reinhard variant
// c / (c + offset) and the power gamma (gamma_kind, pow_gamma).
extern "C" int srt_shade(const void* o, const void* d, const void* t,
                         const void* idx, int n_rays, const void* verts,
                         const void* normals, const void* uvs,
                         const void* tri_obj, const void* tri_tex,
                         const void* obj_color, const void* obj_ambient,
                         const void* obj_specular, const void* obj_shininess,
                         const void* tex_data, const void* tex_offset,
                         const void* tex_width, const void* tex_height,
                         const void* samples, int n_samples,
                         const void* found, const float* light,
                         float inv_dim, float offset, float gamma,
                         int gamma_kind, int smooth, int textured,
                         int tonemap, int double_sided, int specular_nl,
                         void* out, void* stream) {
  if (n_rays < 0 || n_samples < 0 || gamma_kind < 0 || gamma_kind > 6 ||
      !light || (textured && !uvs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return 0;
  ShadeArgs a;
  a.o = static_cast<const float*>(o);
  a.d = static_cast<const float*>(d);
  a.t = static_cast<const float*>(t);
  a.idx = static_cast<const int*>(idx);
  a.verts = static_cast<const float*>(verts);
  a.normals = static_cast<const float*>(normals);
  a.uvs = static_cast<const float*>(uvs);
  a.tri_obj = static_cast<const int*>(tri_obj);
  a.tri_tex = static_cast<const int*>(tri_tex);
  a.obj_color = static_cast<const float*>(obj_color);
  a.obj_ambient = static_cast<const float*>(obj_ambient);
  a.obj_specular = static_cast<const float*>(obj_specular);
  a.obj_shininess = static_cast<const float*>(obj_shininess);
  a.tex_data = static_cast<const float*>(tex_data);
  a.tex_offset = static_cast<const int*>(tex_offset);
  a.tex_width = static_cast<const int*>(tex_width);
  a.tex_height = static_cast<const int*>(tex_height);
  a.samples = static_cast<const float*>(samples);
  a.found = static_cast<const unsigned char*>(found);
  a.out = static_cast<float*>(out);
  for (int k = 0; k < 3; ++k) a.light[k] = light[k];
  a.inv_dim = inv_dim;
  a.offset = offset;
  a.gamma = gamma;
  a.n_rays = n_rays;
  a.n_samples = n_samples;
  a.gamma_kind = gamma_kind;
  a.double_sided = double_sided;
  a.specular_nl = specular_nl;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool shadow = found != nullptr, tm = tonemap != 0;
  cudaError_t e;
  if (smooth && textured)
    e = launch<true, true>(a, shadow, tm, st);
  else if (smooth)
    e = launch<true, false>(a, shadow, tm, st);
  else if (textured)
    e = launch<false, true>(a, shadow, tm, st);
  else
    e = launch<false, false>(a, shadow, tm, st);
  return static_cast<int>(e);
}
