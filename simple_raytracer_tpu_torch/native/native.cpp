// Host-side native code of the port: the median BVH build and the OBJ scan.
//
// Both give the same arrays, bit for bit, as the Python code they stand in
// for (accel/bvh.py::build_bvh with split="median", and
// scene/obj_loader.py::_parse_obj_python), only faster.  The OBJ scan reads
// a line the way Python does or reports that it cannot (OBJ_DEFER), and the
// caller then runs the Python scan.  A plain C-ABI shared object, bound with
// ctypes and built by native/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BVH build (mirror of accel/bvh.py::build_bvh, split="median")
// ---------------------------------------------------------------------------
// verts: [T, 9] row-major (3 vertices x xyz).  Outputs are caller-allocated:
//   node_min/node_max: [max_nodes, 3]
//   skip, leaf_first, leaf_count: [max_nodes]
//   perm: [T]
// Returns node count M (or -1 if max_nodes too small).  stats_out[0]=max_leaf,
// stats_out[1]=depth.

struct BvhCtx {
  const float* verts;   // [T, 9]
  int leaf_size;
  float* node_min;
  float* node_max;
  int32_t* skip;
  int32_t* leaf_first;
  int32_t* leaf_count;
  int32_t* perm;
  int max_nodes;
  int n_nodes;
  int n_perm;
  int max_leaf;
  int depth;
  bool overflow;
};

static const float FLT_BIG = 3.4028235e38f;

static void tri_bounds(const float* v9, float* bmin, float* bmax) {
  for (int k = 0; k < 3; ++k) {
    float a = v9[k], b = v9[3 + k], c = v9[6 + k];
    bmin[k] = std::min(a, std::min(b, c));
    bmax[k] = std::max(a, std::max(b, c));
  }
}

static void aabb(const BvhCtx& ctx, const int64_t* idx, int n, float* bmin,
                 float* bmax) {
  // Object.cpp:205-221; empty set -> inverted (FLT_MAX, -FLT_MAX) box
  for (int k = 0; k < 3; ++k) { bmin[k] = FLT_BIG; bmax[k] = -FLT_BIG; }
  for (int i = 0; i < n; ++i) {
    float tmin[3], tmax[3];
    tri_bounds(ctx.verts + idx[i] * 9, tmin, tmax);
    for (int k = 0; k < 3; ++k) {
      bmin[k] = std::min(bmin[k], tmin[k]);
      bmax[k] = std::max(bmax[k], tmax[k]);
    }
  }
}

static int longest_axis(const float* bmin, const float* bmax) {
  // Reference tie rule (Object.cpp:240-248): x only if strictly largest,
  // else y only if strictly larger than both, else z.
  float sx = std::fabs(bmax[0] - bmin[0]);
  float sy = std::fabs(bmax[1] - bmin[1]);
  float sz = std::fabs(bmax[2] - bmin[2]);
  if (sx > sy && sx > sz) return 0;
  if (sy > sx && sy > sz) return 1;
  return 2;
}

static void emit(BvhCtx& ctx, int64_t* idx, int n, const float* bmin,
                 const float* bmax, bool force_split, int depth) {
  if (ctx.overflow) return;
  if (ctx.n_nodes >= ctx.max_nodes) { ctx.overflow = true; return; }
  ctx.depth = std::max(ctx.depth, depth);
  int me = ctx.n_nodes++;
  for (int k = 0; k < 3; ++k) {
    ctx.node_min[me * 3 + k] = bmin[k];
    ctx.node_max[me * 3 + k] = bmax[k];
  }
  if (n > ctx.leaf_size || force_split) {
    ctx.leaf_first[me] = -1;
    ctx.leaf_count[me] = 0;
    int axis = longest_axis(bmin, bmax);
    const float* verts = ctx.verts;
    // stable sort by pointOne along the axis (matches np.argsort stable)
    std::stable_sort(idx, idx + n, [verts, axis](int64_t a, int64_t b) {
      return verts[a * 9 + axis] < verts[b * 9 + axis];
    });
    int half = n / 2;
    float lmin[3], lmax[3], rmin[3], rmax[3];
    aabb(ctx, idx, half, lmin, lmax);
    aabb(ctx, idx + half, n - half, rmin, rmax);
    emit(ctx, idx, half, lmin, lmax, false, depth + 1);
    emit(ctx, idx + half, n - half, rmin, rmax, false, depth + 1);
  } else {
    ctx.leaf_first[me] = ctx.n_perm;
    ctx.leaf_count[me] = n;
    ctx.max_leaf = std::max(ctx.max_leaf, n);
    for (int i = 0; i < n; ++i) ctx.perm[ctx.n_perm++] = (int32_t)idx[i];
  }
  ctx.skip[me] = ctx.n_nodes;   // preorder: skip = index after my subtree
}

int bvh_build(const float* verts, int64_t T, int leaf_size, float* node_min,
              float* node_max, int32_t* skip, int32_t* leaf_first,
              int32_t* leaf_count, int32_t* perm, int max_nodes,
              int32_t* stats_out) {
  BvhCtx ctx{verts, leaf_size, node_min, node_max, skip, leaf_first,
             leaf_count, perm, max_nodes, 0, 0, 0, 0, false};
  std::vector<int64_t> idx((size_t)T);
  for (int64_t i = 0; i < T; ++i) idx[(size_t)i] = i;
  float bmin[3], bmax[3];
  aabb(ctx, idx.data(), (int)T, bmin, bmax);
  emit(ctx, idx.data(), (int)T, bmin, bmax, /*force_split=*/T > 0, 0);
  if (ctx.overflow) return -1;
  stats_out[0] = std::max(ctx.max_leaf, 1);
  stats_out[1] = ctx.depth;
  return ctx.n_nodes;
}

// ---------------------------------------------------------------------------
// OBJ scan (mirror of scene/obj_loader.py::_parse_obj_python)
// ---------------------------------------------------------------------------
// The Python scan reads the file in text mode: universal newlines (a line
// ends at \n, \r or \r\n), line.strip(), a '#' line is a comment,
// line.split(), and the line's first token, compared whole, is its tag:
//   v / vn    float() of tokens 1-3, 0.0 where missing, the rest ignored
//   vt        the same over tokens 1-2
//   f         every corner token read by _parse_index (the first three
//             '/'-parts through int(), 1-based or relative to the counts so
//             far, -1 where empty or missing), fan triangles from corner 0
//   usemtl    with a second token: that name starts a material slot
// and numpy casts the floats to f32 (round to nearest even) and the indices
// to i32 (raising beyond its range).
//
// obj_scan(buf, n, counts, ...) scans the file's n bytes (buf[n] == '\0').
// With positions == nullptr it only counts:
//   counts = {positions, texcoords, normals, triangles, bytes of the usemtl
//             names, each followed by '\n'}.
// Otherwise it fills caller-allocated arrays of those sizes:
//   positions [NV, 3] f32, texcoords [NT, 2] f32, normals [NN, 3] f32,
//   faces [NF, 9] i32 (v0,t0,n0, v1,t1,n1, v2,t2,n2; -1 = absent),
//   face_mtl [NF] i32 (index into the names, -1 = none), names.
// Returns OBJ_EXACT, or OBJ_DEFER at the first line that Python might read
// otherwise, or on which it raises: a number outside the plain decimal
// grammar (underscores, hex, inf, nan, a suffix), an index outside int()'s
// ASCII grammar or int32, a tag or a parsed token with a non-ASCII byte
// (Python splits on Unicode whitespace too).  The caller then runs the
// Python scan, which gives its own result or raises its own error.

enum { OBJ_EXACT = 0, OBJ_DEFER = 1 };

static inline bool is_space(char c) {
  // str.isspace() over ASCII: what str.split() and str.strip() cut at
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

static inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

static bool ascii(const char* s, const char* e) {
  for (; s < e; ++s)
    if ((unsigned char)*s >= 0x80) return false;
  return true;
}

// The next whitespace-delimited token [tok, tok_end) of [p, end).
static bool next_token(const char*& p, const char* end, const char*& tok,
                       const char*& tok_end) {
  while (p < end && is_space(*p)) ++p;
  if (p == end) return false;
  tok = p;
  while (p < end && !is_space(*p)) ++p;
  tok_end = p;
  return true;
}

// float(tok) cast to f32, for a plain decimal literal: Python's float() and
// strtod both round it correctly to a double, and the cast to float rounds
// that to nearest even, as numpy's does.  With out == nullptr (the counting
// pass) only the grammar is checked.
static bool read_float(const char* s, const char* e, float* out) {
  const char* q = s;
  if (q < e && (*q == '+' || *q == '-')) ++q;
  const char* d = q;
  while (q < e && is_digit(*q)) ++q;
  bool digits = q > d;
  if (q < e && *q == '.') {
    d = ++q;
    while (q < e && is_digit(*q)) ++q;
    digits = digits || q > d;
  }
  if (!digits) return false;
  if (q < e && (*q == 'e' || *q == 'E')) {
    ++q;
    if (q < e && (*q == '+' || *q == '-')) ++q;
    d = q;
    while (q < e && is_digit(*q)) ++q;
    if (q == d) return false;
  }
  if (q != e) return false;
  if (!out) return true;
  char* stop;
  double v = std::strtod(s, &stop);
  if (stop != e) return false;   // a locale whose decimal point is not '.'
  *out = (float)v;
  return true;
}

// int(part) of a face corner, 1-based or relative to count, in int32.
static bool read_index(const char* s, const char* e, int64_t count,
                       int32_t* out) {
  const char* q = s;
  bool neg = false;
  if (q < e && (*q == '+' || *q == '-')) neg = *q++ == '-';
  if (q == e) return false;
  int64_t i = 0;
  for (; q < e; ++q) {
    if (!is_digit(*q)) return false;
    i = i * 10 + (*q - '0');
    if (i > (int64_t(1) << 40)) return false;   // beyond int32 either way
  }
  if (neg) i = -i;
  const int64_t r = i > 0 ? i - 1 : count + i;
  if (r < INT32_MIN || r > INT32_MAX) return false;
  *out = (int32_t)r;
  return true;
}

// _parse_index: tok.split("/"), the first three parts.
static bool read_corner(const char* s, const char* e, const int64_t* counts,
                        int32_t* out) {
  out[0] = out[1] = out[2] = -1;
  const char* p = s;
  for (int k = 0; k < 3 && p <= e; ++k) {
    const char* q = p;
    while (q < e && *q != '/') ++q;
    if (q > p && !read_index(p, q, counts[k], out + k)) return false;
    p = q + 1;
  }
  return true;
}

int obj_scan(const char* buf, int64_t n, int64_t* counts, float* positions,
             float* texcoords, float* normals, int32_t* faces,
             int32_t* face_mtl, char* names) {
  const bool fill = positions != nullptr;
  int64_t nv = 0, nt = 0, nn = 0, nf = 0, nm = 0, nb = 0;
  int32_t cur_mtl = -1;
  const char* const end = buf + n;
  const char* p = buf;
  while (p < end) {
    const char* q = p;
    while (p < end && *p != '\n' && *p != '\r') ++p;
    const char* const eol = p;
    if (p < end && *p == '\r' && p + 1 < end && p[1] == '\n') ++p;
    if (p < end) ++p;
    const char *tag, *tag_end, *t, *te;
    if (!next_token(q, eol, tag, tag_end) || *tag == '#') continue;
    if (!ascii(tag, tag_end)) return OBJ_DEFER;
    const size_t len = (size_t)(tag_end - tag);
    auto is = [&](const char* s) {
      return len == std::strlen(s) && !std::memcmp(tag, s, len);
    };
    if (is("v") || is("vn") || is("vt")) {
      const int dims = is("vt") ? 2 : 3;
      float x[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < dims && next_token(q, eol, t, te); ++k)
        if (!read_float(t, te, fill ? x + k : nullptr)) return OBJ_DEFER;
      if (dims == 2) {
        if (fill) std::memcpy(texcoords + nt * 2, x, 2 * sizeof(float));
        ++nt;
      } else if (len == 1) {
        if (fill) std::memcpy(positions + nv * 3, x, 3 * sizeof(float));
        ++nv;
      } else {
        if (fill) std::memcpy(normals + nn * 3, x, 3 * sizeof(float));
        ++nn;
      }
    } else if (is("f")) {
      const int64_t cnt[3] = {nv, nt, nn};
      int32_t first[3], prev[3], cur[3];
      int64_t corners = 0;
      for (; next_token(q, eol, t, te); ++corners) {
        if (!read_corner(t, te, cnt, cur)) return OBJ_DEFER;
        if (corners >= 2) {
          if (fill) {
            int32_t* F = faces + nf * 9;
            std::memcpy(F, first, 3 * sizeof(int32_t));
            std::memcpy(F + 3, prev, 3 * sizeof(int32_t));
            std::memcpy(F + 6, cur, 3 * sizeof(int32_t));
            face_mtl[nf] = cur_mtl;
          }
          ++nf;
        }
        if (corners == 0) std::memcpy(first, cur, 3 * sizeof(int32_t));
        std::memcpy(prev, cur, 3 * sizeof(int32_t));
      }
    } else if (is("usemtl") && next_token(q, eol, t, te)) {
      if (!ascii(t, te)) return OBJ_DEFER;
      if (fill) {
        std::memcpy(names + nb, t, (size_t)(te - t));
        names[nb + (te - t)] = '\n';
      }
      nb += te - t + 1;
      cur_mtl = (int32_t)nm++;
    }
  }
  if (!fill) {
    counts[0] = nv; counts[1] = nt; counts[2] = nn;
    counts[3] = nf; counts[4] = nb;
  }
  return OBJ_EXACT;
}

}  // extern "C"
