// Shared device code of the whole-iteration kernels K1 (megakernel.cu) and
// K5 (bounce.cu) and of prng.cu's blocks (K6 and threefry): the scene
// record's layout, float3 helpers, threefry2x32 and Philox4x32-10, the
// random streams, the primitive intersection tests and one shading round of
// a path (render/shade.py). Include after <cuda_runtime.h>,
// <math_constants.h> and <stdint.h>; everything lies in an anonymous
// namespace, so each kernel source gets its own copy.

#pragma once

namespace {

// Record layout (render/megakernel.py).
constexpr int HEADER = 16;        // G, F, camera pos3 view3 up3 right3 pixel_length2
constexpr int GEOM_STRIDE = 48;   // type, material, xform 3x4, inverse 3x4, inv_transpose 3x3,
                                  // color3 spec3 spec_ex refl refr ior emit
constexpr int FACE_STRIDE = 16;   // geom, v0 3, e1 3, e2 3, unit normal 3
constexpr int G_XFORM = 2, G_INV = 14, G_INVT = 26, G_MAT = 35;
constexpr int SPHERE = 0, CUBE = 1;

constexpr float HIT_EPS = 1e-4f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float SQRT_ONE_THIRD = 0.57735026918962576451f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = rsqrtf(fmaxf(dot(a, a), 1e-30f));
  return mul(a, inv);
}
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  const float d2 = 2.0f * dot(i, n);
  return {i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// A 3x4 row-major matrix (the 4th column the translation), or a 3x3 one,
// read as m(row, col). RecRows reads the scene record in global memory
// (rows STRIDE floats apart); Rows4 holds three float4 rows in registers.
template <int STRIDE>
struct RecRows {
  const float* p;
  __device__ __forceinline__ float operator()(int r, int c) const { return p[r * STRIDE + c]; }
};

struct Rows4 {
  float4 row[3];
  __device__ __forceinline__ float operator()(int r, int c) const {
    const float4& v = row[r];
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};

template <class M>
__device__ __forceinline__ V3 xform_point(const M& m, V3 p) {
  return {m(0, 0) * p.x + m(0, 1) * p.y + m(0, 2) * p.z + m(0, 3),
          m(1, 0) * p.x + m(1, 1) * p.y + m(1, 2) * p.z + m(1, 3),
          m(2, 0) * p.x + m(2, 1) * p.y + m(2, 2) * p.z + m(2, 3)};
}
template <class M>
__device__ __forceinline__ V3 xform_dir(const M& m, V3 d) {
  return {m(0, 0) * d.x + m(0, 1) * d.y + m(0, 2) * d.z,
          m(1, 0) * d.x + m(1, 1) * d.y + m(1, 2) * d.z,
          m(2, 0) * d.x + m(2, 1) * d.y + m(2, 2) * d.z};
}

// ---- threefry2x32, 20 rounds (ops/rng.py) ---------------------------------
__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

#define TF_ROUND(R) \
  x0 += x1;         \
  x1 = rotl(x1, R); \
  x1 ^= x0;
#define TF_GROUP_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_GROUP_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_GROUP_A
  x0 += k1;
  x1 += k2 + 1u;
  TF_GROUP_B
  x0 += k2;
  x1 += k0 + 2u;
  TF_GROUP_A
  x0 += k0;
  x1 += k1 + 3u;
  TF_GROUP_B
  x0 += k1;
  x1 += k2 + 4u;
  TF_GROUP_A
  x0 += k2;
  x1 += k0 + 5u;
}

// One pixel's draws in one iteration: row r is element (r, p) of the
// [4 + 3*depth, N] uniform block under the iteration key.
struct Stream {
  uint32_t k0, k1;
  uint64_t n, p;
  __device__ __forceinline__ float uniform(int row) const {
    const uint64_t idx = static_cast<uint64_t>(row) * n + p;
    uint32_t x0 = static_cast<uint32_t>(idx >> 32), x1 = static_cast<uint32_t>(idx);
    threefry2x32(k0, k1, x0, x1);
    return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  }
};

// An iteration's key fold_in(base, iteration) from the base key (b0, b1),
// as ops/rng.py::iteration_key computes it on the host.
__device__ __forceinline__ void iteration_key(uint32_t b0, uint32_t b1, uint32_t iteration,
                                              uint32_t& k0, uint32_t& k1) {
  k0 = 0u;
  k1 = iteration;
  threefry2x32(b0, b1, k0, k1);
}

// An iteration's words from the base key (b0, b1) and the iteration, as
// ops/rng.py computes them on the host: its key (iteration_key) and K6's
// seed randint(key) over [0, 2^31 - 1). randint reduces the first draw
// under split(key) with the multiplier ((2^16 mod span)^2 mod 2^32) mod
// span, which is 0 for this span, so the seed is the draw under the second
// split key, element 0, mod the span.
__device__ __forceinline__ void iteration_words(uint32_t b0, uint32_t b1, uint32_t iteration,
                                                uint32_t& k0, uint32_t& k1, int32_t& seed) {
  iteration_key(b0, b1, iteration, k0, k1);
  uint32_t s0 = 0u, s1 = 1u;
  threefry2x32(k0, k1, s0, s1);  // split(key)[1] = fold_in(key, 1)
  uint32_t x0 = 0u, x1 = 0u;
  threefry2x32(s0, s1, x0, x1);  // its draw's element 0
  seed = static_cast<int32_t>((x0 ^ x1) % 0x7FFFFFFFu);
}

// ---- Philox4x32-10 (Salmon et al., SC'11; curand_philox4x32_x.h) ---------
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

struct Words4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Words4 philox4x32_10(uint32_t k0, uint32_t k1, Words4 c) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    // 32x32->64 products: one IMAD.WIDE.U32 each
    const uint64_t p0 = static_cast<uint64_t>(PHILOX_M0) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(PHILOX_M1) * c.z;
    c = {static_cast<uint32_t>(p1 >> 32) ^ c.y ^ k0, static_cast<uint32_t>(p1),
         static_cast<uint32_t>(p0 >> 32) ^ c.w ^ k1, static_cast<uint32_t>(p0)};
  }
  return c;
}

// K6's counter stream (ops/prng.py): element (row, col) of a [k, n] block
// under an int32 seed is word row % 4 of Philox4x32-10 keyed (w, 0), with
// w = seed * MIX + col / 2048, at the counter (row / 4, col % 2048, 0, 0);
// its bits >> 8 times 2^-24 are a uniform in [0, 1) on the 2^-24 grid. The
// value depends on (seed, row, col) alone, not on the block's shape, and one
// Philox call gives the four rows of a group.
constexpr uint32_t MIX = 0x9E3779B1u;
constexpr uint32_t PRNG_BLOCK = 2048u;

__device__ __forceinline__ uint32_t stream_word(int32_t seed, uint32_t col) {
  return static_cast<uint32_t>(seed) * MIX + col / PRNG_BLOCK;
}

// The four words of rows 4 * group .. 4 * group + 3 at column col.
__device__ __forceinline__ Words4 counter_group(uint32_t word, uint32_t group, uint32_t col) {
  return philox4x32_10(word, 0u, {group, col % PRNG_BLOCK, 0u, 0u});
}

__device__ __forceinline__ float word_uniform(uint32_t bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// Word j (0..3) of a group, by selects (a dynamic register index would
// spill the group to local memory).
__device__ __forceinline__ uint32_t group_word(const Words4& g, uint32_t j) {
  return j == 0 ? g.x : j == 1 ? g.y : j == 2 ? g.z : g.w;
}

// ---- the scene ------------------------------------------------------------
// scene_hit and shade read the scene through one of two views with the same
// members: RecScene reads the record in global memory, as scene_record packs
// it (K5); megakernel.cu's SharedScene reads K1's copy in shared memory.
struct Material {
  V3 color, spec;
  float spec_ex, refl, refr, ior, emit;
};

struct Face {
  V3 v0, e1, e2;
};

struct RecGeom {
  const float* g;
  __device__ __forceinline__ int type() const { return static_cast<int>(g[0]); }
  __device__ __forceinline__ RecRows<4> inv() const { return {g + G_INV}; }
  __device__ __forceinline__ RecRows<4> xform() const { return {g + G_XFORM}; }
  __device__ __forceinline__ RecRows<3> invt() const { return {g + G_INVT}; }
};

struct RecScene {
  const float* rec;
  int num_geoms, num_faces;
  __device__ __forceinline__ RecGeom geom(int gi) const { return {rec + HEADER + GEOM_STRIDE * gi}; }
  __device__ __forceinline__ Material material(int gi) const {
    const float* m = rec + HEADER + GEOM_STRIDE * gi + G_MAT;
    return {load3(m), load3(m + 3), m[6], m[7], m[8], m[9], m[10]};
  }
  __device__ __forceinline__ const float* face_at(int fi) const {
    return rec + HEADER + GEOM_STRIDE * num_geoms + FACE_STRIDE * fi;
  }
  __device__ __forceinline__ Face face(int fi) const {
    const float* f = face_at(fi);
    return {load3(f + 1), load3(f + 4), load3(f + 7)};
  }
  __device__ __forceinline__ V3 face_normal(int fi) const { return load3(face_at(fi) + 10); }
  __device__ __forceinline__ int face_geom(int fi) const { return static_cast<int>(face_at(fi)[0]); }
};

// ---- intersection (ops/trace.py) ------------------------------------------
struct Hit {
  float t;  // +inf on a miss
  V3 n;
  int geom;  // -1 on a miss
  bool is_obj;
};

__device__ __forceinline__ void slab(float qo, float qd, float& ta, float& tb, float& sign) {
  const float t1 = (-0.5f - qo) / qd;
  const float t2 = (0.5f - qo) / qd;
  const float a = fminf(t1, t2);
  tb = fmaxf(t1, t2);
  sign = t2 < t1 ? 1.0f : -1.0f;
  ta = a > 0.0f ? a : -1e38f;
}

// Unit cube [-0.5, 0.5]^3 in object space (intersections.h:48-90).
template <class G>
__device__ __forceinline__ float box_intersect(const G& g, V3 o, V3 d, V3& normal) {
  const auto inv = g.inv();
  const V3 qo = xform_point(inv, o);
  const V3 qd = normalize(xform_dir(inv, d));
  float tax, tbx, sx, tay, tby, sy, taz, tbz, sz;
  slab(qo.x, qd.x, tax, tbx, sx);
  slab(qo.y, qd.y, tay, tby, sy);
  slab(qo.z, qd.z, taz, tbz, sz);
  const float tmin = fmaxf(fmaxf(tax, tay), taz);
  const float tmax = fminf(fminf(tbx, tby), tbz);
  if (!((tmax >= tmin) && (tmax > 0.0f))) return CUDART_INF_F;
  const bool inside = tmin <= 0.0f;
  const float t_loc = inside ? tmax : tmin;
  const bool ux = (inside && tbx == tmax) || (!inside && tax == tmin);
  const bool uy = !ux && ((inside && tby == tmax) || (!inside && tay == tmin));
  const bool uz = !ux && !uy;
  const V3 ln = {ux ? sx : 0.0f, uy ? sy : 0.0f, uz ? sz : 0.0f};
  const float s = t_loc - HIT_EPS;
  const V3 p_loc = {qo.x + s * qd.x, qo.y + s * qd.y, qo.z + s * qd.z};
  const V3 p_w = xform_point(g.xform(), p_loc);
  normal = normalize(xform_dir(g.invt(), ln));
  const V3 op = sub(o, p_w);
  return sqrtf(dot(op, op));
}

// Sphere of radius 0.5 in object space (intersections.h:102-144).
template <class G>
__device__ __forceinline__ float sphere_intersect(const G& g, V3 o, V3 d, V3& normal) {
  const auto inv = g.inv();
  const V3 qo = xform_point(inv, o);
  const V3 qd = normalize(xform_dir(inv, d));
  const float vd = dot(qo, qd);
  const float radicand = vd * vd - (dot(qo, qo) - 0.25f);
  const float root = sqrtf(fmaxf(radicand, 0.0f));
  const float t1 = -vd + root;
  const float t2 = -vd - root;
  const bool both_neg = (t1 < 0.0f) && (t2 < 0.0f);
  const bool both_pos = (t1 > 0.0f) && (t2 > 0.0f);
  if (!((radicand >= 0.0f) && !both_neg)) return CUDART_INF_F;
  const float t_loc = both_pos ? fminf(t1, t2) : fmaxf(t1, t2);
  const float s = t_loc - HIT_EPS;
  const V3 p_loc = {qo.x + s * qd.x, qo.y + s * qd.y, qo.z + s * qd.z};
  const V3 p_w = xform_point(g.xform(), p_loc);
  const V3 n = normalize(xform_dir(g.invt(), p_loc));
  normal = both_pos ? n : neg(n);
  const V3 op = sub(o, p_w);
  return sqrtf(dot(op, op));
}

// Nearest hit over geoms then listed faces; the first one wins ties
// (ops/trace.py primitives_hit). The loops run the same count on every
// lane, so a warp stays together through them.
template <class S>
__device__ __forceinline__ Hit scene_hit(const S& scene, V3 o, V3 d) {
  Hit h{CUDART_INF_F, {0.0f, 0.0f, 0.0f}, -1, false};
  for (int gi = 0; gi < scene.num_geoms; ++gi) {
    const auto g = scene.geom(gi);
    const int type = g.type();
    V3 n;
    float t;
    if (type == CUBE) {
      t = box_intersect(g, o, d, n);
    } else if (type == SPHERE) {
      t = sphere_intersect(g, o, d, n);
    } else {
      continue;  // meshes arrive as listed faces below
    }
    if (t < h.t) h = {t, n, gi, false};
  }
  int face = -1;
  for (int fi = 0; fi < scene.num_faces; ++fi) {
    const Face f = scene.face(fi);
    const V3 v0 = f.v0, e1 = f.e1, e2 = f.e2;
    const V3 pv = {d.y * e2.z - d.z * e2.y, d.z * e2.x - d.x * e2.z, d.x * e2.y - d.y * e2.x};
    const float det = e1.x * pv.x + e1.y * pv.y + e1.z * pv.z;
    const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
    const V3 tv = sub(o, v0);
    const float u = dot(tv, pv) * inv_det;
    const V3 qv = {tv.y * e1.z - tv.z * e1.y, tv.z * e1.x - tv.x * e1.z, tv.x * e1.y - tv.y * e1.x};
    const float v = dot(d, qv) * inv_det;
    const float t = (e2.x * qv.x + e2.y * qv.y + e2.z * qv.z) * inv_det;
    const bool ok = (fabsf(det) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                    (t > HIT_EPS);
    if (ok && t < h.t) {
      h.t = t;
      face = fi;
    }
  }
  if (face >= 0) h = {h.t, scene.face_normal(face), scene.face_geom(face), true};
  return h;
}

// ---- shading (render/shade.py) --------------------------------------------
struct Path {
  V3 o, d, c;
  int remaining;
};

__device__ __forceinline__ float schlick(float cos_theta, float ior1, float ior2) {
  float r0 = (ior1 - ior2) / (ior1 + ior2);
  r0 = r0 * r0;
  return r0 + (1.0f - r0) * powf(1.0f - cos_theta, 5.0f);
}

__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta) {
  const float cosi = dot(n, i);
  const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  if (k < 0.0f) return {0.0f, 0.0f, 0.0f};
  const float coef = eta * cosi + sqrtf(fmaxf(k, 0.0f));
  return {eta * i.x - coef * n.x, eta * i.y - coef * n.y, eta * i.z - coef * n.z};
}

__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float u1, float u2) {
  const float up = sqrtf(u1);
  const float over = sqrtf(fmaxf(1.0f - u1, 0.0f));
  const float around = u2 * TWO_PI_F;
  const bool ax = fabsf(n.x) < SQRT_ONE_THIRD;
  const bool ay = fabsf(n.y) < SQRT_ONE_THIRD;
  const V3 nn = {ax ? 1.0f : 0.0f, ax ? 0.0f : (ay ? 1.0f : 0.0f), (ax || ay) ? 0.0f : 1.0f};
  const V3 p1 = normalize(cross(n, nn));
  const V3 p2 = normalize(cross(n, p1));
  const float c = cosf(around) * over;
  const float s = sinf(around) * over;
  return {up * n.x + c * p1.x + s * p2.x, up * n.y + c * p1.y + s * p2.y,
          up * n.z + c * p1.z + s * p2.z};
}

// One shading round for a live path (remaining > 0).
template <class S>
__device__ __forceinline__ void shade(Path& s, const Hit& h, const S& scene, float u_choice,
                                      float u1, float u2) {
  if (h.geom < 0) {  // miss
    s.c = {0.0f, 0.0f, 0.0f};
    s.remaining = 0;
    return;
  }
  const Material m = scene.material(h.geom);
  const V3 color = m.color, spec = m.spec;
  const float spec_ex = m.spec_ex, refl = m.refl, refr = m.refr, ior = m.ior, emit = m.emit;
  if (emit > 0.0f) {
    s.c = {s.c.x * color.x * emit, s.c.y * color.y * emit, s.c.z * color.z * emit};
    s.remaining = 0;
    return;
  }
  if (s.remaining == 1) {
    s.c = {0.0f, 0.0f, 0.0f};
    s.remaining = 0;
    return;
  }
  const V3 p = {s.o.x + h.t * s.d.x, s.o.y + h.t * s.d.y, s.o.z + h.t * s.d.z};
  V3 factor, dir, origin;
  if (refl > 0.0f) {  // mirror (interactions.h:125-133)
    dir = reflect(s.d, h.n);
    const float spec_dot = fmaxf(dot(neg(s.d), dir), 0.0f);
    const float scale = refl * powf(spec_dot, spec_ex);
    factor = {scale * spec.x, scale * spec.y, scale * spec.z};
    origin = add(p, mul(h.n, 0.01f));
  } else if (refr > 0.0f) {  // refractive (interactions.h:134-166)
    const float cos_theta = dot(neg(s.d), h.n);
    const bool entering = cos_theta >= 0.0f;
    const V3 rn = entering ? h.n : neg(h.n);
    const float ior1 = entering ? 1.0f : ior;
    const float ior2 = entering ? ior : 1.0f;
    const float cos_abs = fabsf(cos_theta);
    const float sin_theta = sqrtf(fmaxf(1.0f - cos_abs * cos_abs, 0.0f));
    const bool tir = (ior1 / ior2) * sin_theta > 1.0f;
    const bool choose_reflect = tir || (u_choice < schlick(cos_abs, ior1, ior2));
    dir = choose_reflect ? reflect(s.d, rn) : refract(s.d, rn, ior1 / ior2);
    factor = spec;
    origin = add(p, mul(dir, 0.01f));
  } else if (h.is_obj) {  // untextured OBJ (interactions.h:168-241)
    if (u_choice < schlick(dot(neg(s.d), h.n), 1.0f, ior)) {
      dir = reflect(s.d, h.n);
      factor = spec;
      origin = add(p, mul(h.n, 0.01f));
    } else {
      dir = cosine_hemisphere(h.n, u1, u2);
      factor = color;
      origin = add(p, mul(dir, 0.01f));
    }
  } else {  // diffuse
    dir = cosine_hemisphere(h.n, u1, u2);
    factor = color;
    origin = add(p, mul(dir, 0.01f));
  }
  s.c = {s.c.x * factor.x, s.c.y * factor.y, s.c.z * factor.z};
  s.remaining -= 1;
  s.o = origin;
  s.d = dir;
}

}  // namespace
