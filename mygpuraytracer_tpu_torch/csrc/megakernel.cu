// K1: whole Monte-Carlo iterations of the path tracer in one launch.
//
// Replaces mygpuraytracer_tpu/render/megakernel.py::_make_kernel, the Pallas
// kernel that megakernel_accumulate launches on the TPU. Same function: for
// each pixel, num_iters iterations of AA jitter, thin-lens DoF, the bounce
// loop over cubes, spheres and up to 256 listed triangles, shading
// (render/shade.py), and color * pi added into the accumulator; the albedo
// and normal AOVs are written at iteration 1.
//
// Design. One thread per pixel, 128-thread blocks over N = W*H pixels; the
// iteration loop runs inside the thread, so the nine [N] accumulator planes
// are read and written once per launch. The TPU kernel baked each scene into
// its program; this one is generic: the scene arrives as a packed float
// record (render/megakernel.py::scene_record) and every scalar option is a
// run-time argument, so one build serves every scene. Random numbers are
// threefry2x32 (20 rounds) at the wavefront's counters: draw row r of pixel p
// in iteration i is threefry(fold_in(key(seed), i), (0, r*N + p)), read as
// JAX's uniform, so the kernel sees exactly the numbers of the plain version
// (render/pathtrace.py) and its image equals that one up to float rounding.
// A thread stops its bounce loop once its path has ended; the counters are
// fixed per (row, pixel), so stopping consumes no numbers.
//
// Bound on an H100: FP32 and integer ALU work per ray-bounce, not memory.
// Each sample runs up to 4 + 3*depth threefry draws (28 at depth 8, ~100
// integer operations each) and, per bounce, one slab or quadric test per
// geom plus one Moller-Trumbore test per listed face; paths in a warp
// diverge across materials and bounce counts. Memory is 9 planes x 4 B x N
// read and written once per launch. Making it fast is later work.
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// Record layout (render/megakernel.py).
constexpr int HEADER = 16;        // G, F, camera pos3 view3 up3 right3 pixel_length2
constexpr int GEOM_STRIDE = 48;   // type, material, xform 3x4, inverse 3x4, inv_transpose 3x3,
                                  // color3 spec3 spec_ex refl refr ior emit
constexpr int FACE_STRIDE = 16;   // geom, v0 3, e1 3, e2 3, unit normal 3
constexpr int G_XFORM = 2, G_INV = 14, G_INVT = 26, G_MAT = 35;
constexpr int SPHERE = 0, CUBE = 1;

constexpr int THREADS = 128;
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

// m: a row-major 3x4 matrix whose 4th column is the translation.
__device__ __forceinline__ V3 xform_point(const float* m, V3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
          m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
          m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}
// m: 3 rows of STRIDE floats (4 for a 3x4 matrix, 3 for a 3x3 one).
template <int STRIDE>
__device__ __forceinline__ V3 xform_dir(const float* m, V3 d) {
  return {m[0] * d.x + m[1] * d.y + m[2] * d.z,
          m[STRIDE] * d.x + m[STRIDE + 1] * d.y + m[STRIDE + 2] * d.z,
          m[2 * STRIDE] * d.x + m[2 * STRIDE + 1] * d.y + m[2 * STRIDE + 2] * d.z};
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
__device__ __forceinline__ float box_intersect(const float* g, V3 o, V3 d, V3& normal) {
  const V3 qo = xform_point(g + G_INV, o);
  const V3 qd = normalize(xform_dir<4>(g + G_INV, d));
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
  const V3 p_w = xform_point(g + G_XFORM, p_loc);
  normal = normalize(xform_dir<3>(g + G_INVT, ln));
  const V3 op = sub(o, p_w);
  return sqrtf(dot(op, op));
}

// Sphere of radius 0.5 in object space (intersections.h:102-144).
__device__ __forceinline__ float sphere_intersect(const float* g, V3 o, V3 d, V3& normal) {
  const V3 qo = xform_point(g + G_INV, o);
  const V3 qd = normalize(xform_dir<4>(g + G_INV, d));
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
  const V3 p_w = xform_point(g + G_XFORM, p_loc);
  const V3 n = normalize(xform_dir<3>(g + G_INVT, p_loc));
  normal = both_pos ? n : neg(n);
  const V3 op = sub(o, p_w);
  return sqrtf(dot(op, op));
}

// Nearest hit over geoms then listed faces; the first one wins ties
// (ops/trace.py primitives_hit).
__device__ Hit scene_hit(const float* __restrict__ rec, int num_geoms, int num_faces, V3 o, V3 d) {
  Hit h{CUDART_INF_F, {0.0f, 0.0f, 0.0f}, -1, false};
  for (int gi = 0; gi < num_geoms; ++gi) {
    const float* g = rec + HEADER + GEOM_STRIDE * gi;
    const int type = static_cast<int>(g[0]);
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
  const float* faces = rec + HEADER + GEOM_STRIDE * num_geoms;
  for (int fi = 0; fi < num_faces; ++fi) {
    const float* f = faces + FACE_STRIDE * fi;
    const V3 v0 = load3(f + 1), e1 = load3(f + 4), e2 = load3(f + 7);
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
    if (ok && t < h.t) h = {t, load3(f + 10), static_cast<int>(f[0]), true};
  }
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
__device__ void shade(Path& s, const Hit& h, const float* __restrict__ rec, float u_choice, float u1,
                      float u2) {
  if (h.geom < 0) {  // miss
    s.c = {0.0f, 0.0f, 0.0f};
    s.remaining = 0;
    return;
  }
  const float* m = rec + HEADER + GEOM_STRIDE * h.geom + G_MAT;
  const V3 color = load3(m), spec = load3(m + 3);
  const float spec_ex = m[6], refl = m[7], refr = m[8], ior = m[9], emit = m[10];
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

__global__ void __launch_bounds__(THREADS)
    k1_kernel(const float* __restrict__ rec, float* __restrict__ acc, int n, int width, int height,
              int depth, int start_iter, int num_iters, uint32_t key0, uint32_t key1, int aa,
              int dof, float lens_radius, float focal_distance) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int num_geoms = static_cast<int>(rec[0]);
  const int num_faces = static_cast<int>(rec[1]);
  const V3 cam_pos = load3(rec + 2), view = load3(rec + 5), up = load3(rec + 8),
           right = load3(rec + 11);
  const float pl_x = rec[14], pl_y = rec[15];

  float acc_r = acc[p], acc_g = acc[n + p], acc_b = acc[2 * n + p];
  for (int i = 0; i < num_iters; ++i) {
    const int iteration = start_iter + i;
    uint32_t ik0 = 0u, ik1 = static_cast<uint32_t>(iteration);  // fold_in(key, iteration)
    threefry2x32(key0, key1, ik0, ik1);
    const Stream rng{ik0, ik1, static_cast<uint64_t>(n), static_cast<uint64_t>(p)};

    // raygen (render/camera.py)
    float x = static_cast<float>(p % width);
    float y = static_cast<float>(p / width);
    if (aa) {
      x = x + (rng.uniform(0) - 0.5f);
      y = y + (rng.uniform(1) - 0.5f);
    }
    const float sx = pl_x * (x - static_cast<float>(width) * 0.5f);
    const float sy = pl_y * (y - static_cast<float>(height) * 0.5f);
    V3 d = normalize({view.x - right.x * sx - up.x * sy, view.y - right.y * sx - up.y * sy,
                      view.z - right.z * sx - up.z * sy});
    V3 o = cam_pos;
    if (dof) {  // thin lens, concentric disk (pathtrace.cu:225-293)
      const float ox = 2.0f * rng.uniform(2) - 1.0f;
      const float oy = 2.0f * rng.uniform(3) - 1.0f;
      float lx = 0.0f, ly = 0.0f;
      if (!(ox == 0.0f && oy == 0.0f)) {
        const bool use_x = fabsf(ox) > fabsf(oy);
        const float r = use_x ? ox : oy;
        const float theta = use_x ? 0.785398f * (oy / ox) : 1.570796f - 0.785398f * (ox / oy);
        lx = r * cosf(theta);
        ly = r * sinf(theta);
      }
      lx = lens_radius * lx;
      ly = lens_radius * ly;
      const float ft = fabsf(focal_distance / d.z);
      const V3 focus = {o.x + d.x * ft, o.y + d.y * ft, o.z + d.z * ft};
      o = {o.x + lx, o.y + ly, o.z};
      d = normalize(sub(focus, o));
    }

    Path s{o, d, {1.0f, 1.0f, 1.0f}, depth};
    Hit h = scene_hit(rec, num_geoms, num_faces, o, d);
    if (iteration == 1) {  // first-hit AOVs (render/shade.py albedo_soa)
      V3 alb = {0.0f, 0.0f, 0.0f}, nrm = {0.0f, 0.0f, 0.0f};
      if (h.geom >= 0) {
        const float* m = rec + HEADER + GEOM_STRIDE * h.geom + G_MAT;
        const float emit = m[10];
        alb = (!h.is_obj && emit > 0.0f)   ? mul(load3(m), emit)
              : (!h.is_obj && m[8] > 0.0f) ? load3(m + 3)
                                           : load3(m);
        nrm = h.n;
      }
      acc[3 * n + p] = alb.x;
      acc[4 * n + p] = alb.y;
      acc[5 * n + p] = alb.z;
      acc[6 * n + p] = nrm.x;
      acc[7 * n + p] = nrm.y;
      acc[8 * n + p] = nrm.z;
    }
    for (int b = 0; b < depth; ++b) {
      if (b > 0) {
        if (s.remaining <= 0) break;
        h = scene_hit(rec, num_geoms, num_faces, s.o, s.d);
      }
      shade(s, h, rec, rng.uniform(4 + 3 * b), rng.uniform(5 + 3 * b), rng.uniform(6 + 3 * b));
    }
    // color * pi, then accumulate (two roundings, like the plain version)
    acc_r = acc_r + __fmul_rn(s.c.x, PI_F);
    acc_g = acc_g + __fmul_rn(s.c.y, PI_F);
    acc_b = acc_b + __fmul_rn(s.c.z, PI_F);
  }
  acc[p] = acc_r;
  acc[n + p] = acc_g;
  acc[2 * n + p] = acc_b;
}

}  // namespace

extern "C" int k1_accumulate(const float* rec, float* acc, int n, int width, int height, int depth,
                             int start_iter, int num_iters, uint32_t key0, uint32_t key1, int aa,
                             int dof, float lens_radius, float focal_distance, void* stream) {
  if (n <= 0 || num_iters <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  k1_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rec, acc, n, width, height, depth, start_iter, num_iters, key0, key1, aa, dof, lens_radius,
      focal_distance);
  return static_cast<int>(cudaGetLastError());
}
