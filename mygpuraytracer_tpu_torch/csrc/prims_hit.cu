// The wavefront's nearest cube or sphere per ray, with the winner's
// material resolved: ops/trace.py::intersect_primitives_soa in one launch.
//
// The JAX package computes this function in plain jnp (its
// intersect_primitives_soa, a Python loop over the scene's geoms): this
// kernel replaces no Pallas kernel. It exists because the plain version is
// ~1,600 elementwise ATen kernels a bounce on CUDA tensors (~200 a cube or
// sphere test, the selects of the running hit among them), each a few
// microseconds for a few MB. The wrapper is ops/prims_hit.py; the
// dispatch sits in ops/trace.py::intersect_soa, so K1's and K5's plain
// versions keep the plain function.
//
// Inputs: the ray origin and direction, six float32 [n] arrays each with
// its own element stride (the camera's origins are one value expanded:
// stride 0), and the scene's primitive table [num_prims, PRIM_COLS]
// (scene/device_scene.py::primitive_table: one row per cube or sphere, in
// geom order). Outputs,
// everything the plain version's running hit holds after its loop:
//   out_f [15, n] float32: t (+inf on a miss), normal xyz, color xyz,
//                 spec color xyz, spec exponent, reflective, refractive,
//                 ior, emittance;
//   out_i [5, n] int32:    material id, kd, ks, ke, bump texture slots;
//   zero [1]:              one zero word, which the wrapper expands into
//                 the fields that no cube or sphere sets (texcoords u and
//                 v, and is_obj as its first byte).
// A lane with no hit gets the plain version's zeros. Every lane is
// computed, dead ones too, as the plain version does.
//
// Design: one thread a lane, the table's rows read by the whole warp at
// one address. Each test follows box_intersect_soa / sphere_intersect_soa
// operation by operation: every rounding is an _rn intrinsic in the plain
// version's order (no FMA contraction), IEEE division and square root, and
// rsqrtf where v3.normalize calls torch.rsqrt. torch.minimum/maximum and
// clamp_min propagate NaN where fminf/fmaxf do not (a ray parallel to a
// slab gives 0/0), so they are written out. The first geom wins ties
// (t < best). A test whose t is not below the best skips its normal, which
// the plain version computes and then drops. So the kernel equals the plain
// version on the card bit for bit.
//
// Bound on an H100: a lane reads 24 bytes (12 where the origins are one
// expanded camera position) and writes 80 (15 + 5 words), 66.6 MB at
// 640,000 lanes: ~20 us at 3.35 TB/s. The arithmetic is
// ~250 FP32 instructions a test (the IEEE divisions and roots take several
// each), so with 8 tests a lane it is ~1.3 G instructions, ~38 us at
// 33.5e12 a second: the two bounds are close.
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// scene/device_scene.py's row layout.
constexpr int PRIM_TYPE = 0, PRIM_INV = 1, PRIM_XFORM = 13, PRIM_INVT = 25, PRIM_MAT = 34,
              PRIM_INTS = 45, PRIM_COLS = 50;
constexpr int SPHERE = 0, CUBE = 1;  // GeomType
// Output rows (ops/prims_hit.py).
constexpr int OUT_T = 0, OUT_N = 1, OUT_MAT = 4, OUT_F = 15;
constexpr int MAT_FLOATS = 11, OUT_I = 5;
constexpr float HIT_EPS = 1e-4f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float nan_min(float a, float b) {  // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) {  // torch.clamp_min
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = rsqrtf(clamp_min(dot(a, a), 1e-30f));
  return {__fmul_rn(a.x, inv), __fmul_rn(a.y, inv), __fmul_rn(a.z, inv)};
}
__device__ __forceinline__ float length_to(V3 o, V3 p) {  // v3.length(o - p)
  const V3 op = {__fsub_rn(o.x, p.x), __fsub_rn(o.y, p.y), __fsub_rn(o.z, p.z)};
  return sqrtf(dot(op, op));
}

// v3.xform_point / xform_dir on a table's matrix, rows STRIDE floats apart.
template <int STRIDE>
__device__ __forceinline__ float row_dot(const float* m, V3 v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m), v.x), __fmul_rn(__ldg(m + 1), v.y)),
                   __fmul_rn(__ldg(m + 2), v.z));
}
__device__ __forceinline__ V3 xform_point(const float* m, V3 p) {
  return {__fadd_rn(row_dot<4>(m, p), __ldg(m + 3)),
          __fadd_rn(row_dot<4>(m + 4, p), __ldg(m + 7)),
          __fadd_rn(row_dot<4>(m + 8, p), __ldg(m + 11))};
}
template <int STRIDE>
__device__ __forceinline__ V3 xform_dir(const float* m, V3 d) {
  return {row_dot<STRIDE>(m, d), row_dot<STRIDE>(m + STRIDE, d),
          row_dot<STRIDE>(m + 2 * STRIDE, d)};
}

// qo + (t_loc - HIT_EPS) * qd
__device__ __forceinline__ V3 local_point(V3 qo, V3 qd, float t_loc) {
  const float s = __fsub_rn(t_loc, HIT_EPS);
  return {__fadd_rn(qo.x, __fmul_rn(s, qd.x)), __fadd_rn(qo.y, __fmul_rn(s, qd.y)),
          __fadd_rn(qo.z, __fmul_rn(s, qd.z))};
}

struct Slab {
  float ta, tb, sign;
};

__device__ __forceinline__ Slab slab(float qo, float qd) {
  const float t1 = __fdiv_rn(__fsub_rn(-0.5f, qo), qd);
  const float t2 = __fdiv_rn(__fsub_rn(0.5f, qo), qd);
  const float ta = nan_min(t1, t2);
  return {ta > 0.0f ? ta : -1e38f, nan_max(t1, t2), t2 < t1 ? 1.0f : -1.0f};
}

// box_intersect_soa: t (+inf on a miss); the normal only where t < best.
__device__ __forceinline__ float box_hit(const float* g, V3 o, V3 d, float best, V3& normal) {
  const V3 qo = xform_point(g + PRIM_INV, o);
  const V3 qd = normalize(xform_dir<4>(g + PRIM_INV, d));
  const Slab x = slab(qo.x, qd.x), y = slab(qo.y, qd.y), z = slab(qo.z, qd.z);
  const float tmin = nan_max(nan_max(x.ta, y.ta), z.ta);
  const float tmax = nan_min(nan_min(x.tb, y.tb), z.tb);
  if (!((tmax >= tmin) && (tmax > 0.0f))) return CUDART_INF_F;
  const bool inside = tmin <= 0.0f;
  const float t_loc = inside ? tmax : tmin;
  const float t = length_to(o, xform_point(g + PRIM_XFORM, local_point(qo, qd, t_loc)));
  if (!(t < best)) return t;
  // the axis that set t_loc, priority x > y > z
  const bool ux = (inside && x.tb == tmax) || (!inside && x.ta == tmin);
  const bool uy = !ux && ((inside && y.tb == tmax) || (!inside && y.ta == tmin));
  const bool uz = !ux && !uy;
  const V3 ln = {ux ? x.sign : 0.0f, uy ? y.sign : 0.0f, uz ? z.sign : 0.0f};
  normal = normalize(xform_dir<3>(g + PRIM_INVT, ln));
  return t;
}

// sphere_intersect_soa (radius 0.5): t (+inf on a miss); the normal only
// where t < best.
__device__ __forceinline__ float sphere_hit(const float* g, V3 o, V3 d, float best,
                                            V3& normal) {
  const V3 qo = xform_point(g + PRIM_INV, o);
  const V3 qd = normalize(xform_dir<4>(g + PRIM_INV, d));
  const float vd = dot(qo, qd);
  const float radicand = __fsub_rn(__fmul_rn(vd, vd), __fsub_rn(dot(qo, qo), 0.25f));
  const float root = sqrtf(clamp_min(radicand, 0.0f));
  const float t1 = __fadd_rn(-vd, root);
  const float t2 = __fsub_rn(-vd, root);
  const bool both_neg = (t1 < 0.0f) && (t2 < 0.0f);
  const bool both_pos = (t1 > 0.0f) && (t2 > 0.0f);
  if (!((radicand >= 0.0f) && !both_neg)) return CUDART_INF_F;
  const float t_loc = both_pos ? nan_min(t1, t2) : nan_max(t1, t2);
  const V3 p_loc = local_point(qo, qd, t_loc);
  const float t = length_to(o, xform_point(g + PRIM_XFORM, p_loc));
  if (!(t < best)) return t;
  const V3 n = normalize(xform_dir<3>(g + PRIM_INVT, p_loc));
  normal = both_pos ? n : V3{-n.x, -n.y, -n.z};
  return t;
}

__global__ void __launch_bounds__(THREADS)
    prims_hit_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz, int sox,
                     int soy, int soz, int sdx, int sdy, int sdz,
                     const float* __restrict__ table, int num_prims, float* __restrict__ out_f,
                     int* __restrict__ out_i, float* __restrict__ zero, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t l = i;
  const V3 o = {ox[l * sox], oy[l * soy], oz[l * soz]};
  const V3 d = {dx[l * sdx], dy[l * sdy], dz[l * sdz]};
  float best = CUDART_INF_F;
  V3 normal = {0.0f, 0.0f, 0.0f};
  int winner = -1;
  for (int p = 0; p < num_prims; ++p) {
    const float* g = table + static_cast<size_t>(p) * PRIM_COLS;
    const int type = __float_as_int(__ldg(g + PRIM_TYPE));
    V3 nrm;
    float t;
    if (type == CUBE) {
      t = box_hit(g, o, d, best, nrm);
    } else if (type == SPHERE) {
      t = sphere_hit(g, o, d, best, nrm);
    } else {
      continue;
    }
    if (t < best) {
      best = t;
      normal = nrm;
      winner = p;
    }
  }
  const size_t N = static_cast<size_t>(n);
  out_f[OUT_T * N + i] = best;
  out_f[(OUT_N + 0) * N + i] = normal.x;
  out_f[(OUT_N + 1) * N + i] = normal.y;
  out_f[(OUT_N + 2) * N + i] = normal.z;
  const float* g = table + static_cast<size_t>(winner < 0 ? 0 : winner) * PRIM_COLS;
#pragma unroll
  for (int k = 0; k < MAT_FLOATS; ++k) {
    out_f[(OUT_MAT + k) * N + i] = winner < 0 ? 0.0f : __ldg(g + PRIM_MAT + k);
  }
#pragma unroll
  for (int k = 0; k < OUT_I; ++k) {
    out_i[k * N + i] = winner < 0 ? 0 : __float_as_int(__ldg(g + PRIM_INTS + k));
  }
  if (i == 0) *zero = 0.0f;
}

}  // namespace

extern "C" int prims_hit(const float* ox, const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, int sox, int soy, int soz, int sdx,
                         int sdy, int sdz, const float* table, int num_prims, float* out_f,
                         int* out_i, float* zero, int n, void* stream) {
  if (n <= 0) return 0;
  if (num_prims < 0 || sox < 0 || soy < 0 || soz < 0 || sdx < 0 || sdy < 0 || sdz < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  prims_hit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, sox, soy, soz, sdx, sdy, sdz, table, num_prims, out_f, out_i,
      zero, n);
  return static_cast<int>(cudaGetLastError());
}
