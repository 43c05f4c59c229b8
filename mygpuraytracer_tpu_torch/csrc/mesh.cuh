// Shared device code of the mesh kernels: the plane-form face test and the
// cluster slab test over the 128-face Morton clusters of face_plane
// (scene/device_scene.py), used by the mesh tiers' kernel (mesh_hit.cu) and
// by K5's cluster walk (bounce.cu). Every operation is an _rn intrinsic in
// the plain version's order (ops/mesh_hit.py), so no FMA contraction changes
// a rounding. Include after <cuda_runtime.h> and <math_constants.h>.

#pragma once

namespace {

constexpr int CS = 128;  // faces per cluster
constexpr int Q = 13;    // plane quantities a face test reads (rows 0-12)
constexpr float FACE_HIT_EPS = 1e-4f;
constexpr float DIR_EPS = 1e-20f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float dot_rn(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__device__ __forceinline__ float clamp_eps(float x) { return fabsf(x) < DIR_EPS ? DIR_EPS : x; }

// Slab test of cluster c (trace.py:746-783): true if the ray meets the box
// at some t >= 0; *tin is where it enters. inv = 1 / clamp_eps(d) per axis.
__device__ __forceinline__ bool cluster_slab(const Ray& r, float ix, float iy, float iz,
                                             const float* bounds, int c, int num_clusters,
                                             float* tin_out) {
  const float t1 = __fmul_rn(__fsub_rn(bounds[c], r.ox), ix);
  const float t2 = __fmul_rn(__fsub_rn(bounds[3 * num_clusters + c], r.ox), ix);
  const float u1 = __fmul_rn(__fsub_rn(bounds[num_clusters + c], r.oy), iy);
  const float u2 = __fmul_rn(__fsub_rn(bounds[4 * num_clusters + c], r.oy), iy);
  const float v1 = __fmul_rn(__fsub_rn(bounds[2 * num_clusters + c], r.oz), iz);
  const float v2 = __fmul_rn(__fsub_rn(bounds[5 * num_clusters + c], r.oz), iz);
  const float tin = fmaxf(fmaxf(fminf(t1, t2), fminf(u1, u2)), fminf(v1, v2));
  const float tout = fminf(fminf(fmaxf(t1, t2), fmaxf(u1, u2)), fmaxf(v1, v2));
  *tin_out = tin;
  return tout >= fmaxf(tin, 0.0f);
}

// The cluster can hold a face nearer than the ray's best hit so far.
__device__ __forceinline__ bool cluster_needed(const Ray& r, float ix, float iy, float iz,
                                               const float* bounds, int c, int num_clusters,
                                               float best) {
  float tin;
  return cluster_slab(r, ix, iy, iz, bounds, c, num_clusters, &tin) && tin < best;
}

// Plane-form face test (trace.py:808-836). f points at the face's first
// quantity; quantity q lies at f[q * stride]. True if the face is hit at
// FACE_HIT_EPS < t < best and 0 <= u, 0 <= v, u + v <= 1.
__device__ __forceinline__ bool face_test(const Ray& r, const float* f, int stride, float best,
                                          float* t_out, float* u_out, float* v_out) {
  const float fnx = f[0], fny = f[stride], fnz = f[2 * stride], c = f[3 * stride];
  const float A = dot_rn(r.ox, r.oy, r.oz, fnx, fny, fnz);
  const float B = clamp_eps(dot_rn(r.dx, r.dy, r.dz, fnx, fny, fnz));
  const float t = __fdiv_rn(__fsub_rn(c, A), B);
  const float ux = f[4 * stride], uy = f[5 * stride], uz = f[6 * stride], cu = f[7 * stride];
  const float du = dot_rn(r.dx, r.dy, r.dz, ux, uy, uz);
  const float ou = dot_rn(r.ox, r.oy, r.oz, ux, uy, uz);
  const float u = __fsub_rn(__fadd_rn(ou, __fmul_rn(t, du)), cu);
  const float vx = f[8 * stride], vy = f[9 * stride], vz = f[10 * stride], cv = f[11 * stride];
  const float dv = dot_rn(r.dx, r.dy, r.dz, vx, vy, vz);
  const float ov = dot_rn(r.ox, r.oy, r.oz, vx, vy, vz);
  const float v = __fsub_rn(__fadd_rn(ov, __fmul_rn(t, dv)), cv);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > FACE_HIT_EPS && t < best;
}

}  // namespace
