// The mesh tiers K2/K3/K4: for each ray, the nearest mesh face closer than
// its t_cap, over the 128-face Morton clusters of the face buffer.
//
// Replaces three Pallas kernels of mygpuraytracer_tpu/ops/trace.py that
// compute this one function and differ only in how the TPU schedules the
// cluster visits:
//   K2 mesh_rows_hit   (per-128-ray-row visit lists, near to far, recheck),
//   K3 mesh_list_hit   (per-(8,128)-block visit lists, ascending),
//   K4 mesh_pallas_hit (in-kernel slab test and lax.cond per cluster,
//                       body in mesh_cluster_hit / _stream_cluster_faces).
// The wrapper is ops/mesh_hit.py; the tier functions in ops/trace.py turn
// its winner (barycentrics and face id) into texcoords and the TBN frame.
//
// Inputs: rays [7, n] (origin xyz, direction xyz, t_cap), the plane-form
// faces face_plane [16, fp] (rows fn xyz, c, U xyz, cu, V xyz, cv, geom;
// scene/device_scene.py), the cluster AABBs [6, C] (min xyz, max xyz).
// Outputs [8, n]: t (inf where no face beats t_cap), the winner's face
// normal xyz (unnormalized), geom id (-1: none), barycentric u, v, face id;
// and, if the pointer is not null, visits [n]: the clusters each ray tested.
//
// Design. One thread per ray, 128 threads per block (one TPU row). The
// block walks the clusters in ascending id. For each, every thread runs the
// slab test against its own running best; __syncthreads_or skips the
// cluster when no ray of the block needs it; otherwise the block copies the
// cluster's 13 x 128 plane quantities (6.5 KB) into shared memory, and each
// thread whose own test passed tests the 128 faces in order with a strict
// '<', so the first minimum wins as in the plain version's first-index
// argmin. All threads read the same face at the same time: broadcasts, no
// bank conflicts. Rays past n and rays with t_cap 0 (padding, dead lanes)
// visit nothing. The arithmetic is written with the _rn intrinsics in the
// plain version's order, so no FMA contraction changes a rounding and the
// kernel equals its plain version (ops/mesh_hit.py) bit for bit.
//
// Bound on an H100: operations, not memory. A face test is ~51 FP32
// operations and a ray makes visits x 128 of them; the faces are 1.5 MB
// (the 23k-face ship) and each ray moves ~64 bytes. What this simple design
// does about it: the shared-memory panel keeps the face reads off the
// memory system, and the block-wide skip drops clusters no ray needs. It
// visits clusters in id order, not near to far, and does not recheck a
// visit against the block's running best (K2's order and recheck,
// trace.py:1168-1195); those change only the speed and which face wins
// among exactly equal t, and are the first speed work for this kernel.
//
// The slab and face tests live in mesh.cuh, which K5 shares. Built by
// mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mesh.cuh"

namespace {

constexpr int THREADS = 128;
constexpr float PAD_ORIGIN = 1e7f;  // the padding-ray convention of the tiers

__global__ void __launch_bounds__(THREADS)
mesh_hit_kernel(const float* __restrict__ rays, const float* __restrict__ face_plane,
                const float* __restrict__ bounds, float* __restrict__ out,
                int* __restrict__ visits, int n, int fp_stride, int num_clusters) {
  __shared__ float faces[Q * CS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  Ray r = {PAD_ORIGIN, PAD_ORIGIN, PAD_ORIGIN, 1.0f, 0.0f, 0.0f};
  float best = 0.0f;
  if (live) {
    r = {rays[i], rays[n + i], rays[2 * n + i], rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
    best = rays[6 * n + i];
  }
  const float ix = __fdiv_rn(1.0f, clamp_eps(r.dx));
  const float iy = __fdiv_rn(1.0f, clamp_eps(r.dy));
  const float iz = __fdiv_rn(1.0f, clamp_eps(r.dz));
  float fnx = 0.0f, fny = 0.0f, fnz = 0.0f, gid = -1.0f, bu = 0.0f, bv = 0.0f, fid = 0.0f;
  int n_visits = 0;
  for (int c = 0; c < num_clusters; ++c) {
    const bool need = cluster_needed(r, ix, iy, iz, bounds, c, num_clusters, best);
    // Also the barrier that ends every thread's reads of the last panel.
    if (!__syncthreads_or(need)) continue;
    for (int k = threadIdx.x; k < Q * CS; k += blockDim.x) {
      faces[k] = face_plane[(k / CS) * fp_stride + c * CS + k % CS];
    }
    __syncthreads();
    if (!need) continue;
    ++n_visits;
    for (int j = 0; j < CS; ++j) {
      float t, u, v;
      if (face_test(r, faces + j, CS, best, &t, &u, &v)) {
        best = t;
        fnx = faces[j];
        fny = faces[CS + j];
        fnz = faces[2 * CS + j];
        gid = faces[12 * CS + j];
        bu = u;
        bv = v;
        fid = static_cast<float>(c * CS + j);
      }
    }
  }
  if (!live) return;
  out[i] = gid >= 0.0f ? best : CUDART_INF_F;
  out[n + i] = fnx;
  out[2 * n + i] = fny;
  out[3 * n + i] = fnz;
  out[4 * n + i] = gid;
  out[5 * n + i] = bu;
  out[6 * n + i] = bv;
  out[7 * n + i] = fid;
  if (visits != nullptr) visits[i] = n_visits;
}

}  // namespace

extern "C" int mesh_hit(const float* rays, const float* face_plane, const float* bounds,
                        float* out, int* visits, int n, int fp_stride, int num_clusters,
                        void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_hit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, face_plane, bounds, out, visits, n, fp_stride, num_clusters);
  return static_cast<int>(cudaGetLastError());
}
