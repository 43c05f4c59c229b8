// The mesh tiers K2/K3/K4: for each ray, the nearest mesh face closer than
// its t_cap, over the 128-face Morton clusters of the face buffer.
//
// Replaces three Pallas kernels of mygpuraytracer_tpu/ops/trace.py that
// compute this one function and differ only in how the TPU schedules the
// cluster visits:
//   K2, the rows tier  (per-128-ray-row visit lists, near to far, recheck),
//   K3, the lists tier (per-(8,128)-block visit lists, ascending),
//   K4, the conds tier (in-kernel slab test and lax.cond per cluster,
//                       body in mesh_cluster_hit / _stream_cluster_faces).
// Those schedules (and the sublane-shifted face_shift buffer) are for the
// TPU; here one walk computes their common function. The wrapper is
// ops/mesh_hit.py; ops/trace.py::mesh_rows_hit turns its winner
// (barycentrics and face id) into texcoords and the TBN frame.
//
// Inputs: rays [7, n] (origin xyz, direction xyz, t_cap), face_gather
// [C, 4, 128, 4] (rows 0-12 of face_plane, four rows to a float4, 128 faces
// to a block) and cluster_tree [C - 1, 16] (scene/device_scene.py).
// Outputs [8, n]: t (inf where no face beats t_cap), the winner's face
// normal xyz (unnormalized), geom id (-1: none), barycentric u, v, face id
// (0 where none). The counting build (when visits or stats is given)
// writes visits [n], the clusters each ray tested, and adds into stats [3]
// the interior nodes the rays visited, the warp traversal iterations and
// the warp leaf rounds (mesh.cuh::WalkCount).
//
// Design: one thread per ray, walking the cluster tree on its own stack,
// near child first, with the leaves tested by the whole warp
// (mesh.cuh::walk, shared with K5). The result is the least (t, face id)
// below t_cap, which is what the plain version's ascending walk with its
// strict '<' gives, ties included; only a face whose t rounds below its own
// cluster's box entry can make the two walks differ (mesh.cuh). The walk
// keeps t and the face id; the winner's u and v come from testing its face
// once more after the walk (the same arithmetic, so the same bits), its
// normal and geom id from its face's row. Rays past n take part in the
// warp's rounds; padding and dead-lane rays (origin 1e7, t_cap 0) pass no
// box and visit nothing. The arithmetic is written with the _rn intrinsics
// in the plain version's order, so the kernel equals its plain version
// (ops/mesh_hit.py) bit for bit.
//
// Bound on an H100: operations, not memory. A face test is ~51 FP32
// operations and a correct walk tests at least the clusters whose box the
// ray enters below its final t, x 128 faces; the faces are 1.5 MB (the
// 23k-face ship) and each ray moves ~60 bytes. The design keeps every lane
// testing faces when few of the warp's rays hold a leaf (after bounce 0 the
// rays of a warp scatter), and visits each ray's clusters near to far, so
// its running best prunes the rest. Blocks of 256 threads (the launch takes
// 32 to 256): nothing is block-wide, and on an H100 256 ran 2-10% ahead of
// 64 and 128 (PERF.md).
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mesh.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr float PAD_ORIGIN = 1e7f;  // the padding-ray convention of the tiers

template <bool COUNT>
__global__ void __launch_bounds__(MAX_THREADS)
    mesh_hit_kernel(const float* __restrict__ rays, const float4* __restrict__ faces,
                    const float4* __restrict__ tree, float* __restrict__ out,
                    int* __restrict__ visits, unsigned long long* __restrict__ stats, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % WARP;
  const bool live = i < n;  // threads past n take part in the warp's rounds
  Ray r = {PAD_ORIGIN, PAD_ORIGIN, PAD_ORIGIN, 1.0f, 0.0f, 0.0f};
  float t_cap = 0.0f;
  if (live) {
    r = {rays[i], rays[n + i], rays[2 * n + i], rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
    t_cap = rays[6 * n + i];
  }
  Best best = no_face(t_cap);
  WalkCount count{0u, 0u, 0u, 0u};
  walk<COUNT>(tree, faces, r, live, best, count);
  if (COUNT && stats != nullptr) {  // one atomic per counter and warp
    const unsigned warp_nodes = __reduce_add_sync(FULL, count.nodes);
    const unsigned warp_walk = __reduce_add_sync(FULL, count.walk_iters);
    if (lane == 0) {
      atomicAdd(stats, static_cast<unsigned long long>(warp_nodes));
      atomicAdd(stats + 1, static_cast<unsigned long long>(warp_walk));
      atomicAdd(stats + 2, static_cast<unsigned long long>(count.leaf_rounds));
    }
  }
  if (!live) return;
  float q[Q] = {0.0f}, u = 0.0f, v = 0.0f;
  q[12] = -1.0f;  // geom id: none
  if (best.fid >= 0) {  // the winner's face once more: its u and v
    float t;
    load_face(cluster_faces(faces, best.fid / CS), best.fid % CS, q);
    face_test(r, q, &t, &u, &v);
  }
  out[i] = best.fid >= 0 ? best.t : CUDART_INF_F;
  out[n + i] = q[0];
  out[2 * n + i] = q[1];
  out[3 * n + i] = q[2];
  out[4 * n + i] = q[12];
  out[5 * n + i] = u;
  out[6 * n + i] = v;
  out[7 * n + i] = static_cast<float>(best.fid >= 0 ? best.fid : 0);
  if (COUNT && visits != nullptr) visits[i] = static_cast<int>(count.visits);
}

}  // namespace

extern "C" int mesh_hit(const float* rays, const float* face_gather, const float* tree,
                        float* out, int* visits, unsigned long long* stats, int n,
                        int num_clusters, int tree_depth, int threads, void* stream) {
  if (n <= 0) return 0;
  if (num_clusters < 2 || tree_depth < 1 || tree_depth > MAX_STACK || threads < WARP ||
      threads > MAX_THREADS || threads % WARP != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + threads - 1) / threads;
  auto kernel = (visits != nullptr || stats != nullptr) ? mesh_hit_kernel<true>
                                                        : mesh_hit_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, reinterpret_cast<const float4*>(face_gather), reinterpret_cast<const float4*>(tree),
      out, visits, stats, n);
  return static_cast<int>(cudaGetLastError());
}
