// K5: one iteration's whole bounce loop for scenes with large untextured
// meshes, in one launch.
//
// Replaces mygpuraytracer_tpu/render/megakernel.py::_make_bounce_kernel, the
// Pallas kernel that bvh_bounce_accumulate launches once per iteration on
// the TPU. Same function: from the camera rays (raygen runs outside), for
// each pixel the bounce loop of primitive tests, the near-to-far walk over
// the mesh's 128-face clusters (ops/trace.py::mesh_nearfar_hit), shading
// (path.cuh::shade, render/shade.py), and color * pi added into the
// accumulator; the first-hit albedo and normal are written at iteration 1.
//
// Inputs: rays [6, n] (origin xyz, direction xyz), the scene record
// (render/megakernel.py::scene_record: camera, geoms with their materials;
// its listed faces are not read), face_plane [16, fp] and the cluster AABBs
// [6, C] (scene/device_scene.py). Output: rows 0-8 of acc [9, n] and, if the
// pointer is not null, visits [n] gains the clusters each ray tested over
// the launch's bounces.
//
// Design. One thread per ray, 128 threads per block: a block is the TPU
// kernel's 128-ray row, and the walk is the block's. Per bounce:
//   1. each thread tests the primitives: t_cap, its nearest primitive hit;
//   2. each thread slab-tests every cluster; a warp minimum and a pass over
//      the warps leave in shared memory the row's key per cluster, the least
//      entry distance of its alive rays whose slab passes closer than their
//      t_cap (+inf where none);
//   3. the block repeatedly picks the unvisited cluster of least key (the
//      lowest index among equal keys), copies its 13 x 128 plane quantities
//      into shared memory, and every alive thread whose own slab test passes
//      against its running best tests the 128 faces in order with a strict
//      '<' (mesh.cuh::face_test); the walk stops when the least remaining
//      key is not below the worst running best of the row's alive rays, or
//      when the keys are exhausted. The second bound is load-bearing: a row
//      whose best t stays +inf (open sky) would otherwise walk for ever;
//   4. shade; the loop ends early once no thread of the block is alive
//      (__syncthreads_or), as the TPU kernel's guarded cond did.
// Threads past n and dead paths take part in every block-wide step and
// contribute nothing to the keys or the bound; no thread returns early.
//
// Random numbers follow RenderOptions.rng. Bounce b draws rows 4 + 3b ..
// 6 + 3b at counter pixel: from threefry under fold_in(key(seed), iteration)
// at (0, row * n + pixel), as ops/rng.py draws the wavefront's block, or
// from K6's counter stream (path.cuh::counter_uniform) under the iteration's
// seed. Either way K5 sees exactly the numbers of the wavefront under the
// same rng, and its image equals that one up to float rounding and to which
// face wins among faces at exactly equal t (the walk visits clusters near
// to far, the plain version in ascending id).
//
// Bound on an H100: operations. Per ray-bounce, the primitive tests and
// shade of K1, three draws and the face tests of the clusters the ray
// visits (visits x 128 x ~51 FP32 operations); the accumulator is 9 planes
// of 4 B read and written once. This simple design re-derives the keys with
// C slab tests per thread and bounce, and a block visits a cluster when any
// of its rays needs it; both are speed work for later.
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mesh.cuh"
#include "path.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTERS = 1024;  // keys held in shared memory
constexpr unsigned FULL_MASK = 0xffffffffu;

// One pixel's numbers in one iteration: row r at counter p.
struct Draws {
  Stream tf;      // threefry, element (r, p) of the [rows, n] block
  uint32_t word;  // K6's stream word of p's 2048-column block
  uint32_t col;   // p
  bool counter;   // K6's counter stream instead of threefry
  __device__ __forceinline__ float uniform(int row) const {
    return counter ? counter_uniform(word, static_cast<uint32_t>(row), col) : tf.uniform(row);
  }
};

// The block's least key over key[0, num_clusters) with its lowest index, and
// the largest of the threads' `bound` values; every thread gets both. red
// and red_i are shared scratch of 2 * WARPS floats and WARPS ints.
__device__ void block_pick(const float* key, int num_clusters, float bound, float* red,
                           int* red_i, float* m_out, int* c_out, float* bound_out) {
  float m = CUDART_INF_F;
  int c = num_clusters;
  for (int k = threadIdx.x; k < num_clusters; k += blockDim.x) {
    if (key[k] < m) {
      m = key[k];
      c = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(FULL_MASK, m, off);
    const int oc = __shfl_xor_sync(FULL_MASK, c, off);
    if (om < m || (om == m && oc < c)) {
      m = om;
      c = oc;
    }
    bound = fmaxf(bound, __shfl_xor_sync(FULL_MASK, bound, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = m;
    red_i[warp] = c;
    red[WARPS + warp] = bound;
  }
  __syncthreads();
  m = red[0];
  c = red_i[0];
  bound = red[WARPS];
  const int warps = (blockDim.x + 31) >> 5;
  for (int w = 1; w < warps; ++w) {
    if (red[w] < m || (red[w] == m && red_i[w] < c)) {
      m = red[w];
      c = red_i[w];
    }
    bound = fmaxf(bound, red[WARPS + w]);
  }
  *m_out = m;
  *c_out = c;
  *bound_out = bound;
}

__global__ void __launch_bounds__(THREADS)
    k5_kernel(const float* __restrict__ rays, const float* __restrict__ rec,
              const float* __restrict__ face_plane, const float* __restrict__ bounds,
              float* __restrict__ acc, int* __restrict__ visits, int n, int depth, int iteration,
              int counter, uint32_t key0, uint32_t key1, int32_t seed, int fp_stride,
              int num_clusters) {
  __shared__ float faces[Q * CS];
  __shared__ float key[MAX_CLUSTERS];
  __shared__ float warp_key[WARPS * MAX_CLUSTERS];
  __shared__ float red[2 * WARPS];
  __shared__ int red_i[WARPS];

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_image = p < n;
  const int warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
  const int num_geoms = static_cast<int>(rec[0]);
  const Draws rng{{key0, key1, static_cast<uint64_t>(n), static_cast<uint64_t>(p)},
                  stream_word(seed, static_cast<uint32_t>(p)), static_cast<uint32_t>(p),
                  counter != 0};

  Path s{{0.0f, 0.0f, 0.0f}, {1.0f, 0.0f, 0.0f}, {1.0f, 1.0f, 1.0f}, depth};
  if (in_image) {
    s.o = {rays[p], rays[n + p], rays[2 * n + p]};
    s.d = {rays[3 * n + p], rays[4 * n + p], rays[5 * n + p]};
  }
  int n_visits = 0;
  for (int b = 0; b < depth; ++b) {
    const bool alive = in_image && s.remaining > 0;
    if (!__syncthreads_or(alive)) break;  // every path of the block has ended
    Hit h{CUDART_INF_F, {0.0f, 0.0f, 0.0f}, -1, false};
    if (alive) h = scene_hit(rec, num_geoms, 0, s.o, s.d);

    // The mesh: near-to-far cluster walk (ops/trace.py::mesh_nearfar_hit).
    const Ray r{s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z};
    const float ix = __fdiv_rn(1.0f, clamp_eps(r.dx));
    const float iy = __fdiv_rn(1.0f, clamp_eps(r.dy));
    const float iz = __fdiv_rn(1.0f, clamp_eps(r.dz));
    const float t_cap = h.t;
    for (int c = 0; c < num_clusters; ++c) {
      float tin = CUDART_INF_F;
      const bool reaches = alive && cluster_slab(r, ix, iy, iz, bounds, c, num_clusters, &tin) &&
                           tin < t_cap;
      float v = reaches ? tin : CUDART_INF_F;
      for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, off));
      if ((threadIdx.x & 31) == 0) warp_key[warp * MAX_CLUSTERS + c] = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < num_clusters; c += blockDim.x) {
      float v = warp_key[c];
      for (int w = 1; w < warps; ++w) v = fminf(v, warp_key[w * MAX_CLUSTERS + c]);
      key[c] = v;
    }
    __syncthreads();
    float best = t_cap, fnx = 0.0f, fny = 0.0f, fnz = 0.0f, gid = -1.0f;
    for (;;) {
      float m, bound;
      int c;
      block_pick(key, num_clusters, alive ? best : -CUDART_INF_F, red, red_i, &m, &c, &bound);
      if (!(m < bound && m < CUDART_INF_F)) break;  // nothing nearer left, or keys exhausted
      if (threadIdx.x == 0) key[c] = CUDART_INF_F;  // every thread has read the keys
      for (int k = threadIdx.x; k < Q * CS; k += blockDim.x) {
        faces[k] = face_plane[(k / CS) * fp_stride + c * CS + k % CS];
      }
      __syncthreads();
      if (alive && cluster_needed(r, ix, iy, iz, bounds, c, num_clusters, best)) {
        ++n_visits;
        for (int j = 0; j < CS; ++j) {
          float t, u, v;
          if (face_test(r, faces + j, CS, best, &t, &u, &v)) {
            best = t;
            fnx = faces[j];
            fny = faces[CS + j];
            fnz = faces[2 * CS + j];
            gid = faces[12 * CS + j];
          }
        }
      }
      __syncthreads();  // the panel and red are free again
    }
    if (gid >= 0.0f) h = {best, normalize({fnx, fny, fnz}), static_cast<int>(gid), true};

    if (b == 0 && iteration == 1 && in_image) {  // first-hit AOVs (render/shade.py albedo_soa)
      V3 alb = {0.0f, 0.0f, 0.0f}, nrm = {0.0f, 0.0f, 0.0f};
      if (h.geom >= 0) {
        const float* mat = rec + HEADER + GEOM_STRIDE * h.geom + G_MAT;
        const float emit = mat[10];
        alb = (!h.is_obj && emit > 0.0f)     ? mul(load3(mat), emit)
              : (!h.is_obj && mat[8] > 0.0f) ? load3(mat + 3)
                                             : load3(mat);
        nrm = h.n;
      }
      acc[3 * n + p] = alb.x;
      acc[4 * n + p] = alb.y;
      acc[5 * n + p] = alb.z;
      acc[6 * n + p] = nrm.x;
      acc[7 * n + p] = nrm.y;
      acc[8 * n + p] = nrm.z;
    }
    if (alive) {
      shade(s, h, rec, rng.uniform(4 + 3 * b), rng.uniform(5 + 3 * b), rng.uniform(6 + 3 * b));
    }
  }
  if (!in_image) return;
  // color * pi, then accumulate (two roundings, like the plain version)
  acc[p] = acc[p] + __fmul_rn(s.c.x, PI_F);
  acc[n + p] = acc[n + p] + __fmul_rn(s.c.y, PI_F);
  acc[2 * n + p] = acc[2 * n + p] + __fmul_rn(s.c.z, PI_F);
  if (visits != nullptr) visits[p] += n_visits;
}

}  // namespace

extern "C" int k5_bounce(const float* rays, const float* rec, const float* face_plane,
                         const float* bounds, float* acc, int* visits, int n, int depth,
                         int iteration, int counter, uint32_t key0, uint32_t key1, int seed,
                         int fp_stride, int num_clusters, void* stream) {
  if (n <= 0) return 0;
  if (num_clusters < 0 || num_clusters > MAX_CLUSTERS) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + THREADS - 1) / THREADS;
  k5_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, rec, face_plane, bounds, acc, visits, n, depth, iteration, counter, key0, key1, seed,
      fp_stride, num_clusters);
  return static_cast<int>(cudaGetLastError());
}
