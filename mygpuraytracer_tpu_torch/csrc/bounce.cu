// K5: one iteration's whole bounce loop for scenes with large untextured
// meshes, in one launch.
//
// Replaces mygpuraytracer_tpu/render/megakernel.py::_make_bounce_kernel, the
// Pallas kernel that bvh_bounce_accumulate launches once per iteration on
// the TPU. Same function: from the camera rays (raygen runs outside), for
// each pixel the bounce loop of primitive tests, the nearest face of the
// mesh's 128-face clusters (ops/trace.py::mesh_nearfar_hit), shading
// (path.cuh::shade, render/shade.py), and color * pi added into the
// accumulator; the first-hit albedo and normal are written at iteration 1.
//
// A launch covers the pixel range p0 .. p0 + count - 1 of the n-pixel image
// (the whole image: p0 = 0, count = n): rays, acc and visits hold the range's
// count columns, and the image's pixel p0 + p is the RNG counter, so ranges
// that tile the image give the whole launch's sums bit for bit.
//
// Inputs: rays [6, count] (origin xyz, direction xyz), the scene record
// (render/megakernel.py::scene_record: camera, geoms with their materials;
// its listed faces are not read), face_gather [C, 4, 128, 4] (rows 0-12 of
// face_plane, four rows to a float4, 128 faces to a block) and cluster_tree
// [C - 1, 16]
// (scene/device_scene.py::build_cluster_tree). Output: rows 0-8 of acc
// [9, count]; if given, visits [count] gains the clusters each ray tested over the
// launch's bounces, and stats [4] the launch's tree nodes visited (interior
// nodes whose two child boxes a ray tested), warp traversal iterations (one
// iteration: the lanes still walking each visit one node), warp bounce
// rounds (a warp runs bounce b while any of its paths lives) and the lanes
// of ended paths over those rounds (idle in the primitive tests, the walk
// and shade).
//
// Design: one ray, one walk, with the leaves tested by the whole warp
// (mesh.cuh::walk, which the mesh tiers' kernel shares). One thread per
// ray, no block-wide step; the bounce loop and the walk's rounds are
// uniform over the warp (it ends when all its paths have). Per bounce:
//   1. the primitives give t_cap, the nearest primitive hit;
//   2. the walk over the cluster tree gives the least (t, face id) below
//      t_cap, the plain version's winner, exact-t ties included (the rule
//      and its one rounding case are in mesh.cuh); the winner's normal and
//      geom id are read from its face after the walk;
//   3. shade, with K1's AOV rule.
// Most threads hold no leaf in a given round (rays that miss the mesh, paths
// that ended, rays that need fewer clusters): a loop in which each holder
// tested its own 128 faces kept 0.9 of the lanes idle on cornellShip, where
// serving the holders with the whole warp keeps every lane testing faces.
// Blocks of 64 threads: nothing in the walk is block-wide, and on an H100
// 64 ran ahead of 128 and 256 (PERF.md, K5).
//
// Random numbers follow RenderOptions.rng. Bounce b draws rows 4 + 3b ..
// 6 + 3b at counter pixel: from threefry under fold_in(key(seed), iteration)
// at (0, row * n + pixel), as ops/rng.py draws the wavefront's block, or
// from K6's Philox counter stream (path.cuh::counter_group) under the
// iteration's seed, whose group of 4 rows stays in registers: a path of
// depth 8 makes 6 Philox calls. Either way K5 sees exactly the numbers of
// the wavefront under the same rng.
//
// Bound on an H100: operations. Per ray-bounce, the primitive tests and
// shade of K1, three draws and the face tests of the clusters the ray
// visits (visits x 128 x ~51 FP32 instructions); the accumulator is 9
// planes of 4 B read and written once.
//
// The iteration's words (its key, K6's seed, its number) come by value or,
// in the build with WORDS, from device memory, where a one-thread kernel
// launched before it derives them from the base key and the iteration,
// which it reads there (the capture route of render/graphs.py).
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mesh.cuh"
#include "path.cuh"

namespace {

constexpr int THREADS = 64;  // block size

// One pixel's numbers in one iteration: row r at counter p.
struct Draws {
  Stream tf;      // threefry, element (r, p) of the [rows, n] block
  uint32_t word;  // K6's stream word of p's 2048-column block
  uint32_t col;   // p
  bool counter;   // K6's counter stream instead of threefry
  int group;      // the Philox group held in `words` (-1: none)
  Words4 words;
  __device__ __forceinline__ float uniform(int row) {
    if (!counter) return tf.uniform(row);
    const int g = row >> 2;
    if (g != group) {
      words = counter_group(word, static_cast<uint32_t>(g), col);
      group = g;
    }
    return word_uniform(group_word(words, static_cast<uint32_t>(row & 3)));
  }
};

// The WORDS build's words [4] = (the iteration's key word 0, word 1, K6's
// seed, the iteration), each an int64: the iteration read from device
// memory, *iteration_at, counted there by a CUDA graph (render/graphs.py),
// where values baked into the launch would be the captured iteration's;
// the rest derived from the base key (b0, b1) (path.cuh::iteration_words).
// One thread, once per launch: derived in each of K5's threads, the words
// stay live in registers through the bounce loop, which cost K5 occupancy.
__global__ void k5_iteration_words(uint32_t b0, uint32_t b1,
                                   const long long* __restrict__ iteration_at,
                                   long long* __restrict__ words) {
  const long long iteration = *iteration_at;
  uint32_t k0, k1;
  int32_t seed;
  iteration_words(b0, b1, static_cast<uint32_t>(iteration), k0, k1, seed);
  words[0] = k0;
  words[1] = k1;
  words[2] = seed;
  words[3] = iteration;
}

// WORDS: the iteration's words are read from device memory (words, written
// by k5_iteration_words), not taken by value. The by-value builds never read
// ``words``.
template <bool COUNT, bool RANGE, bool WORDS>
__global__ void __launch_bounds__(THREADS)
    k5_kernel(const float* __restrict__ rays, const float* __restrict__ rec,
              const float4* __restrict__ faces, const float4* __restrict__ tree,
              float* __restrict__ acc, int* __restrict__ visits,
              unsigned long long* __restrict__ stats, int n, int p0, int pixels, int depth,
              int iteration, int counter, uint32_t key0, uint32_t key1, int32_t seed,
              const long long* __restrict__ words) {
  if (WORDS) {
    key0 = static_cast<uint32_t>(words[0]);
    key1 = static_cast<uint32_t>(words[1]);
    seed = static_cast<int32_t>(words[2]);
    iteration = static_cast<int>(words[3]);
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;  // in the range
  const int lane = static_cast<int>(threadIdx.x) % WARP;
  // The range's length: the rows' stride. RANGE false is the whole image
  // (p0 = 0, pixels = n), compiled without the range's add and stride, which
  // cost a whole-image launch 0.4% (NVIDIA H100 80GB HBM3, 700 W;
  // chip_smoke.py --ab).
  const int len = RANGE ? pixels : n;
  const bool in_image = p < len;  // threads past the range take part in the warp's steps
  const int g = RANGE ? p0 + p : p;  // the image's pixel: the RNG counter
  const RecScene scene{rec, static_cast<int>(rec[0]), 0};  // the geoms; no listed faces
  Draws rng{{key0, key1, static_cast<uint64_t>(n), static_cast<uint64_t>(g)},
            stream_word(seed, static_cast<uint32_t>(g)), static_cast<uint32_t>(g),
            counter != 0, -1, {0u, 0u, 0u, 0u}};

  Path s{{0.0f, 0.0f, 0.0f}, {1.0f, 0.0f, 0.0f}, {1.0f, 1.0f, 1.0f}, in_image ? depth : 0};
  if (in_image) {
    s.o = {rays[p], rays[len + p], rays[2 * len + p]};
    s.d = {rays[3 * len + p], rays[4 * len + p], rays[5 * len + p]};
  }
  WalkCount count{0u, 0u, 0u, 0u};
  unsigned rounds = 0, ended = 0;
  for (int b = 0; b < depth; ++b) {
    const bool alive = s.remaining > 0;
    const unsigned live = __ballot_sync(FULL, alive);
    if (live == 0) break;  // every path of the warp has ended
    if (COUNT && lane == 0) {
      ++rounds;
      ended += WARP - __popc(live);
    }
    Hit h{CUDART_INF_F, {0.0f, 0.0f, 0.0f}, -1, false};
    if (alive) h = scene_hit(scene, s.o, s.d);

    // The mesh: the walk over the cluster tree (ops/trace.py::mesh_nearfar_hit).
    Best best = no_face(h.t);
    walk<COUNT>(tree, faces, {s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z}, alive, best, count);
    if (best.fid >= 0) {
      const float4* f = cluster_faces(faces, best.fid / CS);
      const float4 q0 = __ldg(f + best.fid % CS), q3 = __ldg(f + 3 * CS + best.fid % CS);
      h = {best.t, normalize({q0.x, q0.y, q0.z}), static_cast<int>(q3.x), true};
    }

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
      acc[3 * len + p] = alb.x;
      acc[4 * len + p] = alb.y;
      acc[5 * len + p] = alb.z;
      acc[6 * len + p] = nrm.x;
      acc[7 * len + p] = nrm.y;
      acc[8 * len + p] = nrm.z;
    }
    if (alive) {
      const float u_choice = rng.uniform(4 + 3 * b);
      const float u1 = rng.uniform(5 + 3 * b);
      const float u2 = rng.uniform(6 + 3 * b);
      shade(s, h, scene, u_choice, u1, u2);
    }
  }
  if (COUNT && stats != nullptr) {  // one atomic per counter and warp
    const unsigned warp_nodes = __reduce_add_sync(FULL, count.nodes);
    const unsigned warp_walk = __reduce_add_sync(FULL, count.walk_iters);
    if (lane == 0) {
      atomicAdd(stats, static_cast<unsigned long long>(warp_nodes));
      atomicAdd(stats + 1, static_cast<unsigned long long>(warp_walk));
      atomicAdd(stats + 2, static_cast<unsigned long long>(rounds));
      atomicAdd(stats + 3, static_cast<unsigned long long>(ended));
    }
  }
  if (!in_image) return;
  // color * pi, then accumulate (two roundings, like the plain version)
  acc[p] = acc[p] + __fmul_rn(s.c.x, PI_F);
  acc[len + p] = acc[len + p] + __fmul_rn(s.c.y, PI_F);
  acc[2 * len + p] = acc[2 * len + p] + __fmul_rn(s.c.z, PI_F);
  if (COUNT && visits != nullptr) visits[p] += static_cast<int>(count.visits);
}

}  // namespace

// iteration_at, if not null, replaces iteration, (key0, key1) is then the
// base key and seed is ignored: k5_iteration_words writes the iteration's
// words into words (int64 [4], scratch), which the WORDS build reads (it
// covers the whole image and counts nothing).
extern "C" int k5_bounce(const float* rays, const float* rec, const float* face_gather,
                         const float* tree, float* acc, int* visits, unsigned long long* stats,
                         int n, int p0, int count, int depth, int iteration, int counter,
                         uint32_t key0, uint32_t key1, int seed, const long long* iteration_at,
                         long long* words, int num_clusters, int tree_depth, void* stream) {
  if (count <= 0) return 0;
  const bool counting = visits != nullptr || stats != nullptr, range = p0 != 0 || count != n;
  if (num_clusters < 2 || tree_depth < 1 || tree_depth > MAX_STACK || p0 < 0 ||
      p0 > n - count ||
      (iteration_at != nullptr && (words == nullptr || counting || range))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (iteration_at != nullptr) {
    k5_iteration_words<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(key0, key1, iteration_at,
                                                                       words);
  }
  const int blocks = (count + THREADS - 1) / THREADS;
  auto kernel = iteration_at != nullptr ? k5_kernel<false, false, true>
                : counting ? (range ? k5_kernel<true, true, false> : k5_kernel<true, false, false>)
                           : (range ? k5_kernel<false, true, false> : k5_kernel<false, false, false>);
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, rec, reinterpret_cast<const float4*>(face_gather),
      reinterpret_cast<const float4*>(tree), acc, visits, stats, n, p0, count, depth, iteration,
      counter, key0, key1, seed, words);
  return static_cast<int>(cudaGetLastError());
}
