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
// Inputs: rays [6, n] (origin xyz, direction xyz), the scene record
// (render/megakernel.py::scene_record: camera, geoms with their materials;
// its listed faces are not read), face_gather [C, 4, 128, 4] (rows 0-12 of
// face_plane, four rows to a float4, 128 faces to a block) and cluster_tree
// [C - 1, 16]
// (scene/device_scene.py::build_cluster_tree). Output: rows 0-8 of acc
// [9, n]; if given, visits [n] gains the clusters each ray tested over the
// launch's bounces, and stats [4] the launch's tree nodes visited (interior
// nodes whose two child boxes a ray tested), warp traversal iterations (one
// iteration: the lanes still walking each visit one node), warp bounce
// rounds (a warp runs bounce b while any of its paths lives) and the lanes
// of ended paths over those rounds (idle in the primitive tests, the walk
// and shade).
//
// Design: one ray, one walk (the "while-while" traversal of Aila & Laine,
// Understanding the Efficiency of Ray Traversal on GPUs, HPG 2009), with
// the leaves tested by the whole warp. One thread per ray, no block-wide
// step; the bounce loop and the walk's rounds are uniform over the warp
// (it ends when all its paths have). Per bounce:
//   1. the primitives give t_cap, the nearest primitive hit;
//   2. each thread walks the cluster tree on its own stack: at an interior
//      node it slab-tests both child boxes against its running best, goes
//      to the nearer passing child (the lower one on equal entry t) and
//      pushes the farther with its entry t; a popped entry is taken only if
//      its entry t is still below the best. A thread stops at its next leaf
//      or when its stack is empty; a leaf's box in its parent is the
//      cluster's box bit for bit, so reaching it is mesh.cuh::cluster_needed
//      against the ray's running best;
//   3. the warp then tests the clusters its threads hold, one holder at a
//      time: the holder's ray, best and cluster are broadcast, each lane
//      tests 4 of the 128 faces (lane l faces l, l + 32, ...: each float4
//      load of the warp reads 512 contiguous bytes), and two warp minima, of t and then of the face index
//      at that t, give the holder the first face of least t below its best,
//      which is what the in-order loop with a strict '<' gives
//      (mesh.cuh::face_test is the same arithmetic). Then the holders pop
//      and the warp repeats;
//   4. shade, with K1's AOV rule.
// Most threads hold no leaf in a given round (rays that miss the mesh, paths
// that ended, rays that need fewer clusters): a loop in which each holder
// tested its own 128 faces kept 0.9 of the lanes idle on cornellShip, where
// serving the holders with the whole warp keeps every lane testing faces.
// Blocks of 64 threads: nothing in the walk is block-wide, and on an H100
// 64 ran ahead of 128 and 256 (PERF.md, K5). A node's box is the exact
// min/max union of its clusters' boxes and every slab operation rounds
// monotonically, so a node passes whenever a cluster below it would pass
// with the same best: the walk tests every cluster the ascending walk of
// the plain version relies on for the nearest t. Which face wins among
// faces at exactly equal t in different clusters may differ (visiting
// order).
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
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mesh.cuh"
#include "path.cuh"

namespace {

constexpr int THREADS = 64;       // block size
constexpr int MAX_STACK = 32;     // tree depth the walk takes (C <= 2^32)
constexpr int EMPTY = -2147483647 - 1;  // no node: the walk is over
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FACES_PER_LANE = CS / WARP;

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

// A ray's running nearest face.
struct Best {
  float t, nx, ny, nz, gid;  // gid -1: none
};

// The top stack entry whose entry t is below the best, or EMPTY; the
// entries above it are dropped.
__device__ __forceinline__ int pop(const int* stack_node, const float* stack_t, int& sp,
                                   float best) {
  while (sp > 0) {
    --sp;
    if (stack_t[sp] < best) return stack_node[sp];
  }
  return EMPTY;
}

// Face j's 13 plane quantities from its cluster's block f of face_gather:
// quantities 4k .. 4k + 3 of the cluster's 128 faces lie at f[k * CS + j],
// so a warp that reads 32 consecutive faces' float4 reads 512 contiguous
// bytes. The last float4 holds quantity 12 and 3 floats of padding.
__device__ __forceinline__ void load_face(const float4* f, int j, float* q) {
  const float4 q0 = __ldg(f + j), q1 = __ldg(f + CS + j), q2 = __ldg(f + 2 * CS + j),
               q3 = __ldg(f + 3 * CS + j);
  const float all[Q] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z,
                        q1.w, q2.x, q2.y, q2.z, q2.w, q3.x};
  for (int i = 0; i < Q; ++i) q[i] = all[i];
}

// The whole warp tests the cluster that lane `holder` holds (`node` is each
// lane's own) against that lane's ray and best; the holder takes the first
// face of least t below its best. Called by all 32 lanes together.
__device__ __forceinline__ void warp_leaf_test(const float4* faces, int holder, int node,
                                               const Ray& r, Best& b) {
  const int lane = static_cast<int>(threadIdx.x) % WARP;
  const Ray rh{__shfl_sync(FULL, r.ox, holder), __shfl_sync(FULL, r.oy, holder),
               __shfl_sync(FULL, r.oz, holder), __shfl_sync(FULL, r.dx, holder),
               __shfl_sync(FULL, r.dy, holder), __shfl_sync(FULL, r.dz, holder)};
  const float best = __shfl_sync(FULL, b.t, holder);
  const int c = -1 - __shfl_sync(FULL, node, holder);
  const float4* f = faces + static_cast<int64_t>(c) * (CS * 4);
  float tw = CUDART_INF_F;
  int jw = CS;  // the lane's first face of least t (CS: none)
  for (int k = 0; k < FACES_PER_LANE; ++k) {
    const int j = k * WARP + lane;
    float q[Q], t, u, v;
    load_face(f, j, q);
    if (face_test(rh, q, 1, best, &t, &u, &v) && t < tw) {
      tw = t;
      jw = j;
    }
  }
  // The least t over the warp, then the least face index at it. An accepted
  // t is positive, and the bits of positive floats (+inf included) order as
  // unsigned integers do.
  const unsigned t_bits = __reduce_min_sync(FULL, __float_as_uint(tw));
  const int jmin = static_cast<int>(
      __reduce_min_sync(FULL, __float_as_uint(tw) == t_bits ? static_cast<unsigned>(jw) : CS));
  if (jmin == CS || lane != holder) return;  // jmin == CS: no face beats the holder's best
  const float4 q0 = __ldg(f + jmin), q3 = __ldg(f + 3 * CS + jmin);
  b = {__uint_as_float(t_bits), q0.x, q0.y, q0.z, q3.x};
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
    k5_kernel(const float* __restrict__ rays, const float* __restrict__ rec,
              const float4* __restrict__ faces, const float4* __restrict__ tree,
              float* __restrict__ acc, int* __restrict__ visits,
              unsigned long long* __restrict__ stats, int n, int depth, int iteration,
              int counter, uint32_t key0, uint32_t key1, int32_t seed) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % WARP;
  const bool in_image = p < n;  // threads past n take part in the warp's steps
  const int num_geoms = static_cast<int>(rec[0]);
  Draws rng{{key0, key1, static_cast<uint64_t>(n), static_cast<uint64_t>(p)},
            stream_word(seed, static_cast<uint32_t>(p)), static_cast<uint32_t>(p),
            counter != 0, -1, {0u, 0u, 0u, 0u}};

  Path s{{0.0f, 0.0f, 0.0f}, {1.0f, 0.0f, 0.0f}, {1.0f, 1.0f, 1.0f}, in_image ? depth : 0};
  if (in_image) {
    s.o = {rays[p], rays[n + p], rays[2 * n + p]};
    s.d = {rays[3 * n + p], rays[4 * n + p], rays[5 * n + p]};
  }
  int n_visits = 0;
  unsigned n_nodes = 0, walk_iters = 0, rounds = 0, ended = 0;
  int stack_node[MAX_STACK];
  float stack_t[MAX_STACK];
  for (int b = 0; b < depth; ++b) {
    const bool alive = s.remaining > 0;
    const unsigned live = __ballot_sync(FULL, alive);
    if (live == 0) break;  // every path of the warp has ended
    if (COUNT && lane == 0) {
      ++rounds;
      ended += WARP - __popc(live);
    }
    Hit h{CUDART_INF_F, {0.0f, 0.0f, 0.0f}, -1, false};
    if (alive) h = scene_hit(rec, num_geoms, 0, s.o, s.d);

    // The mesh: the walk over the cluster tree (ops/trace.py::mesh_nearfar_hit).
    const Ray r{s.o.x, s.o.y, s.o.z, s.d.x, s.d.y, s.d.z};
    const float ix = __fdiv_rn(1.0f, clamp_eps(r.dx));
    const float iy = __fdiv_rn(1.0f, clamp_eps(r.dy));
    const float iz = __fdiv_rn(1.0f, clamp_eps(r.dz));
    Best best{h.t, 0.0f, 0.0f, 0.0f, -1.0f};
    int node = alive ? 0 : EMPTY, sp = 0;  // the root
    for (;;) {
      while (node >= 0) {  // an interior node: its children's boxes
        if (COUNT) {
          ++n_nodes;
          const unsigned lanes = __activemask();
          if (lane == __ffs(lanes) - 1) ++walk_iters;
        }
        const float4* nd = tree + 4 * node;
        const float4 a = __ldg(nd), bb = __ldg(nd + 1), c = __ldg(nd + 2), l = __ldg(nd + 3);
        float tl, tr;
        const bool hl = box_slab(r, ix, iy, iz, a.x, a.y, a.z, a.w, bb.x, bb.y, &tl) && tl < best.t;
        const bool hr = box_slab(r, ix, iy, iz, bb.z, bb.w, c.x, c.y, c.z, c.w, &tr) && tr < best.t;
        const int left = __float_as_int(l.x), right = __float_as_int(l.y);
        if (hl && hr) {
          const bool right_first = tr < tl;
          stack_node[sp] = right_first ? left : right;
          stack_t[sp] = right_first ? tl : tr;
          ++sp;
          node = right_first ? right : left;
        } else if (hl || hr) {
          node = hl ? left : right;
        } else {
          node = pop(stack_node, stack_t, sp, best.t);
        }
      }
      // Every thread now holds a leaf, cluster -1 - node, or has no node left.
      const unsigned holders = __ballot_sync(FULL, node != EMPTY);
      if (holders == 0) break;
      for (unsigned rest = holders; rest != 0; rest &= rest - 1) {
        warp_leaf_test(faces, __ffs(rest) - 1, node, r, best);
      }
      if (COUNT) n_visits += node != EMPTY;
      if (node != EMPTY) node = pop(stack_node, stack_t, sp, best.t);
    }
    if (best.gid >= 0.0f) {
      h = {best.t, normalize({best.nx, best.ny, best.nz}), static_cast<int>(best.gid), true};
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
      acc[3 * n + p] = alb.x;
      acc[4 * n + p] = alb.y;
      acc[5 * n + p] = alb.z;
      acc[6 * n + p] = nrm.x;
      acc[7 * n + p] = nrm.y;
      acc[8 * n + p] = nrm.z;
    }
    if (alive) {
      const float u_choice = rng.uniform(4 + 3 * b);
      const float u1 = rng.uniform(5 + 3 * b);
      const float u2 = rng.uniform(6 + 3 * b);
      shade(s, h, rec, u_choice, u1, u2);
    }
  }
  if (COUNT && stats != nullptr) {  // one atomic per counter and warp
    const unsigned warp_nodes = __reduce_add_sync(FULL, n_nodes);
    const unsigned warp_walk = __reduce_add_sync(FULL, walk_iters);
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
  acc[n + p] = acc[n + p] + __fmul_rn(s.c.y, PI_F);
  acc[2 * n + p] = acc[2 * n + p] + __fmul_rn(s.c.z, PI_F);
  if (COUNT && visits != nullptr) visits[p] += n_visits;
}

}  // namespace

extern "C" int k5_bounce(const float* rays, const float* rec, const float* face_gather,
                         const float* tree, float* acc, int* visits, unsigned long long* stats,
                         int n, int depth, int iteration, int counter, uint32_t key0,
                         uint32_t key1, int seed, int num_clusters, int tree_depth,
                         void* stream) {
  if (n <= 0) return 0;
  if (num_clusters < 2 || tree_depth < 1 || tree_depth > MAX_STACK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  auto kernel = (visits != nullptr || stats != nullptr) ? k5_kernel<true> : k5_kernel<false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, rec, reinterpret_cast<const float4*>(face_gather),
      reinterpret_cast<const float4*>(tree), acc, visits, stats, n, depth, iteration, counter,
      key0, key1, seed);
  return static_cast<int>(cudaGetLastError());
}
