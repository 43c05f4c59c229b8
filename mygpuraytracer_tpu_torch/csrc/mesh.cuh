// Shared device code of the mesh kernels: the plane-form face test, the box
// slab test, and the per-ray walk over the cluster tree whose leaves the
// whole warp tests, used by the mesh tiers' kernel (mesh_hit.cu) and by K5
// (bounce.cu). The faces are the 128-face Morton clusters of face_plane
// (scene/device_scene.py) in the face_gather layout, the boxes those of
// cluster_tree (build_cluster_tree). Every operation is an _rn intrinsic
// in the plain version's order (ops/mesh_hit.py), so no FMA contraction
// changes a rounding. Include after <cuda_runtime.h>, <math_constants.h>
// and <stdint.h>.
//
// The walk (the "while-while" traversal of Aila & Laine, Understanding the
// Efficiency of Ray Traversal on GPUs, HPG 2009, with warp-tested leaves):
//   1. each thread walks the cluster tree on its own stack: at an interior
//      node it slab-tests both child boxes, goes to the nearer passing child
//      (the lower one on equal entry t) and pushes the farther with its
//      entry t; a popped entry is taken only if its entry t still passes. A
//      thread stops at its next leaf or when its stack is empty;
//   2. the warp then tests the clusters its threads hold, one holder at a
//      time: the holder's ray and best t are broadcast, each lane
//      tests 4 of the 128 faces (lane l faces l, l + 32, ...: each float4
//      load of the warp reads 512 contiguous bytes), and two warp minima, of
//      t and then of the face index at that t, give the holder its new
//      winner. Then the holders pop and the warp repeats.
// Rounds are uniform over the warp: threads past the launch's rays and
// threads with nothing to walk take part in every warp-wide call.
//
// Winner and pruning rule. A face wins if its t is below the best, or
// equal to it with a lower face id, so the result is the least (t, face id)
// over the faces tested, whatever the visiting order: the plain version's
// ascending walk with its strict '<' gives the same. A box passes while its
// entry t is below t_cap and no face has won, and at or below the best t
// once one has (Best.lim), so a cluster holding a face at exactly the best
// t is still tested. A node's box is the exact min/max union of its
// clusters' boxes and every slab operation rounds monotonically, so a node
// passes whenever a cluster below it would: the walk tests every cluster
// whose box passes with an entry t at or below its final t. The one case
// in which it can differ from the plain walk: a face whose t rounds below
// its own cluster's box entry, tested by one walk and pruned by the other.

#pragma once

namespace {

constexpr int CS = 128;  // faces per cluster
constexpr int Q = 13;    // plane quantities a face test reads (rows 0-12)
constexpr float FACE_HIT_EPS = 1e-4f;
constexpr float DIR_EPS = 1e-20f;
constexpr int MAX_STACK = 32;           // tree depth the walk takes (C <= 2^32)
constexpr int EMPTY = -2147483647 - 1;  // no node: the walk is over
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FACES_PER_LANE = CS / WARP;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float dot_rn(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__device__ __forceinline__ float clamp_eps(float x) { return fabsf(x) < DIR_EPS ? DIR_EPS : x; }

// Slab test of the box [x0, x1] x [y0, y1] x [z0, z1] (trace.py:746-783):
// true if the ray meets it at some t >= 0; *tin is where it enters.
// inv = 1 / clamp_eps(d) per axis.
__device__ __forceinline__ bool box_slab(const Ray& r, float ix, float iy, float iz, float x0,
                                         float y0, float z0, float x1, float y1, float z1,
                                         float* tin_out) {
  const float t1 = __fmul_rn(__fsub_rn(x0, r.ox), ix);
  const float t2 = __fmul_rn(__fsub_rn(x1, r.ox), ix);
  const float u1 = __fmul_rn(__fsub_rn(y0, r.oy), iy);
  const float u2 = __fmul_rn(__fsub_rn(y1, r.oy), iy);
  const float v1 = __fmul_rn(__fsub_rn(z0, r.oz), iz);
  const float v2 = __fmul_rn(__fsub_rn(z1, r.oz), iz);
  const float tin = fmaxf(fmaxf(fminf(t1, t2), fminf(u1, u2)), fminf(v1, v2));
  const float tout = fminf(fminf(fmaxf(t1, t2), fmaxf(u1, u2)), fmaxf(v1, v2));
  *tin_out = tin;
  return tout >= fmaxf(tin, 0.0f);
}

// Plane-form face test (trace.py:808-836) of the 13 quantities q: true if
// the face is hit at t > FACE_HIT_EPS with 0 <= u, 0 <= v, u + v <= 1.
__device__ __forceinline__ bool face_test(const Ray& r, const float* q, float* t_out,
                                          float* u_out, float* v_out) {
  const float A = dot_rn(r.ox, r.oy, r.oz, q[0], q[1], q[2]);
  const float B = clamp_eps(dot_rn(r.dx, r.dy, r.dz, q[0], q[1], q[2]));
  const float t = __fdiv_rn(__fsub_rn(q[3], A), B);
  const float du = dot_rn(r.dx, r.dy, r.dz, q[4], q[5], q[6]);
  const float ou = dot_rn(r.ox, r.oy, r.oz, q[4], q[5], q[6]);
  const float u = __fsub_rn(__fadd_rn(ou, __fmul_rn(t, du)), q[7]);
  const float dv = dot_rn(r.dx, r.dy, r.dz, q[8], q[9], q[10]);
  const float ov = dot_rn(r.ox, r.oy, r.oz, q[8], q[9], q[10]);
  const float v = __fsub_rn(__fadd_rn(ov, __fmul_rn(t, dv)), q[11]);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > FACE_HIT_EPS;
}

// Cluster c's block of face_gather [C, 4, 128] float4.
__device__ __forceinline__ const float4* cluster_faces(const float4* faces, int c) {
  return faces + static_cast<int64_t>(c) * (CS * 4);
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

// A ray's running nearest face.
struct Best {
  float t;    // the winner's t; t_cap until a face wins
  float lim;  // a box passes if its entry t is below lim: t_cap, then the float above t
  int fid;    // the winner's face id; -1: none
};

__device__ __forceinline__ Best no_face(float t_cap) { return {t_cap, t_cap, -1}; }

// Counts of the counting builds, per thread: clusters tested, interior
// nodes visited, warp traversal iterations (the lanes still walking each
// visit one node), warp leaf rounds (the warp tests its holders' clusters).
// The last two are counted on one lane of the warp.
struct WalkCount {
  unsigned visits, nodes, walk_iters, leaf_rounds;
};

// The top stack entry whose entry t is below lim, or EMPTY; the entries
// above it are dropped.
__device__ __forceinline__ int pop(const int* stack_node, const float* stack_t, int& sp,
                                   float lim) {
  while (sp > 0) {
    --sp;
    if (stack_t[sp] < lim) return stack_node[sp];
  }
  return EMPTY;
}

// The whole warp tests the cluster that lane `holder` holds (`node` is each
// lane's own) against that lane's ray and best; the holder takes the least
// (t, face id) of the cluster if it beats its best: a lower t, or the same
// t and a lower face id (any other face of the cluster at that t has a
// higher id). Called by all 32 lanes together.
__device__ __forceinline__ void warp_leaf_test(const float4* faces, int holder, int node,
                                               const Ray& r, Best& b) {
  const int lane = static_cast<int>(threadIdx.x) % WARP;
  const Ray rh{__shfl_sync(FULL, r.ox, holder), __shfl_sync(FULL, r.oy, holder),
               __shfl_sync(FULL, r.oz, holder), __shfl_sync(FULL, r.dx, holder),
               __shfl_sync(FULL, r.dy, holder), __shfl_sync(FULL, r.dz, holder)};
  const float best = __shfl_sync(FULL, b.t, holder);
  const int c = -1 - __shfl_sync(FULL, node, holder);
  const float4* f = cluster_faces(faces, c);
  float tw = CUDART_INF_F;
  int jw = CS;  // the lane's first face of least t at or below the best (CS: none)
  for (int k = 0; k < FACES_PER_LANE; ++k) {
    const int j = k * WARP + lane;
    float q[Q], t, u, v;
    load_face(f, j, q);
    if (face_test(rh, q, &t, &u, &v) && t <= best && t < tw) {
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
  // jmin == CS: no face at or below the holder's best. At its best t only a
  // lower face id wins (none does while fid is -1: t_cap itself never wins).
  if (jmin == CS || lane != holder) return;
  const float t = __uint_as_float(t_bits);
  if (t == b.t && c * CS + jmin >= b.fid) return;
  // t is finite and positive: the next float up is its bits plus one.
  b = {t, __uint_as_float(t_bits + 1u), c * CS + jmin};
}

// The walk of ray r from the root of the tree (nodes [C - 1, 4] float4,
// C >= 2), updating best; a thread that is not alive walks nothing but
// takes part in the warp's rounds. Called by all 32 lanes together.
template <bool COUNT>
__device__ __forceinline__ void walk(const float4* __restrict__ tree,
                                     const float4* __restrict__ faces, const Ray& r, bool alive,
                                     Best& best, WalkCount& count) {
  const int lane = static_cast<int>(threadIdx.x) % WARP;
  const float ix = __fdiv_rn(1.0f, clamp_eps(r.dx));
  const float iy = __fdiv_rn(1.0f, clamp_eps(r.dy));
  const float iz = __fdiv_rn(1.0f, clamp_eps(r.dz));
  int stack_node[MAX_STACK];
  float stack_t[MAX_STACK];
  int node = alive ? 0 : EMPTY, sp = 0;  // the root
  for (;;) {
    while (node >= 0) {  // an interior node: its children's boxes
      if (COUNT) {
        ++count.nodes;
        const unsigned lanes = __activemask();
        if (lane == __ffs(lanes) - 1) ++count.walk_iters;
      }
      const float4* nd = tree + 4 * node;
      const float4 a = __ldg(nd), bb = __ldg(nd + 1), c = __ldg(nd + 2), l = __ldg(nd + 3);
      float tl, tr;
      const bool hl = box_slab(r, ix, iy, iz, a.x, a.y, a.z, a.w, bb.x, bb.y, &tl) && tl < best.lim;
      const bool hr = box_slab(r, ix, iy, iz, bb.z, bb.w, c.x, c.y, c.z, c.w, &tr) && tr < best.lim;
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
        node = pop(stack_node, stack_t, sp, best.lim);
      }
    }
    // Every thread now holds a leaf, cluster -1 - node, or has no node left.
    const unsigned holders = __ballot_sync(FULL, node != EMPTY);
    if (holders == 0) return;
    if (COUNT && lane == 0) ++count.leaf_rounds;
    for (unsigned rest = holders; rest != 0; rest &= rest - 1) {
      warp_leaf_test(faces, __ffs(rest) - 1, node, r, best);
    }
    if (node != EMPTY) {
      if (COUNT) ++count.visits;
      node = pop(stack_node, stack_t, sp, best.lim);
    }
  }
}

}  // namespace
