// K1: whole Monte-Carlo iterations of the path tracer in one launch.
//
// Replaces mygpuraytracer_tpu/render/megakernel.py::_make_kernel, the Pallas
// kernel that megakernel_accumulate launches on the TPU. Same function: for
// each pixel, num_iters iterations of AA jitter, thin-lens DoF, the bounce
// loop over cubes, spheres and up to 256 listed triangles, shading
// (render/shade.py), and color * pi added into the accumulator; the albedo
// and normal AOVs are written at the first hit of iteration 1.
//
// Design: persistent lanes that fetch pixels and start a new path as soon
// as one ends.
//   - The grid is as many blocks as the SMs hold at once (the occupancy
//     query), at most one pixel per thread. A lane takes a pixel from the
//     queue (a device counter the wrapper passes in, zeroed on the launch's
//     stream), runs its num_iters iterations in order, stores its three
//     color sums and takes the next pixel. The warp fetches together: a
//     ballot of the lanes that need a pixel, one atomicAdd by the first of
//     them, a shuffle of the base. Each pixel's sums are read and written
//     once per launch, and their values do not depend on which lane held it.
//   - One flat loop. In a round, (a) a lane whose path has ended adds its
//     color * pi (two roundings, as the plain version) and moves to its next
//     iteration, or stores the pixel and fetches another, then runs raygen;
//     (b) every lane holding a pixel tests the scene and (c) shades. So a
//     lane whose path ends at bounce 1 starts its next path in the next
//     round instead of waiting for the longest path of its warp: in the
//     plain nesting (bounce loop inside the iteration loop) 43% of the lanes
//     of Cornell's bounce rounds carried ended paths. The geom and face
//     loops run the same count on every lane; raygen (now in most rounds,
//     on the lanes that start a path) and the accumulate diverge. The warp
//     leaves the loop when none of its lanes holds a pixel, so every lane
//     reaches every ballot and shuffle.
//   - The record (render/megakernel.py::scene_record) is copied once per
//     block into shared memory, repacked into float4 rows (shared_slot): a
//     geom's three matrices are 9 LDS.128, its material 3, a face 3 (its
//     normal one more for the winner), the camera 4. Reads at one address
//     across the warp (camera, geoms, faces) are broadcasts; the material
//     reads of shade, indexed by each lane's hit, are served by the banks
//     without the constant cache's serialisation of divergent addresses.
//     Shared memory also races with no other launch, as a __constant__ copy
//     filled per launch would between streams.
//
// Random numbers are threefry2x32 (20 rounds) at the wavefront's counters:
// draw row r of pixel p in iteration i is threefry(fold_in(key(seed), i),
// (0, r*N + p)), read as JAX's uniform, so the kernel sees exactly the
// numbers of the plain version (render/pathtrace.py) and its image equals
// that one up to float rounding. K1 draws threefry whatever
// RenderOptions.rng says, as the TPU's K1 drew its hardware PRNG whatever it
// said; K5 (bounce.cu) is the kernel that follows rng.
//
// A launch covers the pixel range p0 .. p0 + count - 1 of the n-pixel image
// (the whole image: p0 = 0, count = n). The queue hands out 0 .. count - 1:
// the local pixel p indexes the accumulator [9, count], and the image's pixel
// p0 + p drives raygen and the RNG counters, so launches over ranges that
// tile the image give the whole launch's sums bit for bit (the pixel-sharded
// render, parallel/sharded.py).
//
// Bound on an H100: FP32 and integer instructions per ray-bounce and per
// sample (up to 4 + 3*depth threefry draws a sample, one slab or quadric
// test per geom and one Moller-Trumbore test per listed face a bounce);
// memory is 9 planes x 4 B x N read and written once per launch. The
// counting build (stats) gives warp rounds, live and raygen lane-rounds,
// the warp rounds that run raygen, pixel fetches, fetch atomics and the
// rounds after the queue ran dry.
//
// The record layout, threefry, the primitive tests and shade() live in
// path.cuh, which K5 shares. Built by mygpuraytracer_tpu_torch/_build.py
// (nvcc, sm_90a); the C entry point returns the first CUDA error of the
// occupancy query, the queue's reset or the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "path.cuh"

namespace {

constexpr int THREADS = 256;      // block size (the fastest of the sweep on an H100, PERF.md)
constexpr int MAX_THREADS = 256;  // the launch takes 32 .. 256
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

// Counters of the counting build, one 64-bit atomic per counter and warp.
enum Stat { ROUNDS, LIVE, RAYGENS, RAYGEN_ROUNDS, FETCHES, ATOMICS, TAIL, NUM_STATS };

// Shared layout in floats: the camera (4 rows: pos|pl_x, view|pl_y, up,
// right), then per geom 13 rows (inverse 0-2, transform 3-5, inverse
// transpose 6-8 padded to 4 columns, material 9-11: color3 spec3 spec_ex
// refl refr ior emit, then type and material id in row 12), then per face 4
// rows (v0|geom, e1, e2, normal).
constexpr int SH_HEADER = 16, SH_GEOM = 52, SH_FACE = 16;

int shared_floats(int num_geoms, int num_faces) {
  return SH_HEADER + SH_GEOM * num_geoms + SH_FACE * num_faces;
}

// Where float k of the record lands in shared memory (-1: not copied).
__device__ __forceinline__ int shared_slot(int k, int num_geoms) {
  if (k < HEADER) {  // G, F, pos3 view3 up3 right3, pixel_length2
    if (k < 2) return -1;
    if (k >= 14) return k == 14 ? 3 : 7;
    return 4 * ((k - 2) / 3) + (k - 2) % 3;
  }
  k -= HEADER;
  if (k < GEOM_STRIDE * num_geoms) {
    const int f = k % GEOM_STRIDE;
    int at;
    if (f < G_XFORM) {
      at = 48 + f;  // type, material id
    } else if (f < G_INV) {
      at = 12 + (f - G_XFORM);
    } else if (f < G_INVT) {
      at = f - G_INV;
    } else if (f < G_MAT) {
      at = 24 + 4 * ((f - G_INVT) / 3) + (f - G_INVT) % 3;
    } else if (f < G_MAT + 11) {
      at = 36 + (f - G_MAT);
    } else {
      return -1;
    }
    return SH_HEADER + SH_GEOM * (k / GEOM_STRIDE) + at;
  }
  k -= GEOM_STRIDE * num_geoms;
  const int f = k % FACE_STRIDE;  // geom, v0 3, e1 3, e2 3, normal 3, pad 3
  if (f >= 13) return -1;
  const int at = f == 0 ? 3 : (f - 1) + (f - 1) / 3;
  return SH_HEADER + SH_GEOM * num_geoms + SH_FACE * (k / FACE_STRIDE) + at;
}

struct SharedGeom {
  const float4* g;
  __device__ __forceinline__ int type() const {
    return static_cast<int>(reinterpret_cast<const float*>(g)[48]);
  }
  __device__ __forceinline__ Rows4 inv() const { return {{g[0], g[1], g[2]}}; }
  __device__ __forceinline__ Rows4 xform() const { return {{g[3], g[4], g[5]}}; }
  __device__ __forceinline__ Rows4 invt() const { return {{g[6], g[7], g[8]}}; }
};

// The scene as path.cuh's scene_hit and shade read it, from shared memory.
struct SharedScene {
  const float4* s;
  int num_geoms, num_faces;
  __device__ __forceinline__ SharedGeom geom(int gi) const {
    return {s + (SH_HEADER + SH_GEOM * gi) / 4};
  }
  __device__ __forceinline__ Material material(int gi) const {
    const float4* m = s + (SH_HEADER + SH_GEOM * gi) / 4 + 9;
    const float4 a = m[0], b = m[1], c = m[2];
    return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, b.z, b.w, c.x, c.y, c.z};
  }
  __device__ __forceinline__ const float4* face_at(int fi) const {
    return s + (SH_HEADER + SH_GEOM * num_geoms + SH_FACE * fi) / 4;
  }
  __device__ __forceinline__ Face face(int fi) const {
    const float4* f = face_at(fi);
    const float4 a = f[0], b = f[1], c = f[2];
    return {{a.x, a.y, a.z}, {b.x, b.y, b.z}, {c.x, c.y, c.z}};
  }
  __device__ __forceinline__ V3 face_normal(int fi) const {
    const float4 n = face_at(fi)[3];
    return {n.x, n.y, n.z};
  }
  __device__ __forceinline__ int face_geom(int fi) const {
    return static_cast<int>(face_at(fi)[0].w);
  }
};

template <bool COUNT, bool RANGE>
__global__ void __launch_bounds__(MAX_THREADS)
    k1_kernel(const float* __restrict__ rec, float* __restrict__ acc, int* __restrict__ queue,
              unsigned long long* __restrict__ stats, int num_geoms, int num_faces, int n,
              int p0, int count, int width, int height, int depth, int start_iter, int num_iters,
              uint32_t key0,
              uint32_t key1, int aa, int dof, float lens_radius, float focal_distance) {
  extern __shared__ float4 shared_rec[];
  float* const sh = reinterpret_cast<float*>(shared_rec);
  const int rec_len = HEADER + GEOM_STRIDE * num_geoms + FACE_STRIDE * num_faces;
  for (int k = threadIdx.x; k < rec_len; k += blockDim.x) {
    const int at = shared_slot(k, num_geoms);
    if (at >= 0) sh[at] = rec[k];
  }
  __syncthreads();
  const SharedScene scene{shared_rec, num_geoms, num_faces};
  const unsigned lane = threadIdx.x % WARP;
  // The range's length: the queue's end and the accumulator's row stride.
  // RANGE false is the whole image (p0 = 0, count = n), compiled without the
  // range's add and stride, which cost a whole-image launch 0.5% back to back
  // (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --ab).
  const int len = RANGE ? count : n;

  int p = -1;         // the pixel this lane holds, in the range (-1: none)
  int i = 0;          // its iteration, start_iter + i
  bool dry = false;   // this lane found the queue empty
  uint32_t ik0 = 0u, ik1 = 0u;  // fold_in(key, start_iter + i)
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  Path s{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f}, {0.0f, 0.0f, 0.0f}, 0};
  unsigned long long stat[NUM_STATS] = {};  // COUNT: the warp's counters, on every lane
  bool warp_dry = false;                     // COUNT: a lane of the warp found the queue empty

  for (;;) {
    // (a) A lane whose path has ended adds its color and moves on.
    const bool ended = s.remaining <= 0;
    if (ended && p >= 0) {  // color * pi, then accumulate (two roundings, like the plain version)
      acc_r = acc_r + __fmul_rn(s.c.x, PI_F);
      acc_g = acc_g + __fmul_rn(s.c.y, PI_F);
      acc_b = acc_b + __fmul_rn(s.c.z, PI_F);
      if (++i == num_iters) {
        acc[p] = acc_r;
        acc[len + p] = acc_g;
        acc[2 * len + p] = acc_b;
        p = -1;
      }
    }
    const bool want = p < 0 && !dry;
    const unsigned wanting = __ballot_sync(FULL, want);
    if (wanting != 0) {  // the warp's fetches: one atomic, by the first lane that wants
      const int leader = __ffs(wanting) - 1;
      const int asked = __popc(wanting);
      int base = 0;
      if (static_cast<int>(lane) == leader) base = atomicAdd(queue, asked);
      base = __shfl_sync(FULL, base, leader);
      if (want) {
        const int q = base + __popc(wanting & ((1u << lane) - 1u));
        if (q < len) {
          p = q;
          i = 0;
          acc_r = acc[p];
          acc_g = acc[len + p];
          acc_b = acc[2 * len + p];
        } else {
          dry = true;
        }
      }
      if (COUNT) {
        stat[ATOMICS] += 1;
        const int got = len - base < asked ? len - base : asked;
        stat[FETCHES] += got > 0 ? got : 0;
        warp_dry = warp_dry || base + asked > len;
      }
    }
    const unsigned holding = __ballot_sync(FULL, p >= 0);
    if (holding == 0) break;  // every lane of the warp found the queue empty
    const bool starts = ended && p >= 0;
    if (COUNT) {
      stat[ROUNDS] += 1;
      stat[LIVE] += __popc(holding);
      const unsigned starting = __ballot_sync(FULL, starts);
      stat[RAYGENS] += __popc(starting);
      stat[RAYGEN_ROUNDS] += starting != 0 ? 1 : 0;
      stat[TAIL] += warp_dry ? 1 : 0;
    }
    if (p < 0) continue;
    const int g = RANGE ? p0 + p : p;  // the image's pixel: raygen and the RNG counters
    const int iteration = start_iter + i;
    if (starts) {  // raygen (render/camera.py)
      ik0 = 0u;
      ik1 = static_cast<uint32_t>(iteration);  // fold_in(key, iteration)
      threefry2x32(key0, key1, ik0, ik1);
      const Stream r{ik0, ik1, static_cast<uint64_t>(n), static_cast<uint64_t>(g)};
      const float4 c0 = shared_rec[0], c1 = shared_rec[1], c2 = shared_rec[2],
                   c3 = shared_rec[3];
      const V3 cam_pos = {c0.x, c0.y, c0.z}, view = {c1.x, c1.y, c1.z}, up = {c2.x, c2.y, c2.z},
               right = {c3.x, c3.y, c3.z};
      float x = static_cast<float>(g % width);
      float y = static_cast<float>(g / width);
      if (aa) {
        x = x + (r.uniform(0) - 0.5f);
        y = y + (r.uniform(1) - 0.5f);
      }
      const float sx = c0.w * (x - static_cast<float>(width) * 0.5f);
      const float sy = c1.w * (y - static_cast<float>(height) * 0.5f);
      V3 d = normalize({view.x - right.x * sx - up.x * sy, view.y - right.y * sx - up.y * sy,
                        view.z - right.z * sx - up.z * sy});
      V3 o = cam_pos;
      if (dof) {  // thin lens, concentric disk (pathtrace.cu:225-293)
        const float ox = 2.0f * r.uniform(2) - 1.0f;
        const float oy = 2.0f * r.uniform(3) - 1.0f;
        float lx = 0.0f, ly = 0.0f;
        if (!(ox == 0.0f && oy == 0.0f)) {
          const bool use_x = fabsf(ox) > fabsf(oy);
          const float rad = use_x ? ox : oy;
          const float theta = use_x ? 0.785398f * (oy / ox) : 1.570796f - 0.785398f * (ox / oy);
          lx = rad * cosf(theta);
          ly = rad * sinf(theta);
        }
        lx = lens_radius * lx;
        ly = lens_radius * ly;
        const float ft = fabsf(focal_distance / d.z);
        const V3 focus = {o.x + d.x * ft, o.y + d.y * ft, o.z + d.z * ft};
        o = {o.x + lx, o.y + ly, o.z};
        d = normalize(sub(focus, o));
      }
      s = {o, d, {1.0f, 1.0f, 1.0f}, depth};
    }
    // (b) the nearest hit, (c) one shading round.
    const int b = depth - s.remaining;
    const Hit h = scene_hit(scene, s.o, s.d);
    if (b == 0 && iteration == 1) {  // first-hit AOVs (render/shade.py albedo_soa)
      V3 alb = {0.0f, 0.0f, 0.0f}, nrm = {0.0f, 0.0f, 0.0f};
      if (h.geom >= 0) {
        const Material m = scene.material(h.geom);
        alb = (!h.is_obj && m.emit > 0.0f)   ? mul(m.color, m.emit)
              : (!h.is_obj && m.refr > 0.0f) ? m.spec
                                             : m.color;
        nrm = h.n;
      }
      acc[3 * len + p] = alb.x;
      acc[4 * len + p] = alb.y;
      acc[5 * len + p] = alb.z;
      acc[6 * len + p] = nrm.x;
      acc[7 * len + p] = nrm.y;
      acc[8 * len + p] = nrm.z;
    }
    const Stream draws{ik0, ik1, static_cast<uint64_t>(n), static_cast<uint64_t>(g)};
    shade(s, h, scene, draws.uniform(4 + 3 * b), draws.uniform(5 + 3 * b),
          draws.uniform(6 + 3 * b));
  }
  if (COUNT && lane == 0) {
    for (int c = 0; c < NUM_STATS; ++c) atomicAdd(stats + c, stat[c]);
  }
}

// The build the launch takes, and how many of its blocks of `threads`
// threads one SM holds with `smem` bytes of shared memory (above 48 KB the
// kernel is allowed them first).
using K1Kernel = void (*)(const float*, float*, int*, unsigned long long*, int, int, int, int,
                          int, int, int, int, int, int, uint32_t, uint32_t, int, int, float,
                          float);

cudaError_t resident_blocks(K1Kernel kernel, int threads, size_t smem, int* per_sm) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  }
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace

// Blocks of `threads` threads that one SM holds at once (the occupancy
// query K1's launch makes), for the plain or the counting build and this
// scene's shared copy of the record; a negative CUDA error on failure.
extern "C" int k1_blocks_per_sm(int threads, int num_geoms, int num_faces, int counting) {
  int per_sm = 0;
  const cudaError_t err =
      resident_blocks(counting ? k1_kernel<true, false> : k1_kernel<false, false>, threads,
                      sizeof(float) * shared_floats(num_geoms, num_faces), &per_sm);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

extern "C" int k1_accumulate(const float* rec, float* acc, int* queue, unsigned long long* stats,
                             int num_geoms, int num_faces, int n, int p0, int count,
                             int width, int height, int depth, int start_iter, int num_iters,
                             uint32_t key0,
                             uint32_t key1, int aa, int dof, float lens_radius,
                             float focal_distance, int threads, int blocks_per_sm,
                             void* stream) {
  if (count <= 0 || num_iters <= 0) return 0;
  if (threads <= 0) threads = THREADS;
  if (threads % WARP != 0 || threads > MAX_THREADS || num_geoms < 0 || num_faces < 0 ||
      depth < 1 || p0 < 0 || p0 > n - count) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool range = p0 != 0 || count != n;
  const K1Kernel kernel = stats != nullptr ? (range ? k1_kernel<true, true> : k1_kernel<true, false>)
                                           : (range ? k1_kernel<false, true> : k1_kernel<false, false>);
  const size_t smem = sizeof(float) * shared_floats(num_geoms, num_faces);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = resident_blocks(kernel, threads, smem, &per_sm);
  if (err == cudaSuccess) err = cudaMemsetAsync(queue, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = blocks_per_sm > 0 && blocks_per_sm < per_sm ? blocks_per_sm : per_sm;
  const int needed = (count + threads - 1) / threads;
  const int blocks = sms * resident < needed ? sms * resident : needed;
  kernel<<<blocks, threads, smem, st>>>(rec, acc, queue, stats, num_geoms, num_faces, n, p0,
                                        count, width, height, depth, start_iter, num_iters, key0,
                                        key1, aa, dof, lens_radius, focal_distance);
  return static_cast<int>(cudaGetLastError());
}
