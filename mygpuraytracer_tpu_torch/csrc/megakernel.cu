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
// fixed per (row, pixel), so stopping consumes no numbers. K1 draws threefry
// whatever RenderOptions.rng says, as the TPU's K1 drew its hardware PRNG
// whatever it said; K5 (bounce.cu) is the kernel that follows rng.
//
// Bound on an H100: FP32 and integer ALU work per ray-bounce, not memory.
// Each sample runs up to 4 + 3*depth threefry draws (28 at depth 8, ~100
// integer operations each) and, per bounce, one slab or quadric test per
// geom plus one Moller-Trumbore test per listed face; paths in a warp
// diverge across materials and bounce counts. Memory is 9 planes x 4 B x N
// read and written once per launch. Making it fast is later work.
//
// The record layout, threefry, the primitive tests and shade() live in
// path.cuh, which K5 shares. Built by mygpuraytracer_tpu_torch/_build.py
// (nvcc, sm_90a); the C entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "path.cuh"

namespace {

constexpr int THREADS = 128;

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
