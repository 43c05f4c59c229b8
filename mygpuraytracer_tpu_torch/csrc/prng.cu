// K6: a [k, n] block of uniforms in [0, 1) with 24-bit mantissas.
//
// Replaces mygpuraytracer_tpu/ops/prng.py::_uniform_kernel, the Pallas
// kernel that pallas_uniforms launches on the TPU. That kernel seeded the
// TPU's hardware PRNG with seed * 0x9E3779B1 + b for each 2048-column block
// b and took (bits >> 8) * 2^-24 per element. The hardware generator cannot
// be reproduced anywhere else, so the port defines the stream as a pure
// counter function (path.cuh::counter_uniform, ops/prng.py): element
// (row, col) is threefry2x32 keyed (0, seed * 0x9E3779B1 + col / 2048) at the
// counter (row, col % 2048), its bits y0 ^ y1 >> 8 times 2^-24. The value
// depends only on (seed, row, col), so K5 (bounce.cu) draws the same numbers
// in-kernel at any (row, pixel) without this block.
//
// Design: one thread per element, 256 threads per block, row-major over the
// [k, n] output, so a warp writes 128 contiguous bytes.
//
// Bound on an H100: operations. Each element is one threefry2x32 of 20
// rounds (~105 INT32 operations on the half-rate integer pipe) against 4
// bytes written; at [28, 640000] that is ~0.056 ms of integer work against
// ~0.021 ms of bytes.
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "path.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    k6_kernel(int32_t seed, float* __restrict__ out, int k, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(k) * n) return;
  const uint32_t row = static_cast<uint32_t>(i / n);
  const uint32_t col = static_cast<uint32_t>(i % n);
  out[i] = counter_uniform(stream_word(seed, col), row, col);
}

}  // namespace

extern "C" int k6_uniforms(int seed, float* out, int k, int n, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  const int64_t total = static_cast<int64_t>(k) * n;
  const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
  k6_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(seed, out, k, n);
  return static_cast<int>(cudaGetLastError());
}
