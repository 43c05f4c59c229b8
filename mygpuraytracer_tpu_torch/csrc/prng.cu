// K6: a [k, n] block of uniforms in [0, 1) with 24-bit mantissas.
//
// Replaces mygpuraytracer_tpu/ops/prng.py::_uniform_kernel, the Pallas
// kernel that pallas_uniforms launches on the TPU. That kernel seeded the
// TPU's hardware PRNG with seed * 0x9E3779B1 + b for each 2048-column block
// b and took (bits >> 8) * 2^-24 per element. The hardware generator cannot
// be reproduced anywhere else, so the port defines the stream as a pure
// counter function (path.cuh::counter_group, ops/prng.py): element
// (row, col) is word row % 4 of Philox4x32-10 keyed (seed * 0x9E3779B1 +
// col / 2048, 0) at the counter (row / 4, col % 2048, 0, 0), its bits >> 8
// times 2^-24. The value depends only on (seed, row, col), so K5
// (bounce.cu) draws the same numbers in-kernel at any (row, pixel) without
// this block.
//
// Design: one thread per (column, group of 4 rows): one Philox call gives
// the group's four rows, written with four stores that each cover 128
// contiguous bytes across the warp; rows past k are masked. Grid: columns
// in x, groups in y.
//
// Bound on an H100: bytes. A Philox4x32-10 call is ~10 x (two 32x32->64
// multiplies on the IMAD pipe, two 3-input xors) plus 9 key bumps, i.e.
// ~15 integer instructions per float written, against 4 bytes per float:
// at [28, 640000] ~0.016 ms of integer work against ~0.021 ms of bytes.
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); the C entry
// point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "path.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
    k6_kernel(int32_t seed, float* __restrict__ out, int k, int n) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= n) return;
  const uint32_t word = stream_word(seed, static_cast<uint32_t>(col));
  const int groups = (k + 3) / 4;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const Words4 w = counter_group(word, static_cast<uint32_t>(g), static_cast<uint32_t>(col));
    float* o = out + static_cast<int64_t>(4 * g) * n + col;
    const int rows = k - 4 * g;
    o[0] = word_uniform(w.x);
    if (rows > 1) o[n] = word_uniform(w.y);
    if (rows > 2) o[2 * static_cast<int64_t>(n)] = word_uniform(w.z);
    if (rows > 3) o[3 * static_cast<int64_t>(n)] = word_uniform(w.w);
  }
}

}  // namespace

extern "C" int k6_uniforms(int seed, float* out, int k, int n, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  const int groups = (k + 3) / 4;
  const dim3 grid((n + THREADS - 1) / THREADS, groups < MAX_GRID_Y ? groups : MAX_GRID_Y);
  k6_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(seed, out, k, n);
  return static_cast<int>(cudaGetLastError());
}
