// Two blocks of uniforms in [0, 1): K6's counter stream and threefry's.
//
// K6: a [k, n] block of uniforms with 24-bit mantissas.
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
// A launch writes the columns col0 .. col0 + n - 1 of the stream (out is
// [k, n]): the column range of a pixel-sharded render (parallel/sharded.py);
// the whole block is col0 = 0. The seed comes by value or, in the build with
// WORDS, is derived in the kernel from the base key and the iteration, read
// from device memory (the capture route of render/graphs.py).
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
// threefry: columns col0 .. col0 + count - 1 of jax.random.uniform(key,
// (k, n)) in float32, bit for bit (ops/rng.py::uniform_columns, its plain
// version): element (r, c) is flat element r * n + col0 + c of the draw,
// the bits y0 ^ y1 of threefry2x32(key, (index >> 32, index & 0xFFFFFFFF))
// and the uniform bitcast((bits >> 9) | 0x3F800000) - 1 (path.cuh::Stream).
// The wavefront draws its [4 + 3 * depth, N] block of each iteration so
// (render/pathtrace.py), as the JAX package does with jax.random.uniform;
// it replaces no TPU kernel: on CUDA it takes the place of ~350 int64 ATen
// kernels an iteration (ops/rng.py's words in int64, torch lacking uint32).
// The key comes by value or, in the build with WORDS, is derived in the
// kernel as fold_in(base key, iteration), the iteration read from device
// memory (the capture route).
//
// Design: one thread per column, looping over the k rows, so each row's
// store covers 128 contiguous bytes across the warp. Bound on an H100:
// instruction throughput. A draw is 20 rounds of add, funnel rotate and
// xor, the key injections and the conversion, ~70 integer SASS
// instructions, which nvcc spreads over the ALU and FMA pipes (adds as
// IMAD), so one warp instruction per clock per SM sub-partition is the
// floor: at [28, 640000] ~0.037 ms, against ~0.021 ms of bytes (4 per float
// written).
//
// Built by mygpuraytracer_tpu_torch/_build.py (nvcc, sm_90a); each C entry
// point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "path.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

// WORDS: the seed is the iteration's, randint(fold_in(base key, iteration))
// (path.cuh::iteration_words), derived from the base key (key0, key1) and
// the iteration read from device memory, *iteration_at (an int64): the
// iteration is counted by the device in a CUDA graph (render/graphs.py),
// where a seed baked into the launch would be the captured iteration's.
template <bool WORDS>
__global__ void __launch_bounds__(THREADS)
    k6_kernel(int32_t seed, float* __restrict__ out, int k, int n, int col0, uint32_t key0,
              uint32_t key1, const long long* __restrict__ iteration_at) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= n) return;
  if (WORDS) {
    uint32_t ik0, ik1;
    iteration_words(key0, key1, static_cast<uint32_t>(*iteration_at), ik0, ik1, seed);
  }
  const uint32_t c = static_cast<uint32_t>(col0 + col);  // the stream's column
  const uint32_t word = stream_word(seed, c);
  const int groups = (k + 3) / 4;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const Words4 w = counter_group(word, static_cast<uint32_t>(g), c);
    float* o = out + static_cast<int64_t>(4 * g) * n + col;
    const int rows = k - 4 * g;
    o[0] = word_uniform(w.x);
    if (rows > 1) o[n] = word_uniform(w.y);
    if (rows > 2) o[2 * static_cast<int64_t>(n)] = word_uniform(w.z);
    if (rows > 3) o[3 * static_cast<int64_t>(n)] = word_uniform(w.w);
  }
}

// WORDS: the key is the iteration's, fold_in(base key, iteration)
// (path.cuh::iteration_key), derived from the base key (key0, key1) and the
// iteration read from device memory, *iteration_at (an int64), as for K6.
template <bool WORDS>
__global__ void __launch_bounds__(THREADS)
    threefry_uniforms_kernel(float* __restrict__ out, int k, int count, uint64_t n, uint64_t col0,
                             uint32_t key0, uint32_t key1,
                             const long long* __restrict__ iteration_at) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= count) return;
  Stream s{key0, key1, n, col0 + c};
  if (WORDS) iteration_key(key0, key1, static_cast<uint32_t>(*iteration_at), s.k0, s.k1);
  float* o = out + c;
  for (int r = 0; r < k; ++r) o[static_cast<int64_t>(r) * count] = s.uniform(r);
}

}  // namespace

// iteration_at, if not null, replaces seed: the kernel derives the seed from
// the base key (key0, key1) and the iteration it reads from device memory.
extern "C" int k6_uniforms(int seed, float* out, int k, int n, int col0, uint32_t key0,
                           uint32_t key1, const long long* iteration_at, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (col0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (k + 3) / 4;
  const dim3 grid((n + THREADS - 1) / THREADS, groups < MAX_GRID_Y ? groups : MAX_GRID_Y);
  auto kernel = iteration_at != nullptr ? k6_kernel<true> : k6_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(seed, out, k, n, col0, key0,
                                                                  key1, iteration_at);
  return static_cast<int>(cudaGetLastError());
}

// Columns col0 .. col0 + count - 1 of the threefry block [k, n] under the key
// (key0, key1) into out ([k, count]); iteration_at, if not null, makes
// (key0, key1) the base key: the kernel derives the iteration's key from it
// and the iteration it reads from device memory.
extern "C" int threefry_uniforms(float* out, int k, int count, long long n, long long col0,
                                 uint32_t key0, uint32_t key1, const long long* iteration_at,
                                 void* stream) {
  if (k < 0 || count < 0 || col0 < 0 || col0 > n - count) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0 || count == 0) return 0;
  const int blocks = (count + THREADS - 1) / THREADS;
  auto kernel = iteration_at != nullptr ? threefry_uniforms_kernel<true>
                                        : threefry_uniforms_kernel<false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(out, k, count, n, col0, key0,
                                                                    key1, iteration_at);
  return static_cast<int>(cudaGetLastError());
}
