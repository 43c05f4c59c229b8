"""K6 on the card against its plain version and against cuRAND's Philox.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prng_cuda.py
Without a CUDA device every case skips: the kernel has no CPU mode.
Tolerance: none. K6 is integer arithmetic and one exact conversion, so it
equals ``uniforms_reference`` bit for bit, at small shapes and at the main
path's [4, 640000] (raygen) and [28, 640000] (the wavefront at depth 8),
and ``iteration_uniforms`` under rng "auto" on CUDA launches it at the seed
``randint(ikey)``. As an independent oracle, a tiny test kernel compiled
here draws the same stream with the CUDA toolkit's own
``curand_Philox4x32_10`` (curand_kernel.h); K6 must equal it bit for bit.
cuRAND serves only this test, never the port.
"""

import ctypes
import subprocess

import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prng, rng

CURAND_ORACLE = r"""
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

// The port's stream (ops/prng.py) from cuRAND's Philox4x32-10.
__global__ void oracle(int32_t seed, float* out, int k, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const uint32_t w = static_cast<uint32_t>(seed) * 0x9E3779B1u + col / 2048u;
  for (int g = 0; 4 * g < k; ++g) {
    const uint4 r = curand_Philox4x32_10(make_uint4(g, col % 2048, 0u, 0u), make_uint2(w, 0u));
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
    for (int j = 0; j < 4 && 4 * g + j < k; ++j) {
      out[static_cast<int64_t>(4 * g + j) * n + col] =
          static_cast<float>(words[j] >> 8) * (1.0f / 16777216.0f);
    }
  }
}

extern "C" int oracle_uniforms(int seed, float* out, int k, int n) {
  oracle<<<(n + 255) / 256, 256>>>(seed, out, k, n);
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}
"""


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")


@pytest.fixture(scope="module")
def curand_oracle(tmp_path_factory):
    _need_cuda()
    d = tmp_path_factory.mktemp("curand_oracle")
    (d / "oracle.cu").write_text(CURAND_ORACLE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "liboracle.so"),
                    str(d / "oracle.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(d / "liboracle.so"))
    lib.oracle_uniforms.restype = ctypes.c_int
    lib.oracle_uniforms.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return lib


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", [0, -9, 2**31 - 1])
@pytest.mark.parametrize("k,n", [(4, 2049), (28, 5000), (1, 1), (7, 333)])
def test_k6_equals_plain_bit_for_bit(seed, k, n):
    _need_cuda()
    before = prng.LAUNCHES
    got = prng.pallas_uniforms(seed, k, n, "cuda")
    torch.cuda.synchronize()
    assert prng.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), prng.uniforms_reference(seed, k, n))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", [0, 1234567, -(2**31)])
@pytest.mark.parametrize("k", [4, 28])
def test_k6_equals_plain_at_the_main_path_shapes(seed, k):
    _need_cuda()
    n = 800 * 800
    got = prng.pallas_uniforms(seed, k, n, "cuda")
    assert torch.equal(got, prng.uniforms_reference(seed, k, n, "cuda"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", [0, -9, 2**31 - 1])
@pytest.mark.parametrize("k,n", [(28, 5000), (4, 800 * 800), (3, 333)])
def test_k6_equals_curand_philox(seed, k, n, curand_oracle):
    want = torch.full((k, n), float("nan"), device="cuda")
    torch.cuda.synchronize()
    assert curand_oracle.oracle_uniforms(seed, want.data_ptr(), k, n) == 0
    assert torch.equal(prng.pallas_uniforms(seed, k, n, "cuda"), want)


@pytest.mark.requires_cuda
def test_iteration_uniforms_auto_launches_k6():
    _need_cuda()
    ikey = rng.iteration_key(rng.make_key(4), 3)
    before = prng.LAUNCHES
    got = prng.iteration_uniforms(RenderOptions(rng="auto"), ikey, 3, 28, 777, "cuda")
    assert prng.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), prng.uniforms_reference(rng.randint(ikey), 28, 777))
    same = prng.iteration_uniforms(RenderOptions(rng="threefry"), ikey, 3, 28, 777, "cuda")
    assert prng.LAUNCHES == before + 1
    assert torch.equal(same.cpu(), rng.uniform(ikey, (28, 777)))
