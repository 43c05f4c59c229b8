"""K6 on the card against its plain version.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prng_cuda.py
Without a CUDA device every case skips: the kernel has no CPU mode.
Tolerance: none. K6 is integer arithmetic and one exact conversion, so it
equals ``uniforms_reference`` bit for bit, and ``iteration_uniforms`` under
rng "auto" on CUDA launches it at the seed ``randint(ikey)``.
"""

import pytest
import torch

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prng, rng


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", [0, -9, 2**31 - 1])
@pytest.mark.parametrize("k,n", [(4, 2049), (28, 5000), (1, 1)])
def test_k6_equals_plain_bit_for_bit(seed, k, n):
    _need_cuda()
    before = prng.LAUNCHES
    got = prng.pallas_uniforms(seed, k, n, "cuda")
    torch.cuda.synchronize()
    assert prng.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), prng.uniforms_reference(seed, k, n))


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
