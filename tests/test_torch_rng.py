"""Torch threefry2x32 against jax.random: bit-identical keys, fold_in, uniforms.

Tolerance: none. Every word and every float must match bit for bit (jax
0.9 with jax_threefry_partitionable on), since the K1 kernel and the
wavefront rely on drawing exactly the JAX package's numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu_torch.ops import rng

SEEDS = [0, 1, 42, 2**31 - 1, -7]
# (7, 33): odd sizes; (28, 4096) = (4 + 3*8, 64*64): one iteration's block at
# depth 8 on a 64x64 image; (31, 1000): a block that crosses no power of two.
SHAPES = [(7, 33), (28, 4096), (31, 1000)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_make_key_matches_jax(seed):
    assert rng.make_key(seed) == _words(jax.random.key(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 123456, 2**31 - 1])
def test_fold_in_matches_jax(seed, data):
    assert rng.fold_in(rng.make_key(seed), data) == _words(
        jax.random.fold_in(jax.random.key(seed), data))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed,iteration", [(0, 1), (3, 17)])
def test_uniform_bit_identical(shape, seed, iteration):
    jkey = jax.random.fold_in(jax.random.key(seed), iteration)
    want = np.asarray(jax.random.uniform(jkey, shape, dtype=jnp.float32))
    got = rng.uniform(rng.iteration_key(rng.make_key(seed), iteration), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_threefry_int_and_tensor_paths_agree():
    """The scalar (Python int) path used for keys equals the tensor path."""
    gen = np.random.default_rng(0)
    k0, k1 = (int(x) for x in gen.integers(0, 2**32, 2))
    xs = gen.integers(0, 2**32, (2, 64))
    y0, y1 = rng.threefry2x32(k0, k1, torch.as_tensor(xs[0]), torch.as_tensor(xs[1]))
    for i in range(64):
        s0, s1 = rng.threefry2x32(k0, k1, int(xs[0, i]), int(xs[1, i]))
        assert (s0, s1) == (int(y0[i]), int(y1[i]))


def test_uniform_range():
    u = rng.uniform(rng.make_key(5), (4, 10000))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
