"""The port's RNG dispatch and K6's counter stream against jax.random.

- ``rng.split`` and ``rng.randint`` equal ``jax.random.split`` and
  ``jax.random.randint(key, (), 0, 2**31 - 1, int32)`` bit for bit (jax 0.9
  with jax_threefry_partitionable on) over 1200 keys each: K6's seed is
  ``randint`` of the iteration key.
- ``iteration_uniforms`` equals the JAX package's on the CPU bit for bit for
  every ``rng`` mode: both draw threefry there.
- The plain K6 (``uniforms_reference``), whose TPU original drew from the
  hardware PRNG and has no oracle: its values lie in [0, 1) on the 2^-24
  grid, depend on (seed, row, col) only, pad past a multiple of 2048 as the
  TPU kernel's blocks did, and have the mean and variance of U[0, 1) within
  5 sigma.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.config import RenderOptions as JaxOptions
from mygpuraytracer_tpu.ops.prng import iteration_uniforms as jax_iteration_uniforms

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prng, rng

NUM_KEYS = 1200


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _keys(seed: int):
    """NUM_KEYS JAX keys and their port words."""
    keys = jax.random.split(jax.random.key(seed), NUM_KEYS)
    words = np.asarray(jax.random.key_data(keys))
    return keys, [(int(a), int(b)) for a, b in words]


@pytest.mark.parametrize("seed", [0, 77])
def test_split_matches_jax(seed):
    keys, words = _keys(seed)
    want = np.asarray(jax.random.key_data(jax.vmap(jax.random.split)(keys)))
    got = np.array([rng.split(w) for w in words], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 77])
def test_randint_matches_jax(seed):
    keys, words = _keys(seed)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, 2**31 - 1, dtype=jnp.int32))(keys))
    got = np.array([rng.randint(w) for w in words], dtype=np.int32)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == NUM_KEYS  # distinct seeds


def test_randint_other_bounds_match_jax():
    keys, words = _keys(3)
    for lo, hi in ((-5, 17), (-(2**31), 2**31 - 1), (1000, 1001)):
        want = np.asarray(jax.vmap(
            lambda k, lo=lo, hi=hi: jax.random.randint(k, (), lo, hi, dtype=jnp.int32))(keys[:64]))
        got = np.array([rng.randint(w, lo, hi) for w in words[:64]], dtype=np.int32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["threefry", "auto", "pallas"])
def test_iteration_uniforms_match_jax_on_cpu(mode):
    for seed, iteration in ((0, 1), (9, 14)):
        jkey = jax.random.fold_in(jax.random.key(seed), iteration)
        want = np.asarray(jax_iteration_uniforms(JaxOptions(rng=mode), jkey, iteration, 28, 999))
        ikey = rng.iteration_key(rng.make_key(seed), iteration)
        got = prng.iteration_uniforms(RenderOptions(rng=mode), ikey, iteration, 28, 999, "cpu")
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
        assert prng.uniforms_mode(RenderOptions(rng=mode), "cpu") == "threefry"


def test_uniforms_mode_follows_the_jax_dispatch():
    assert prng.uniforms_mode(RenderOptions(rng="auto"), "cuda") == "pallas"
    assert prng.uniforms_mode(RenderOptions(rng="pallas"), "cuda:0") == "pallas"
    assert prng.uniforms_mode(RenderOptions(rng="threefry"), "cuda") == "threefry"
    assert prng.uniforms_mode(object(), "cuda") == "pallas"  # no rng: "auto"


@pytest.mark.parametrize("seed", [0, 1, -3, 2**31 - 1])
def test_plain_k6_on_the_grid(seed):
    u = prng.uniforms_reference(seed, 28, 5000)
    assert u.dtype == torch.float32 and u.shape == (28, 5000)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    scaled = u.double() * 2**24
    assert torch.equal(scaled, scaled.round())


def test_plain_k6_value_depends_on_seed_row_col_only():
    big = prng.uniforms_reference(11, 28, 3 * 2048 + 5)
    for k, n in ((4, 100), (4, 4100), (28, 2048), (7, 6149)):
        assert torch.equal(prng.uniforms_reference(11, k, n), big[:k, :n])
    assert not torch.equal(prng.uniforms_reference(12, 4, 100), big[:4, :100])


@pytest.mark.parametrize("n", [1, 2047, 2049, 5000])
def test_plain_k6_pads_past_whole_blocks(n):
    padded = -(-n // prng._BLK) * prng._BLK
    full = prng.uniforms_reference(5, 4, padded)
    assert torch.equal(prng.pallas_uniforms(5, 4, n, "cpu"), full[:, :n])


def test_plain_k6_blocks_are_distinct_streams():
    u = prng.uniforms_reference(5, 2, 3 * 2048)
    blocks = u.reshape(2, 3, 2048)
    assert not torch.equal(blocks[:, 0], blocks[:, 1])
    assert not torch.equal(blocks[:, 1], blocks[:, 2])


def test_plain_k6_mean_and_variance():
    u = prng.uniforms_reference(2024, 28, 20000).double()
    m = u.numel()
    # U[0,1): mean 1/2 (sd of the mean sqrt(1/12 / m)), variance 1/12 (sd of
    # the sample variance sqrt((1/80 - 1/144) / m)).
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12 / m) ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 5 * ((1 / 80 - 1 / 144) / m) ** 0.5


def test_pallas_uniforms_on_cpu_counts_no_launch_and_other_devices_raise():
    before = prng.LAUNCHES
    prng.pallas_uniforms(1, 4, 10, "cpu")
    assert prng.LAUNCHES == before
    with pytest.raises(ValueError):
        prng.pallas_uniforms(1, 4, 10, "meta")
