"""The port's stream compaction and material sort against the JAX package's.

Same inputs on both sides (numpy seeds); every comparison is exact, dtypes
included: the functions only move and count integers and floats.
The fixed cases mirror tests/test_ops.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mygpuraytracer_tpu.ops import compaction as jc

from mygpuraytracer_tpu_torch.ops import compaction as tc

CASES = [(0, 257, 5), (1, 1000, 9), (2, 64, 2), (3, 4096, 12)]  # seed, n, materials


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ids(seed, n, m):
    return np.random.default_rng(seed).integers(0, m, size=n).astype(np.int32)


def _same(t: torch.Tensor, j) -> None:
    a = np.asarray(j)
    assert str(t.dtype).removeprefix("torch.") == str(a.dtype), (t.dtype, a.dtype)
    np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("seed,n,m", CASES)
def test_exclusive_scan_matches_jax(seed, n, m):
    x = _ids(seed, n, m)
    _same(tc.exclusive_scan(torch.from_numpy(x)), jc.exclusive_scan(jnp.asarray(x)))
    mask = x > m // 2
    _same(tc.exclusive_scan(torch.from_numpy(mask)), jc.exclusive_scan(jnp.asarray(mask)))


@pytest.mark.parametrize("seed,n,m", CASES)
def test_compact_matches_jax(seed, n, m):
    rng = np.random.default_rng(seed + 100)
    mask = rng.random(n) < 0.4
    vals = rng.random(n).astype(np.float32)
    ids = _ids(seed, n, m)
    got = tc.compact(torch.from_numpy(mask), torch.from_numpy(vals), torch.from_numpy(ids))
    want = jc.compact(jnp.asarray(mask), jnp.asarray(vals), jnp.asarray(ids))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    assert int(got[0]) == int(mask.sum())


@pytest.mark.parametrize("seed,n,m", CASES)
def test_sort_by_material_key_matches_jax(seed, n, m):
    ids = _ids(seed, n, m)
    vals = np.random.default_rng(seed + 7).random(n).astype(np.float32)
    pix = np.arange(n, dtype=np.int32)
    got = tc.sort_by_material_key(*(torch.from_numpy(a) for a in (ids, vals, pix)))
    want = jc.sort_by_material_key(*(jnp.asarray(a) for a in (ids, vals, pix)))
    for g, w in zip(got, want):
        _same(g, w)
    got = tc.lax_sort_by_neg_key(torch.from_numpy(-ids), (torch.from_numpy(vals),))
    want = jc.lax_sort_by_neg_key(jnp.asarray(-ids), (jnp.asarray(vals),))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("seed,n,m", CASES)
def test_material_sort_perm_is_stable_descending_argsort(seed, n, m):
    ids = _ids(seed, n, m)
    perm = tc.material_sort_perm(torch.from_numpy(ids), m)
    _same(perm, jc.material_sort_perm(jnp.asarray(ids), m))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.argsort(-ids, kind="stable"))
    np.testing.assert_array_equal(
        perm.numpy(), torch.argsort(-torch.from_numpy(ids), stable=True).numpy())


def test_fixed_cases_of_the_jax_suite():
    x = torch.tensor([3, 1, 7, 0, 4, 1, 6, 3], dtype=torch.int32)
    assert tc.exclusive_scan(x).tolist() == [0, 3, 4, 11, 11, 15, 16, 22]
    mask = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0, 1, 1], dtype=torch.bool)
    count, packed = tc.compact(mask, torch.arange(10))
    assert int(count) == 6
    assert packed.tolist() == [0, 2, 3, 6, 8, 9, 1, 4, 5, 7]
    keys, vals = tc.sort_by_material_key(torch.tensor([2, 0, 3, 1, 3, 2]), torch.arange(6))
    assert keys.tolist() == [3, 3, 2, 2, 1, 0] and vals.tolist() == [2, 4, 0, 5, 3, 1]
