"""The port's training data against the JAX package's, on the CPU.

- ``TileDataset`` and ``ValidationDataset`` batches: bit for bit for one
  seed, the padded last batch and its ``k`` included (the same numpy code).
- Shaped ``randint`` / ``bernoulli`` (single keys and batches of keys):
  bit for bit with ``jax.random`` (jax 0.9, threefry partitionable).
- The device-resident trainer's crops (``draw_crops`` + ``crop_batch``)
  against the JAX trainer's ``make_batch`` (split, randint, bernoulli,
  dynamic_slice, the three flips): bit for bit.
- ``write_tza``: the bytes of the JAX writer.
- ``render_training_pairs`` at 16x16: the port's K1 plain version against
  the JAX wavefront, atol 1e-4 on the noisy and clean images and the albedo
  (the same threefry numbers; float32 rounding of the two paths).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from mygpuraytracer_tpu.denoise.tza import write_tza as jax_write_tza
from mygpuraytracer_tpu.train import dataset as jax_dataset

from mygpuraytracer_tpu_torch.denoise.tza import read_tza, write_tza
from mygpuraytracer_tpu_torch.ops import rng
from mygpuraytracer_tpu_torch.train import dataset
from mygpuraytracer_tpu_torch.train.train import crop_batch, draw_crops

REPO = pathlib.Path(__file__).resolve().parent.parent
RENDER_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _make_pairs(d, sizes):
    rng_ = np.random.default_rng(0)
    for i, (h, w) in enumerate(sizes):
        np.save(d / f"s{i}.input.npy", rng_.random((h, w, 6), np.float32))
        np.save(d / f"s{i}.target.npy", rng_.random((h, w, 3), np.float32))
    return str(d)


@pytest.mark.parametrize("augment", [True, False])
def test_tile_dataset_matches_jax(tmp_path, augment):
    d = _make_pairs(tmp_path, [(48, 40), (24, 20), (64, 64)])  # one pair smaller than the tile
    ours = dataset.TileDataset(d, tile_size=32, augment=augment, seed=3)
    theirs = jax_dataset.TileDataset(d, tile_size=32, augment=augment, seed=3)
    assert len(ours) == len(theirs) == 3
    for _ in range(4):
        (x, y), (xj, yj) = ours.sample_batch(5), theirs.sample_batch(5)
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)


def test_tile_dataset_on_data_denoise():
    ours = dataset.TileDataset(str(REPO / "data" / "denoise"), tile_size=64, seed=42)
    theirs = jax_dataset.TileDataset(str(REPO / "data" / "denoise"), tile_size=64, seed=42)
    for _ in range(2):
        np.testing.assert_array_equal(ours.sample_batch(2)[0], theirs.sample_batch(2)[0])


def test_dihedral_matches_jax():
    img = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    for k in range(8):
        np.testing.assert_array_equal(dataset._dihedral(img, k), jax_dataset._dihedral(img, k))


@pytest.mark.parametrize("batch", [4, 3, 9])
def test_validation_batches_match_jax(tmp_path, batch):
    d = _make_pairs(tmp_path, [(96, 96), (20, 24)])  # 9 tiles + 1 padded tile of 32
    ours = list(dataset.ValidationDataset(d, 32).batches(batch))
    theirs = list(jax_dataset.ValidationDataset(d, 32).batches(batch))
    assert len(ours) == len(theirs)
    for (x, y, k), (xj, yj, kj) in zip(ours, theirs):
        assert k == kj
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)
    assert ours[-1][2] == (10 % batch or batch)


def test_datasets_refuse_empty_dir(tmp_path):
    for cls in (dataset.TileDataset, dataset.ValidationDataset):
        with pytest.raises(ValueError, match="no .input.npy"):
            cls(str(tmp_path))


@pytest.mark.parametrize("seed", [0, 42, -7])
@pytest.mark.parametrize("shape, lo, hi", [((16,), 0, 10), ((3, 5), 0, 225),
                                           ((7,), -(2**31), 2**31 - 1), ((4, 3), -3, 1000003)])
def test_randint_shaped_matches_jax(seed, shape, lo, hi):
    key = rng.fold_in(rng.make_key(seed), 5)
    want = np.asarray(jax.random.randint(jax.random.fold_in(jax.random.key(seed), 5), shape, lo,
                                         hi))
    np.testing.assert_array_equal(rng.randint_shaped(key, shape, lo, hi).numpy(), want)


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli_matches_jax(seed, p):
    want = np.asarray(jax.random.bernoulli(jax.random.key(seed), p, (16, 3)))
    np.testing.assert_array_equal(rng.bernoulli(rng.make_key(seed), p, (16, 3)).numpy(), want)


def test_batched_keys_match_jax_split():
    keys = jax.random.split(jax.random.key(9), 6)
    w0, w1 = rng.split_words(rng.make_key(9), 6)
    want = np.stack([np.asarray(jax.random.randint(k, (4,), 0, 77)) for k in keys])
    np.testing.assert_array_equal(rng.randint_shaped((w0, w1), (4,), 0, 77).numpy(), want)
    want = np.stack([np.asarray(jax.random.bernoulli(k, 0.5, (4, 3))) for k in keys])
    np.testing.assert_array_equal(rng.bernoulli((w0, w1), 0.5, (4, 3)).numpy(), want)


def _jax_make_batch(key, x_imgs, y_imgs, batch, tile):
    """The JAX trainer's make_batch (train/train.py:292-305), as written there."""
    def sample_tile(imgs, p, i, j):
        return lax.dynamic_slice(imgs, (p, i, j, 0), (1, tile, tile, imgs.shape[-1]))[0]

    def dihedral(img, fx, fy, ft):
        img = jnp.where(fx, img[:, ::-1], img)
        img = jnp.where(fy, img[::-1], img)
        return jnp.where(ft, jnp.swapaxes(img, 0, 1), img)

    poses, h, w, _ = x_imgs.shape
    kp, ki, kj, kf = jax.random.split(key, 4)
    p = jax.random.randint(kp, (batch,), 0, poses)
    i = jax.random.randint(ki, (batch,), 0, h - tile + 1)
    j = jax.random.randint(kj, (batch,), 0, w - tile + 1)
    flips = jax.random.bernoulli(kf, 0.5, (batch, 3))
    x = jax.vmap(lambda p, i, j: sample_tile(x_imgs, p, i, j))(p, i, j)
    y = jax.vmap(lambda p, i, j: sample_tile(y_imgs, p, i, j))(p, i, j)
    x = jax.vmap(dihedral)(x, flips[:, 0], flips[:, 1], flips[:, 2])
    y = jax.vmap(dihedral)(y, flips[:, 0], flips[:, 1], flips[:, 2])
    return x, y


@pytest.mark.parametrize("seed, epoch", [(42, 0), (42, 3), (7, 1)])
def test_epoch_crops_match_jax(seed, epoch):
    g = np.random.default_rng(seed)
    x_imgs = g.random((3, 40, 36, 6), np.float32)
    y_imgs = g.random((3, 40, 36, 3), np.float32)
    steps, batch, tile = 4, 5, 16
    key = jax.random.fold_in(jax.random.key(seed), epoch)
    crops = draw_crops(rng.fold_in(rng.make_key(seed), epoch), steps, batch, 3, 25, 21)
    assert crops.shape == (steps, batch, 6)
    for s, k in enumerate(jax.random.split(key, steps)):
        xj, yj = _jax_make_batch(k, jnp.asarray(x_imgs), jnp.asarray(y_imgs), batch, tile)
        x = crop_batch(torch.from_numpy(x_imgs), crops[s], tile)
        y = crop_batch(torch.from_numpy(y_imgs), crops[s], tile)
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


def test_write_tza_bytes_match_jax(tmp_path):
    g = np.random.default_rng(1)
    tensors = {
        "enc_conv0.weight": (g.random((32, 6, 3, 3), np.float32), "oihw"),
        "enc_conv0.bias": (g.random(32).astype(np.float32), "x"),
        "odd": (g.random((5, 7)).astype(np.float16), "ab"),
        "bytes": (np.arange(11, dtype=np.uint8), "x"),
    }
    write_tza(str(tmp_path / "port.tza"), tensors)
    jax_write_tza(str(tmp_path / "jax.tza"), tensors)
    assert (tmp_path / "port.tza").read_bytes() == (tmp_path / "jax.tza").read_bytes()
    back = read_tza(str(tmp_path / "port.tza"))
    for name, (arr, layout) in tensors.items():
        assert back[name][1] == layout
        np.testing.assert_array_equal(back[name][0], arr)
    with pytest.raises(ValueError, match="does not match rank"):
        write_tza(str(tmp_path / "bad.tza"), {"w": (np.zeros((2, 2), np.float32), "x")})


def test_render_training_pairs_matches_jax(tmp_path):
    scene = str(REPO / "scenes" / "builtin_cornell.txt")
    kw = dict(noisy_spp=2, clean_spp=4, resolution=16, seed=3)
    x, y = dataset.render_training_pairs(scene, str(tmp_path / "port"), "c", device="cpu", **kw)
    xj, yj = jax_dataset.render_training_pairs(scene, str(tmp_path / "jax"), "c", **kw)
    assert x.shape == (16, 16, 6) and y.shape == (16, 16, 3)
    assert x.dtype == y.dtype == np.float32
    np.testing.assert_allclose(x, xj, atol=RENDER_ATOL)
    np.testing.assert_allclose(y, yj, atol=RENDER_ATOL)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "c.input.npy"), x)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "c.target.npy"), y)
    assert y.mean() > 1e-3
