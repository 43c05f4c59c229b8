"""The port's denoiser against the JAX package's, in float32 on the CPU.

- TZA reading: identical arrays and layouts.
- U-Net: the same weights (weights/*.tza, or numpy-seeded weights carried over
  by ``params_from_jax``) on the same numpy-seeded 64x64 input; max relative
  error (|a - b| / max|b|) < 1e-4, the reference's fp32 bar (BASELINE.md).
- The fused render->denoise packing and the color transfers: same inputs,
  atol 1e-5 (float32 transcendental rounding differs between XLA and torch).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mygpuraytracer_tpu.denoise import color as jax_color
from mygpuraytracer_tpu.denoise.tza import read_tza as jax_read_tza
from mygpuraytracer_tpu.denoise.unet import conv_specs as jax_conv_specs
from mygpuraytracer_tpu.denoise.unet import unet_apply as jax_unet_apply
from mygpuraytracer_tpu.denoise.weights import load_default_params as jax_load_params
from mygpuraytracer_tpu.ops.vec3 import Vec3 as JaxVec3
from mygpuraytracer_tpu.render.denoise_fused import denoise_accumulator as jax_denoise

from mygpuraytracer_tpu_torch.denoise import color, weights
from mygpuraytracer_tpu_torch.denoise.tza import read_tza
from mygpuraytracer_tpu_torch.denoise.unet import UNet, params_from_jax, unet_apply
from mygpuraytracer_tpu_torch.render.denoise_fused import denoise_accumulator, load_denoiser

REPO = pathlib.Path(__file__).resolve().parent.parent
UNET_MAX_REL = 1e-4
PACK_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", ["rt_ldr_alb", "rt_hdr_alb_nrm", "rtlightmap_dir"])
def test_read_tza_matches_jax(name):
    path = str(REPO / "weights" / f"{name}.tza")
    a, b = read_tza(path), jax_read_tza(path)
    assert list(a) == list(b)
    for k in a:
        assert a[k][1] == b[k][1]
        np.testing.assert_array_equal(a[k][0], b[k][0])


def test_unet_real_weights_matches_jax():
    jparams, random_init = jax_load_params("rt_ldr_alb")
    assert not random_init
    tensors, t_random = weights.load_default_params("rt_ldr_alb")
    assert not t_random
    net = UNet.from_tza(tensors)
    x = np.random.default_rng(0).random((1, 64, 64, 6), np.float32)
    want = np.asarray(jax_unet_apply(jparams, jnp.asarray(x)))
    got = unet_apply(net, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert _max_rel(got, want) < UNET_MAX_REL


@pytest.mark.parametrize("channels", [3, 9])
def test_params_from_jax_matches_unet_apply(channels):
    """A JAX parameter dict {name: {'w': HWIO, 'b': [O]}} of numpy-seeded
    He-scaled weights and nonzero biases."""
    gen = np.random.default_rng(100 + channels)
    jparams = {
        name: {"w": (gen.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
               "b": (gen.standard_normal(cout) * 0.01).astype(np.float32)}
        for name, cin, cout in jax_conv_specs(channels)
    }
    net = params_from_jax(jparams)
    x = np.random.default_rng(channels).random((1, 32, 48, channels), np.float32)
    want = np.asarray(jax_unet_apply(jparams, jnp.asarray(x)))
    got = unet_apply(net, torch.from_numpy(x)).numpy()
    assert _max_rel(got, want) < UNET_MAX_REL


def _accumulators(w, h, seed=0):
    gen = np.random.default_rng(seed)
    n = w * h
    image = gen.gamma(1.0, 2.0, (3, n)).astype(np.float32) * 7  # sum of 7 iterations
    image[0, :5] = [np.nan, np.inf, -1.0, 0.0, 1e4]
    albedo = gen.random((3, n), np.float32)
    normal = (gen.random((3, n), np.float32) * 2 - 1).astype(np.float32)
    return image, albedo, normal


@pytest.mark.parametrize("slot,hdr,use_normal", [
    ("rt_ldr_alb", False, False),
    ("rt_ldr_alb_nrm", False, True),
    ("rt_hdr_alb", True, False),
])
def test_denoise_accumulator_matches_jax(slot, hdr, use_normal):
    w, h = 40, 24  # not multiples of 16: exercises the alignment padding
    image, albedo, normal = _accumulators(w, h)
    jparams, _ = jax_load_params(slot)
    jv = lambda a: JaxVec3(*(jnp.asarray(r) for r in a))
    want = np.asarray(jax_denoise(jv(image), jv(albedo), jnp.int32(7), jparams, (w, h),
                                  normal=jv(normal) if use_normal else None, hdr=hdr))
    net, random_init = load_denoiser(slot, "cpu")
    assert not random_init
    got = denoise_accumulator(torch.from_numpy(image), torch.from_numpy(albedo), 7, net, (w, h),
                              normal=torch.from_numpy(normal) if use_normal else None,
                              hdr=hdr).numpy()
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, atol=PACK_ATOL, rtol=1e-4)


def _samples():
    gen = np.random.default_rng(5)
    x = np.concatenate([gen.random(500) * 2, gen.random(500) * 1e-5, gen.random(500) * 3e3,
                        [0.0, 1.0, 65504.0]]).astype(np.float32)
    return x


@pytest.mark.parametrize("fn,jfn", [
    (color.srgb_forward, lambda y: jax_color.SRGBTransfer().forward(y)),
    (color.srgb_inverse, lambda x: jax_color.SRGBTransfer().inverse(x)),
    (color.pu_forward, lambda y: jax_color.PUTransfer().forward(y)),
    (color.pu_inverse, lambda x: jax_color.PUTransfer().inverse(x)),
], ids=["srgb_fwd", "srgb_inv", "pu_fwd", "pu_inv"])
def test_transfers_match_jax(fn, jfn):
    x = _samples()
    if fn in (color.srgb_inverse, color.pu_inverse):
        x = np.clip(x, 0.0, 1.0)
    got = fn(torch.from_numpy(x)).numpy()
    want = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (8, 8)])
def test_autoexposure_matches_jax(shape):
    img = np.random.default_rng(shape[0]).gamma(0.5, 1.0, (*shape, 3)).astype(np.float32)
    img[0, 0] = np.nan
    got = float(color.autoexposure(torch.from_numpy(img)))
    want = float(jax_color.autoexposure(jnp.asarray(img)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_sanitize_matches_jax():
    x = np.array([np.nan, -np.inf, -2.0, 0.5, 3.0, np.inf], np.float32)
    np.testing.assert_array_equal(color.sanitize(torch.from_numpy(x), 0.0, 1.0).numpy(),
                                  np.asarray(jax_color.sanitize(jnp.asarray(x), 0.0, 1.0)))


def test_weights_dir_env_and_stub(tmp_path, monkeypatch):
    """$MYGPURAYTRACER_TPU_WEIGHTS_DIR is searched first; an LFS stub there is
    skipped and the repository's weights load instead."""
    (tmp_path / "rt_ldr.tza").write_text("version https://git-lfs.github.com/spec/v1\n")
    monkeypatch.setenv("MYGPURAYTRACER_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(weights, "_cache", {})
    assert weights.search_dirs()[0] == str(tmp_path)
    tensors, random_init = weights.load_default_params("rt_ldr")
    assert not random_init and tensors["enc_conv0.weight"][0].shape[1] == 3
    with pytest.raises(ValueError):
        weights.load_default_params("no_such_slot")


def test_random_init_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(weights, "_cache", {})
    monkeypatch.setattr(weights, "search_dirs", lambda: [str(tmp_path)])
    tensors, random_init = weights.load_default_params("rt_ldr_alb")
    assert random_init
    net = UNet.from_tza(tensors)
    assert net.in_channels == 6
    again, _ = weights.load_default_params("rt_ldr_alb")
    assert again is tensors
