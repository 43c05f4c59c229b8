"""The port's SSIM, MS-SSIM and training losses against the JAX package's,
in float32 on the CPU, on numpy-seeded NHWC inputs.

Tolerances: values rtol 1e-5 (float32 reductions and the depthwise
filter's summation order differ between XLA and torch); the gradient of
l1_msssim with respect to pred atol 1e-6 against ``jax.grad``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.train import losses as jax_losses
from mygpuraytracer_tpu.train import ssim as jax_ssim

from mygpuraytracer_tpu_torch.train import losses, ssim

VALUE_RTOL = 1e-5
GRAD_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def pair(seed, size, channels=3, batch=2):
    rng = np.random.default_rng(seed)
    a = rng.random((batch, size, size, channels), np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape).astype(np.float32), 0.0, 1.0)
    return a, b


def both(fn_jax, fn_torch, a, b, **kw):
    want = float(fn_jax(jnp.asarray(a), jnp.asarray(b), **kw))
    got = float(fn_torch(torch.from_numpy(a), torch.from_numpy(b), **kw))
    return got, want


@pytest.mark.parametrize("size", [16, 48, 176])
def test_ssim_matches_jax(size):
    a, b = pair(size, size, batch=1)
    got, want = both(jax_ssim.ssim, ssim.ssim, a, b)
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL)


@pytest.mark.parametrize("product", [True, False])
@pytest.mark.parametrize("size, scales", [(16, 1), (48, 3), (176, 5)])
def test_ms_ssim_matches_jax(size, scales, product):
    a, b = pair(size + 1, size, batch=1)
    got, want = both(jax_ssim.ms_ssim, ssim.ms_ssim, a, b, product=product)
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL)
    # the scale count the size gives: one more downsample would go below 11
    assert (size >> (scales - 1)) >= 11 and (scales == 5 or (size >> scales) < 11)


def test_ms_ssim_too_small_raises():
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="too small"):
        ssim.ms_ssim(x, x)


def test_loss_table_matches_jax():
    assert list(losses._LOSSES) == list(jax_losses._LOSSES)


@pytest.mark.parametrize("name", sorted(losses._LOSSES))
def test_losses_match_jax(name):
    a, b = pair(7, 48)
    got, want = both(jax_losses.get_loss_function(name), losses.get_loss_function(name), a, b)
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL)


def test_l1_msssim_grad_matches_jax():
    a, b = pair(3, 48)
    want = np.asarray(jax.grad(jax_losses.l1_msssim_loss)(jnp.asarray(a), jnp.asarray(b)))
    pred = torch.from_numpy(a).requires_grad_(True)
    losses.l1_msssim_loss(pred, torch.from_numpy(b)).backward()
    np.testing.assert_allclose(pred.grad.numpy(), want, atol=GRAD_ATOL, rtol=0)


def test_msssim_bounded_on_near_constant_tiles_torch():
    """The clamps to the PSD cone keep MS-SSIM (sum form) at or below 1 and
    the default loss non-negative on near-constant tiles (the JAX test of
    the same name)."""
    rng = np.random.default_rng(5)
    flat = 0.9 + 1e-4 * rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    flat2 = 0.9 + 1e-4 * rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    for a, b in ((flat, flat2), (flat, flat), (flat, np.zeros_like(flat))):
        v = float(ssim.ms_ssim(torch.from_numpy(a), torch.from_numpy(b), product=False))
        assert v <= 1.0 + 1e-5, v
    loss = losses.get_loss_function("l1_msssim")
    assert float(loss(torch.from_numpy(flat), torch.from_numpy(flat2))) >= -1e-5


def test_losses_zero_at_identity_torch():
    x = torch.from_numpy(np.random.default_rng(2).random((1, 48, 48, 3), np.float32)) * 0.8 + 0.1
    for name in ("l1", "l2", "mape", "smape", "l1_grad"):
        assert float(losses.get_loss_function(name)(x, x)) < 1e-6, name
    assert float(losses.get_loss_function("l1_msssim")(x, x)) < 1e-3


def test_invalid_loss_torch():
    with pytest.raises(ValueError, match="invalid loss function 'bogus'"):
        losses.get_loss_function("bogus")
