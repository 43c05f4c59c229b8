"""One training step of the port against the JAX trainer's, on the CPU,
from the same JAX-made weights (``params_from_jax``) on one seeded batch.

Tolerances: ``float32`` loss rtol 1e-5 and every gradient within
1e-5 x the largest |gradient| of the net. Under ``l1_msssim`` JAX's float32
SSIM gradient lies 1.6e-5 x its largest value from float64 (the port's
1.0e-5 x; tests/test_torch_train_grad_parity.py), and the backward carries
that difference, so there the port's gradients are held within 1e-5 x of
the same step in float64 and within 2e-5 x of JAX's. ``mixed``
(bfloat16 activations on both sides, whose convolutions accumulate in other
orders) loss rtol 2e-2. The preprocess (all four packings) atol 1e-6; the per-crop
autoexposure rtol 1e-5; the per-example validation losses rtol 1e-5.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.denoise import color as jax_color
from mygpuraytracer_tpu.denoise.unet import init_unet_params, unet_apply as jax_unet_apply
from mygpuraytracer_tpu.train.losses import get_loss_function as jax_loss
from mygpuraytracer_tpu.train.train import TrainConfig as JaxTrainConfig
from mygpuraytracer_tpu.train.train import build_eval_step as jax_build_eval_step
from mygpuraytracer_tpu.train.train import make_preprocess as jax_make_preprocess

from mygpuraytracer_tpu_torch.denoise import color
from mygpuraytracer_tpu_torch.denoise.unet import jax_tree, params_from_jax
from mygpuraytracer_tpu_torch.train.losses import get_loss_function
from mygpuraytracer_tpu_torch.train.train import (TrainConfig, build_eval_step, exact_float32,
                                                  make_preprocess, unet_train_apply)

REPO = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
MSSSIM_GRAD_REL_JAX = 2e-5
MIXED_LOSS_RTOL = 2e-2
PREPROCESS_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def batch(seed, channels=6, size=32, n=2, hdr=False):
    g = np.random.default_rng(seed)
    scale = 8.0 if hdr else 1.2
    x = (g.random((n, size, size, channels), np.float32) * scale).astype(np.float32)
    x[..., 3:6] = g.random((n, size, size, 3), np.float32)
    if channels >= 9:
        x[..., 6:9] = g.random((n, size, size, 3), np.float32) * 2 - 1
    y = (g.random((n, size, size, 3), np.float32) * scale).astype(np.float32)
    return x, y


CONFIGS = {
    "ldr_srgb": dict(in_channels=6, transfer="srgb"),
    "hdr_pu": dict(in_channels=9, transfer="pu", hdr=True),
    "snorm": dict(in_channels=3, transfer="linear", snorm=True),
    "color_only": dict(in_channels=3, transfer="srgb"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_preprocess_matches_jax(name):
    kw = CONFIGS[name]
    x, y = batch(1, channels=max(kw["in_channels"], 6), hdr=kw.get("hdr", False))
    x = x[..., : kw["in_channels"]] if kw["in_channels"] < 6 else x
    x[0, 0, 0, 0] = np.nan  # sanitized to 0
    want = jax_make_preprocess(JaxTrainConfig(**kw))(jnp.asarray(x), jnp.asarray(y))
    got = make_preprocess(TrainConfig(**kw))(torch.from_numpy(x), torch.from_numpy(y))
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=PREPROCESS_ATOL, rtol=1e-6)


def test_batched_autoexposure_matches_vmap():
    g = np.random.default_rng(2)
    imgs = (g.random((3, 40, 56, 3), np.float32) * np.array([0.01, 1.0, 30.0])[:, None, None, None]
            ).astype(np.float32)
    imgs[1] = 0.0  # all dark: scale 1
    want = np.asarray(jax.vmap(jax_color.autoexposure)(jnp.asarray(imgs)))
    got = color.autoexposure(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    single = float(color.autoexposure(torch.from_numpy(imgs[2])))
    assert single == pytest.approx(float(got[2]), rel=1e-6)


def _jax_step(cfg, params, x, y):
    loss_fn = jax_loss(cfg.loss)
    dtype = jnp.bfloat16 if cfg.precision == "mixed" else jnp.float32
    pre = jax_make_preprocess(cfg)

    def value(p):
        xx, yy = pre(jnp.asarray(x), jnp.asarray(y))
        return loss_fn(jax_unet_apply(p, xx.astype(dtype)).astype(jnp.float32), yy)

    loss, grads = jax.jit(jax.value_and_grad(value))(params)
    return float(loss), jax.device_get(grads)


def _torch_step(cfg, params, x, y, float64=False):
    net = params_from_jax(jax.device_get(params))
    dtype = torch.bfloat16 if cfg.precision == "mixed" else torch.float32
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    if float64:
        net, x, y, dtype = net.double(), x.double(), y.double(), torch.float64
    with exact_float32():
        xx, yy = make_preprocess(cfg)(x, y)
        pred = unet_train_apply(net, xx, dtype).to(xx.dtype)
        loss = get_loss_function(cfg.loss)(pred, yy)
        loss.backward()
    grads = jax_tree(net, lambda p: p.grad)
    assert all(p.grad.dtype == (torch.float64 if float64 else torch.float32)
               for p in net.parameters())
    return float(loss.detach()), grads


@pytest.mark.parametrize("loss", ["l1_msssim", "l1"])
def test_float32_step_matches_jax(loss):
    x, y = batch(4)
    params = init_unet_params(6, seed=3)
    kw = dict(in_channels=6, loss=loss, precision="float32")
    want_loss, want_grads = _jax_step(JaxTrainConfig(**kw), params, x, y)
    got_loss, got_grads = _torch_step(TrainConfig(**kw), params, x, y)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    scale = max(float(np.abs(g).max()) for p in want_grads.values() for g in p.values())
    refs = [(want_grads, GRAD_REL)]
    if loss == "l1_msssim":
        exact = _torch_step(TrainConfig(**kw), params, x, y, float64=True)[1]
        refs = [(exact, GRAD_REL), (want_grads, MSSSIM_GRAD_REL_JAX)]
    for ref, rel in refs:
        for name in ref:
            for k in ("w", "b"):
                np.testing.assert_allclose(got_grads[name][k], ref[name][k], atol=rel * scale,
                                           rtol=0)


def test_float32_step_on_a_black_crop():
    """The host-fed trainer's first batch on data/denoise (seed 3, tiles of
    32): one crop all black. The port's float32 gradients stay within
    1e-5 x of float64; the JAX step's own do not (2.3e-3 x, measured when
    this test was written), so only the loss is held against JAX here."""
    from mygpuraytracer_tpu_torch.train.dataset import TileDataset

    x, y = TileDataset(str(REPO / "data" / "denoise"), 32, seed=3).sample_batch(2)
    assert x[0].max() == 0.0 and y[0].max() == 0.0
    params = init_unet_params(6, seed=11)
    kw = dict(in_channels=6, precision="float32")
    want_loss, _ = _jax_step(JaxTrainConfig(**kw), params, x, y)
    got_loss, got_grads = _torch_step(TrainConfig(**kw), params, x, y)
    exact = _torch_step(TrainConfig(**kw), params, x, y, float64=True)[1]
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    scale = max(float(np.abs(g).max()) for p in exact.values() for g in p.values())
    for name in exact:
        for k in ("w", "b"):
            np.testing.assert_allclose(got_grads[name][k], exact[name][k], atol=GRAD_REL * scale,
                                       rtol=0)


def test_mixed_step_matches_jax():
    x, y = batch(5)
    params = init_unet_params(6, seed=4)
    kw = dict(in_channels=6, precision="mixed")
    want_loss, _ = _jax_step(JaxTrainConfig(**kw), params, x, y)
    got_loss, got_grads = _torch_step(TrainConfig(**kw), params, x, y)
    assert got_loss == pytest.approx(want_loss, rel=MIXED_LOSS_RTOL)
    assert all(np.isfinite(g).all() for p in got_grads.values() for g in p.values())


def test_eval_step_matches_jax():
    x, y = batch(6, n=3)
    params = init_unet_params(6, seed=5)
    kw = dict(in_channels=6, precision="float32")
    want = np.asarray(jax_build_eval_step(JaxTrainConfig(**kw), None)(
        params, jnp.asarray(x), jnp.asarray(y)))
    got = build_eval_step(TrainConfig(**kw))(params_from_jax(jax.device_get(params)),
                                             torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_mesh_other_than_none_raises():
    """A mesh is a parallel.mesh.Mesh (tests/test_torch_train_mesh.py runs
    one); anything else that is not None raises."""
    from mygpuraytracer_tpu_torch.train.train import build_train_step, train

    with pytest.raises(TypeError, match="parallel.mesh.Mesh or None"):
        build_eval_step(TrainConfig(), mesh="dp")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh or None"):
        build_train_step(TrainConfig(), None, mesh=object())
    with pytest.raises(TypeError, match="parallel.mesh.Mesh or None"):
        train(TrainConfig(), mesh=1, device="cpu")
