"""The trainer on the card against the CPU.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py
Without a CUDA device every case skips.

Tolerances: one ``float32`` step (TF32 off, ``exact_float32``) on the card
against the same step on the CPU, loss rtol 1e-4 (summation order only);
after the update the params within 2 x the step's learning rate (Adam
turns a near-zero gradient into +-lr). One ``mixed`` step: a finite loss,
float32 master weights and float32 gradients reaching Adam.
"""

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.denoise.unet import params_from_jax, params_to_jax
from mygpuraytracer_tpu_torch.train.train import (Optimizer, TrainConfig, build_train_step,
                                                  crop_batch, draw_crops, init_params,
                                                  onecycle_schedule)
from mygpuraytracer_tpu_torch.ops import rng

LOSS_RTOL = 1e-4

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trainer's card path")
    return torch.device("cuda")


def _step(cfg, device, x, y, params):
    net = params_from_jax(params).to(device)
    opt = Optimizer(net, onecycle_schedule(16, cfg.max_lr, cfg.warmup_pct))
    step_fn, _ = build_train_step(cfg, opt)
    loss = step_fn(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    grads = [p.grad for p in opt.params]
    return float(loss), params_to_jax(net), grads, opt


def _batch(seed=0, n=4, size=64):
    g = np.random.default_rng(seed)
    return g.random((n, size, size, 6), np.float32), g.random((n, size, size, 3), np.float32)


def test_float32_step_card_matches_cpu(cuda):
    x, y = _batch()
    params = init_params(6, seed=1)
    cfg = TrainConfig(precision="float32", batch_size=4, tile_size=64)
    loss_c, after_c, _, opt = _step(cfg, cuda, x, y, params)
    loss_h, after_h, _, _ = _step(cfg, "cpu", x, y, params)
    assert loss_c == pytest.approx(loss_h, rel=LOSS_RTOL)
    lr = opt.schedule(0)
    for k in after_h:
        for w in ("w", "b"):
            assert np.abs(after_c[k][w] - after_h[k][w]).max() <= 2 * lr


def test_mixed_step_on_card(cuda):
    x, y = _batch(1)
    cfg = TrainConfig(precision="mixed", batch_size=4, tile_size=64)
    loss, after, grads, opt = _step(cfg, cuda, x, y, init_params(6, seed=2))
    assert np.isfinite(loss)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    assert all(p.dtype == torch.float32 for p in opt.params)


def test_crops_on_card_equal_cpu(cuda):
    g = np.random.default_rng(3)
    imgs = torch.from_numpy(g.random((3, 80, 72, 6), np.float32))
    crops = draw_crops(rng.make_key(5), 2, 4, 3, 80 - 32 + 1, 72 - 32 + 1)
    for s in range(2):
        want = crop_batch(imgs, crops[s], 32)
        got = crop_batch(imgs.to(cuda), crops[s].to(cuda), 32)
        assert torch.equal(got.cpu(), want)
