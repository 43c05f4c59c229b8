"""Learning-rate range test (training/find_lr.py).

The port of ``mygpuraytracer_tpu/train/find_lr.py``: the LR sweeps
geometrically from min_lr to max_lr over num_steps of plain SGD (the JAX
function's ``optax.sgd(1.0)`` on grads scaled by the step's float32 lr),
recording the debiased smoothed loss per step; the usable band is where it
still falls. Like the JAX function: raw inputs (no preprocess), float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..denoise.unet import params_from_jax, unet_train_apply
from .dataset import TileDataset
from .losses import get_loss_function
from .train import exact_float32, init_params


def find_lr(
    data_dir: str,
    in_channels: int = 6,
    loss: str = "l1_msssim",
    min_lr: float = 1e-7,
    max_lr: float = 0.1,
    num_steps: int = 100,
    batch_size: int = 4,
    tile_size: int = 128,
    smoothing: float = 0.9,
    seed: int = 0,
    device="cuda",
):
    """Returns (lrs, smoothed_losses) arrays of length <= num_steps (stops
    early when the loss is not finite or the smoothed loss passes 4x its
    best, like the reference)."""
    dataset = TileDataset(data_dir, tile_size, seed=seed)
    net = params_from_jax(init_params(in_channels, seed)).to(device)
    params = list(net.parameters())
    loss_fn = get_loss_function(loss)

    out_lrs, out_losses = [], []
    avg = 0.0
    best = float("inf")
    for i, lr in enumerate(np.geomspace(min_lr, max_lr, num_steps)):
        x, y = (torch.from_numpy(a).to(device) for a in dataset.sample_batch(batch_size))
        with exact_float32():
            loss_t = loss_fn(unet_train_apply(net, x, torch.float32), y)
            grads = torch.autograd.grad(loss_t, params)
        with torch.no_grad():
            torch._foreach_mul_(grads, float(np.float32(lr)))
            torch._foreach_sub_(params, grads)
        loss_v = float(loss_t.detach())
        if not np.isfinite(loss_v):
            break
        avg = smoothing * avg + (1 - smoothing) * loss_v
        debiased = avg / (1 - smoothing ** (i + 1))
        out_lrs.append(float(lr))
        out_losses.append(debiased)
        best = min(best, debiased)
        if debiased > 4.0 * best:  # diverged
            break
    return np.asarray(out_lrs), np.asarray(out_losses)
