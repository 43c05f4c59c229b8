"""Training losses on NHWC tensors; each returns a 0-d tensor.

The port's counterpart of ``mygpuraytracer_tpu/train/losses.py``
(training/loss.py): L1, L2, MAPE, SMAPE, SSIM, MS-SSIM, the default mix
0.16 L1 + 0.84 (1 - MS-SSIM) [Zhao et al., "Loss functions for image
restoration with neural networks"], and L1 + forward-difference gradient.
"""

from __future__ import annotations

import torch

from .ssim import ms_ssim, ssim


def _abs(x):
    """|x| with jnp.abs's gradient: +1 at 0 (torch.abs's is 0 there). A
    prediction equal to its target (a black crop through zero biases) is
    common early in training."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred, target):
    return torch.mean(_abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def mape_loss(pred, target, eps: float = 1e-2):
    """Mean absolute percentage error (relative L1)."""
    return torch.mean(_abs(pred - target) / (_abs(target) + eps))


def smape_loss(pred, target, eps: float = 1e-2):
    """Symmetric MAPE."""
    return torch.mean(2.0 * _abs(pred - target) / (_abs(pred) + _abs(target) + eps))


def ssim_loss(pred, target):
    return 1.0 - ssim(pred, target)


def msssim_loss(pred, target):
    # The sum form: bounded gradients; the product form is the metric's.
    return 1.0 - ms_ssim(pred, target, product=False)


def l1_msssim_loss(pred, target, alpha: float = 0.16):
    """The default loss: 0.16 L1 + 0.84 (1 - MS-SSIM) (loss.py:28-29)."""
    return alpha * l1_loss(pred, target) + (1.0 - alpha) * msssim_loss(pred, target)


def _grad(x):
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    return dx, dy


def l1_grad_loss(pred, target, alpha: float = 0.5):
    """L1 + image-gradient L1 (training/loss.py's gradient variant)."""
    pdx, pdy = _grad(pred)
    tdx, tdy = _grad(target)
    g = 0.5 * (torch.mean(_abs(pdx - tdx)) + torch.mean(_abs(pdy - tdy)))
    return alpha * l1_loss(pred, target) + (1 - alpha) * g


_LOSSES = {
    "l1": l1_loss,
    "l2": l2_loss,
    "mape": mape_loss,
    "smape": smape_loss,
    "ssim": ssim_loss,
    "msssim": msssim_loss,
    "l1_msssim": l1_msssim_loss,
    "l1_grad": l1_grad_loss,
}


def get_loss_function(name: str = "l1_msssim"):
    """training/loss.py:13-33: the loss of that name, else ValueError."""
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(f"invalid loss function '{name}'") from None
