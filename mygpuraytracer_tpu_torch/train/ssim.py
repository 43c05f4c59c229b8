"""SSIM and MS-SSIM on NHWC tensors.

The port's counterpart of ``mygpuraytracer_tpu/train/ssim.py``: Wang et al.
2004 SSIM and Wang et al. 2003 MS-SSIM with the 11x11, sigma 1.5 Gaussian
window and the standard five power weights, as the reference trainer
computes them (training/ssim.py). The window is applied as a depthwise
convolution with VALID padding.

The variance estimators are catastrophic cancellations (E[x^2] - mu^2), so
the filters must run in full float32: TF32 (cuDNN's default on the card)
carries ~1e-3 relative error, which on low-contrast tiles dwarfs c2 = 9e-4
and drives sigma negative (the JAX package saw MS-SSIM "1.17" on hardware
with low-precision convs). Callers run them under
``denoise/unet.py::no_tf32``; the trainer runs its whole step under it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int = 11, sigma: float = 1.5, device="cpu") -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(xs**2) / (2 * sigma**2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _filter2d(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter of NHWC ``x`` with VALID padding."""
    c = x.shape[-1]
    w = window.expand(c, 1, *window.shape)
    return F.conv2d(x.permute(0, 3, 1, 2), w, groups=c).permute(0, 2, 3, 1)


def _ssim_parts(a, b, window, c1=0.01**2, c2=0.03**2):
    mu_a = _filter2d(a, window)
    mu_b = _filter2d(b, window)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    # The window's covariance matrix is PSD in exact arithmetic; rounding can
    # leave sigma slightly negative or sigma_ab past Cauchy-Schwarz on
    # near-constant windows, which lets cs exceed 1 (and the training loss
    # go negative). Clamp to the cone, with maximum/minimum as jnp.maximum
    # and jnp.clip do: at a tie (sigma exactly 0 on a constant window, as a
    # black crop gives) the gradient splits in half, where clamp's passes.
    zero = mu_a.new_zeros(())
    sig_a = torch.maximum(_filter2d(a * a, window) - mu_aa, zero)
    sig_b = torch.maximum(_filter2d(b * b, window) - mu_bb, zero)
    sig_ab = _filter2d(a * b, window) - mu_ab
    bound = torch.sqrt(sig_a * sig_b + 1e-20)
    sig_ab = torch.minimum(torch.maximum(sig_ab, -bound), bound)
    cs = (2 * sig_ab + c2) / (sig_a + sig_b + c2)
    ssim = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs
    return ssim, cs


def ssim_sum(a: torch.Tensor, b: torch.Tensor,
             window_size: int = 11) -> tuple[torch.Tensor, int]:
    """The sum behind :func:`ssim`'s mean and its element count."""
    window = _gaussian_window(window_size, device=a.device).to(a.dtype)
    s, _ = _ssim_parts(a, b, window)
    return torch.sum(s), s.numel()


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over NHWC batches (values assumed in [0, 1])."""
    total, count = ssim_sum(a, b, window_size)
    return total / count


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 box mean with stride 2 (VALID: an odd last row or column drops)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _ms_ssim_scales(h: int, w: int, window_size: int) -> np.ndarray:
    """The used scales' weights, renormalized: each scale needs H, W >= the
    window after the 2x downsamples before it."""
    n_scales = 0
    hh, ww = h, w
    while n_scales < len(_MSSSIM_WEIGHTS) and hh >= window_size and ww >= window_size:
        n_scales += 1
        hh //= 2
        ww //= 2
    if n_scales == 0:
        raise ValueError(f"input {h}x{w} too small for SSIM window {window_size}")
    weights = np.asarray(_MSSSIM_WEIGHTS[:n_scales])
    return weights / weights.sum()


def ms_ssim_sums(a: torch.Tensor, b: torch.Tensor,
                 window_size: int = 11) -> list[tuple[torch.Tensor, int]]:
    """The partial sums behind :func:`ms_ssim` on a batch or one shard of
    it: per scale, the sum of ``cs`` (the last scale: of ``ssim``) and its
    element count. Summed over the shards and divided, they give the whole
    batch's per-scale means, from which :func:`ms_ssim_from_means` forms
    MS-SSIM (the product form is not the mean of its shards' values)."""
    n_scales = len(_ms_ssim_scales(int(a.shape[1]), int(a.shape[2]), window_size))
    window = _gaussian_window(window_size, device=a.device).to(a.dtype)
    sums = []
    for i in range(n_scales):
        s, cs = _ssim_parts(a, b, window)
        v = s if i == n_scales - 1 else cs
        sums.append((torch.sum(v), v.numel()))
        if i != n_scales - 1:
            a = _downsample2(a)
            b = _downsample2(b)
    return sums


def ms_ssim_from_means(means, h: int, w: int, window_size: int = 11,
                       product: bool = True) -> torch.Tensor:
    """MS-SSIM of H x W inputs from the whole batch's per-scale means (of
    :func:`ms_ssim_sums`): the product of max(v, 1e-6)^w, or the weighted
    sum."""
    weights = _ms_ssim_scales(h, w, window_size)
    if len(means) != len(weights):
        raise ValueError(f"{h}x{w} takes {len(weights)} scales, got {len(means)} means")
    device = means[0].device
    if product:
        total = torch.ones((), device=device)
        for wgt, v in zip(weights, means):
            total = total * torch.pow(torch.clamp_min(v, 1e-6), float(wgt))
        return total
    total = torch.zeros((), device=device)
    for wgt, v in zip(weights, means):
        total = total + float(wgt) * v
    return total


def ms_ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11,
            product: bool = True) -> torch.Tensor:
    """Multi-scale SSIM with the standard 5-scale weights.

    The scale count follows the input size: each scale needs H, W >= the
    window after the 2x downsamples before it; the used scales' weights are
    renormalized to sum to 1. ``product`` selects the product form (the
    metric); the sum form has bounded gradients (the loss)."""
    means = [total / count for total, count in ms_ssim_sums(a, b, window_size)]
    return ms_ssim_from_means(means, int(a.shape[1]), int(a.shape[2]), window_size, product)
