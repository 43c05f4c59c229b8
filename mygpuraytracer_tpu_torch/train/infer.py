"""Inference and image metrics for trained denoisers.

The port of ``mygpuraytracer_tpu/train/infer.py``: the Infer class
(training/infer.py:19-99: transfer -> pad to 16 -> model -> unpad -> clamp
-> inverse) and the metrics of training/image.py:41-57 (MSE, RMSE, PSNR,
SSIM). The net and SSIM run in full float32 (``train.exact_float32``: no
TF32 on the card, the native convolutions on the CPU), as the JAX Infer
runs them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..denoise import color
from ..denoise.unet import UNET_ALIGNMENT, params_from_jax, round_up, unet_apply
from .ssim import ssim as ssim_fn
from .train import exact_float32


class Infer:
    """Apply a trained U-Net (``{name: {'w': HWIO, 'b'}}`` params) to full
    HWC numpy images.

    Channels as the trainer packs them (the runtime's input_reorder.ispc):
    [:3] color (transfer applied), [3:6] albedo (clamped to [0, 1]), [6:9]
    normal (snorm-shifted [-1, 1] -> [0, 1]). ``snorm`` switches the whole
    net to the signed-normalized convention (the rt_nrm prefilter).

    ``aux_infers``: an optional {'albedo': Infer, 'normal': Infer} prefilter
    chain (training/infer.py:46-52,71-78): the aux channels are denoised by
    their own nets before the main net runs, as the cleanAux weights expect.
    """

    def __init__(self, params: dict, transfer: str = "srgb", hdr: bool = False,
                 snorm: bool = False, aux_infers: dict | None = None, device="cuda"):
        self.device = torch.device(device)
        self.net = params_from_jax(params).to(self.device)
        self.transfer = color.make_transfer(transfer)
        self.hdr = hdr
        self.snorm = snorm
        self.aux_infers = aux_infers or {}

    def __call__(self, image: np.ndarray) -> np.ndarray:
        h, w, c = image.shape

        if self.aux_infers and c >= 6:
            image = np.array(image, np.float32, copy=True)
            if "albedo" in self.aux_infers:
                image[..., 3:6] = self.aux_infers["albedo"](image[..., 3:6])
            if "normal" in self.aux_infers and c >= 9:
                image[..., 6:9] = self.aux_infers["normal"](image[..., 6:9])

        hp, wp = round_up(h, UNET_ALIGNMENT), round_up(w, UNET_ALIGNMENT)
        x = torch.zeros((hp, wp, c), dtype=torch.float32, device=self.device)
        x[:h, :w] = torch.from_numpy(np.asarray(image, np.float32)).to(self.device)

        if self.snorm:
            x = color.sanitize(x[..., :3], -1.0, 1.0) * 0.5 + 0.5
        else:
            col = color.sanitize(x[..., :3], 0.0, math.inf if self.hdr else 1.0)
            parts = [self.transfer.forward(col * self.transfer.input_scale)]
            if c >= 6:
                parts.append(color.sanitize(x[..., 3:6], 0.0, 1.0))
            if c >= 9:
                parts.append(color.sanitize(x[..., 6:9], -1.0, 1.0) * 0.5 + 0.5)
            x = torch.cat(parts, dim=-1)

        with exact_float32():
            y = unet_apply(self.net, x[None])[0]

        if self.snorm:
            y = torch.clamp(y, 0.0, 1.0) * 2.0 - 1.0
        else:
            y = color.sanitize(y, 0.0, math.inf)
            y = self.transfer.inverse(y) * self.transfer.output_scale
            if not self.hdr:
                y = torch.clamp_max(y, 1.0)
        return y[:h, :w].cpu().numpy()


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(mse(a, b)))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def ssim(a: np.ndarray, b: np.ndarray, device="cuda") -> float:
    """Mean SSIM of two HWC images (float32, TF32 off)."""
    a4 = torch.from_numpy(np.asarray(a, np.float32))[None].to(device)
    b4 = torch.from_numpy(np.asarray(b, np.float32))[None].to(device)
    with torch.no_grad(), exact_float32():
        return float(ssim_fn(a4, b4))


METRICS = {"mse": mse, "rmse": rmse, "psnr": psnr, "ssim": ssim}
