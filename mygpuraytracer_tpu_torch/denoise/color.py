"""Transfer functions, sanitization and autoexposure for the denoiser.

Torch counterparts of ``mygpuraytracer_tpu/denoise/color.py`` (core/color.ispc:
linear, sRGB, PU and Log transfers with HDR normalization, and the transfer
objects the Filter API scales its inputs and outputs with; core/color.cpp:33-84:
autoexposure as a 16x-downsampled log2-mean of luminance with key 0.18).
Constants are the published PU2-fit values [Aydin et al. 2008].
"""

from __future__ import annotations

import math

import torch

HDR_Y_MAX = 65504.0  # maximum HDR value (half max)

SRGB_A = 12.92
SRGB_B = 1.055
SRGB_C = 1.0 / 2.4
SRGB_D = -0.055
SRGB_Y0 = 0.0031308
SRGB_X0 = 0.04045

PU_A = 1.41283765e03
PU_B = 1.64593172e00
PU_C = 4.31384981e-01
PU_D = -2.94139609e-03
PU_E = 1.92653254e-01
PU_F = 6.26026094e-03
PU_G = 9.98620152e-01
PU_Y0 = 1.57945760e-06
PU_Y1 = 3.22087631e-02
PU_X0 = 2.23151711e-03
PU_X1 = 3.70974749e-01

_PU_NORM = 1.0 / (PU_E * math.log(HDR_Y_MAX + PU_F) + PU_G)
_LOG_NORM = 1.0 / math.log(HDR_Y_MAX + 1.0)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    """NaN -> 0 (color.isph nan_to_zero); Inf survives for clamping."""
    return torch.where(torch.isnan(x), 0.0, x)


def sanitize(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(nan_to_zero(x), lo, hi)


def srgb_forward(y):
    return torch.where(
        y <= SRGB_Y0, SRGB_A * y,
        SRGB_B * torch.pow(torch.clamp_min(y, 1e-38), SRGB_C) + SRGB_D)


def srgb_inverse(x):
    return torch.where(
        x <= SRGB_X0, x / SRGB_A,
        torch.pow(torch.clamp_min((x - SRGB_D) / SRGB_B, 1e-38), 2.4))


def pu_forward(y):
    """PU transfer, normalized so that HDR_Y_MAX maps to 1."""
    y_safe = torch.clamp_min(y, 1e-38)
    raw = torch.where(
        y <= PU_Y0, PU_A * y,
        torch.where(y <= PU_Y1, PU_B * torch.pow(y_safe, PU_C) + PU_D,
                    PU_E * torch.log(y + PU_F) + PU_G))
    return raw * _PU_NORM


def pu_inverse(x):
    x = x / _PU_NORM
    return torch.where(
        x <= PU_X0, x / PU_A,
        torch.where(x <= PU_X1,
                    torch.pow(torch.clamp_min((x - PU_D) / PU_B, 1e-38), 1.0 / PU_C),
                    torch.exp((x - PU_G) / PU_E) - PU_F))


class TransferFunction:
    """Forward/inverse transfer with input/output scaling (core/color.h).

    ``input_scale`` is the autoexposure (or the user's inputScale), a float
    or a 0-d tensor; ``output_scale`` is its reciprocal, applied after the
    inverse transfer.
    """

    kind = "linear"

    def __init__(self, input_scale=1.0):
        self.input_scale = input_scale

    @property
    def output_scale(self):
        return 1.0 / self.input_scale

    def forward(self, y):
        return y

    def inverse(self, x):
        return x


class SRGBTransfer(TransferFunction):
    kind = "srgb"

    def forward(self, y):
        return srgb_forward(y)

    def inverse(self, x):
        return srgb_inverse(x)


class PUTransfer(TransferFunction):
    kind = "pu"

    def forward(self, y):
        return pu_forward(y)

    def inverse(self, x):
        return pu_inverse(x)


class LogTransfer(TransferFunction):
    """log(y + 1), normalized so that HDR_Y_MAX maps to 1 (RTLightmap's hdr)."""

    kind = "log"

    def forward(self, y):
        return torch.log(y + 1.0) * _LOG_NORM

    def inverse(self, x):
        return torch.exp(x / _LOG_NORM) - 1.0


def make_transfer(kind: str, input_scale=1.0) -> TransferFunction:
    cls = {
        "linear": TransferFunction,
        "srgb": SRGBTransfer,
        "pu": PUTransfer,
        "log": LogTransfer,
    }[kind]
    return cls(input_scale)


def autoexposure(image: torch.Tensor, key: float = 0.18, k: int = 16,
                 eps: float = 1e-8) -> torch.Tensor:
    """input_scale = key / 2^mean(log2 L) over a KxK-downsampled luminance
    map of the [..., H, W, 3] ``image``: one scale per image of the leading
    axes (0-d for one HxWx3 image), on the image's device."""
    h, w = image.shape[-3], image.shape[-2]
    lead = image.shape[:-3]
    L = luminance(sanitize(image, 0.0, math.inf))
    hk = max((h + k // 2) // k, 1)
    wk = max((w + k // 2) // k, 1)
    ph, pw = hk * ((h + hk - 1) // hk), wk * ((w + wk - 1) // wk)
    Lp = torch.zeros((*lead, ph, pw), dtype=L.dtype, device=L.device)
    Lp[..., :h, :w] = L
    cnt = torch.zeros((ph, pw), dtype=L.dtype, device=L.device)
    cnt[:h, :w] = 1.0
    bh, bw = ph // hk, pw // wk
    Ld = Lp.reshape(*lead, hk, bh, wk, bw).sum(dim=(-3, -1))
    Cd = cnt.reshape(hk, bh, wk, bw).sum(dim=(1, 3))
    Ld = Ld / torch.clamp_min(Cd, 1.0)

    mask = Ld > eps
    num = torch.where(mask, torch.log2(torch.clamp_min(Ld, eps)), 0.0).sum(dim=(-2, -1))
    den = mask.sum(dim=(-2, -1))
    mean_log = num / torch.clamp_min(den, 1)
    scale = key / torch.exp2(mean_log)
    return torch.where(den == 0, 1.0, scale)
