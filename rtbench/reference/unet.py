"""The plain reference denoiser: OIDN 1.4's "RT" filter with the LDR color
and albedo inputs (weights ``rt_ldr_alb``), read from its TZA file here.

- TZA 2.x: u16 magic 0x41D7, u8 major 2, u8 minor, u64 table offset; the
  table: u32 count, then per tensor u16 name length + name, u8 rank, u32
  dims, one layout letter per dim, one dtype letter, u64 offset.
- input: color sanitized to [0, 1] then the sRGB curve; albedo sanitized to
  [0, 1]; 6 channels, the image padded with zeros to a multiple of 16.
- the U-Net: 3x3 convs (padding 1) with ReLU, 2x2 max pools, x2 nearest
  upsampling, skip concatenations (the input too); channels 32, 32, 48, 64,
  80, 96, 96 down and 112, 112, 96, 96, 64, 64, 64, 32, 3 up.
- output: sanitized to [0, inf), the inverse sRGB curve, clamped to 1.

``run`` computes in float32 with TF32 off (the reference), or with every
conv's input and weights rounded to ``quantize``: the control's "fp8"
rounds each to float8 e4m3 under a per-tensor scale (amax / 448).
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np
import torch
import torch.nn.functional as F

SRGB = dict(a=12.92, b=1.055, c=1.0 / 2.4, d=-0.055, y0=0.0031308, x0=0.04045)
FP8_MAX = 448.0


def read_tza(path: str) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        buf = f.read()
    magic, major, _, table = struct.unpack_from("<HBBQ", buf, 0)
    if magic != 0x41D7 or major != 2:
        raise ValueError(f"{path} is not a version 2 tensor archive")
    (count,) = struct.unpack_from("<I", buf, table)
    pos = table + 4
    out = {}
    kinds = {"f": np.float32, "h": np.float16}
    for _ in range(count):
        (nlen,) = struct.unpack_from("<H", buf, pos)
        name = buf[pos + 2:pos + 2 + nlen].decode()
        pos += 2 + nlen
        (rank,) = struct.unpack_from("<B", buf, pos)
        dims = struct.unpack_from(f"<{rank}I", buf, pos + 1)
        pos += 1 + 4 * rank + rank  # dims, then the layout letters
        kind = buf[pos:pos + 1].decode()
        (offset,) = struct.unpack_from("<Q", buf, pos + 1)
        pos += 9
        n = int(np.prod(dims)) if dims else 1
        out[name] = np.frombuffer(buf, kinds[kind], n, offset).reshape(dims).astype(np.float32)
    return out


@contextlib.contextmanager
def exact_float32():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    s = torch.clamp_min(x.abs().amax(), 1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class UNet:
    def __init__(self, tensors: dict, device, quantize=None):
        self.w = {k: torch.as_tensor(v, device=device) for k, v in tensors.items()}
        self.q = quantize or (lambda x: x)

    def conv(self, name, x, relu=True):
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        y = F.conv2d(self.q(x), self.q(w), b, padding=1)
        return F.relu(y) if relu else y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        pool = lambda t: F.max_pool2d(t, 2)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        inp = x
        x = p1 = pool(c("enc_conv1", c("enc_conv0", x)))
        x = p2 = pool(c("enc_conv2", x))
        x = p3 = pool(c("enc_conv3", x))
        x = pool(c("enc_conv4", x))
        x = c("enc_conv5b", c("enc_conv5a", x))
        x = c("dec_conv4b", c("dec_conv4a", torch.cat([up(x), p3], 1)))
        x = c("dec_conv3b", c("dec_conv3a", torch.cat([up(x), p2], 1)))
        x = c("dec_conv2b", c("dec_conv2a", torch.cat([up(x), p1], 1)))
        x = c("dec_conv1b", c("dec_conv1a", torch.cat([up(x), inp], 1)))
        return c("dec_conv0", x, relu=False)


def _clean(x, lo, hi):
    return torch.clamp(torch.where(torch.isnan(x), 0.0, x), lo, hi)


def srgb_forward(y):
    return torch.where(y <= SRGB["y0"], SRGB["a"] * y,
                       SRGB["b"] * torch.pow(torch.clamp_min(y, 1e-38), SRGB["c"]) + SRGB["d"])


def srgb_inverse(x):
    return torch.where(x <= SRGB["x0"], x / SRGB["a"],
                       torch.pow(torch.clamp_min((x - SRGB["d"]) / SRGB["b"], 1e-38), 2.4))


def denoise(net: UNet, color: np.ndarray, albedo: np.ndarray, device) -> np.ndarray:
    """The RT filter on an HxWx3 LDR color and albedo: HxWx3 float32."""
    h, w = color.shape[:2]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    x = torch.zeros((1, 6, hp, wp), dtype=torch.float32, device=device)
    c = torch.as_tensor(np.ascontiguousarray(color, np.float32), device=device)
    a = torch.as_tensor(np.ascontiguousarray(albedo, np.float32), device=device)
    x[0, 0:3, :h, :w] = srgb_forward(_clean(c, 0.0, 1.0)).permute(2, 0, 1)
    x[0, 3:6, :h, :w] = _clean(a, 0.0, 1.0).permute(2, 0, 1)
    with torch.no_grad(), exact_float32():
        y = net(x)[0, :, :h, :w].permute(1, 2, 0)
    y = torch.clamp_max(srgb_inverse(_clean(y, 0.0, float("inf"))), 1.0)
    return y.cpu().numpy()
