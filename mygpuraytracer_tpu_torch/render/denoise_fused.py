"""Render -> denoise on the device, straight off the accumulators.

Counterpart of ``mygpuraytracer_tpu/render/denoise_fused.py``: normalization,
input packing (transfer + sanitize), the U-Net and output unpacking run on
the accumulators' device; the AOVs never go to the host. Semantics = the
app's CPUdenoise: RT filter, LDR color (beauty / iteration) + albedo
(main.cpp:193-203 -> rt_ldr_alb weights), with the 9-channel ``*_nrm`` and
the HDR (autoexposure + PU) packings as options.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..denoise import color as color_mod
from ..denoise import weights as weights_mod
from ..denoise.unet import UNET_ALIGNMENT, UNet, net_dtype, no_tf32, round_up
from ..utils.profiling import named_scope


def denoise_accumulator(
    image: torch.Tensor, albedo: torch.Tensor, iteration: int, net: UNet,
    resolution: tuple[int, int], normal: torch.Tensor | None = None,
    hdr: bool = False, dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Normalize + pack + U-Net + unpack on ``image``'s device.

    image/albedo (and optionally normal): [3, N] accumulator rows; returns
    the denoised [H, W, 3] float32. The net runs in ``dtype``, by default
    :func:`net_dtype` of the device (bfloat16 on CUDA, float32 on CPU);
    float32 runs without TF32.
    """
    w, h = resolution
    hp, wp = round_up(h, UNET_ALIGNMENT), round_up(w, UNET_ALIGNMENT)
    inv_iter = float(np.float32(1.0) / np.float32(max(iteration, 1)))
    dev = image.device

    def plane(v: torch.Tensor, scale: float) -> torch.Tensor:
        out = torch.zeros((hp, wp, 3), dtype=torch.float32, device=dev)
        out[:h, :w] = v.reshape(3, h, w).permute(1, 2, 0) * scale
        return out

    color = plane(image, inv_iter)
    alb = plane(albedo, 1.0)

    # input_reorder.ispc: color scaled + sanitized + transferred; albedo
    # clamped only; normal snorm [-1,1] -> [0,1].
    if hdr:
        in_scale = color_mod.autoexposure(color[:h, :w])
        color = color_mod.pu_forward(color_mod.sanitize(color * in_scale, 0.0, float("inf")))
    else:
        color = color_mod.srgb_forward(color_mod.sanitize(color, 0.0, 1.0))
    chans = [color, color_mod.sanitize(alb, 0.0, 1.0)]
    if normal is not None:
        # captured at iteration 1 like the albedo: no 1/iteration scaling
        chans.append(color_mod.sanitize(plane(normal, 1.0), -1.0, 1.0) * 0.5 + 0.5)

    dtype = dtype or net_dtype(dev)
    if any(p.dtype != dtype or p.device != dev for p in net.parameters()):
        with named_scope("mygpurt.denoise.cast"):
            net = copy.deepcopy(net).to(device=dev, dtype=dtype)
    x = torch.cat(chans, dim=-1).permute(2, 0, 1)[None].to(dtype)
    with torch.inference_mode(), no_tf32():
        y = net(x)[0].permute(1, 2, 0).float()

    # output_reorder.ispc: sanitize, inverse transfer, then LDR clamp or
    # HDR un-exposure (output_scale = 1/input_scale).
    y = color_mod.sanitize(y, 0.0, float("inf"))
    if hdr:
        y = color_mod.pu_inverse(y) / in_scale
    else:
        y = torch.clamp_max(color_mod.srgb_inverse(y), 1.0)
    return y[:h, :w]


def load_denoiser(name: str = "rt_ldr_alb", device="cuda") -> tuple[UNet, bool]:
    """Returns (float32 net on ``device``, using_random_weights)."""
    tensors, random_init = weights_mod.load_default_params(name)
    with named_scope("mygpurt.denoise.build"):
        net = UNet.from_tza(tensors).to(device)
    return net, random_init
