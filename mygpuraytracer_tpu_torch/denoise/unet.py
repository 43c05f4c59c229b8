"""The OIDN U-Net as a torch ``nn.Module``.

Topology of ``mygpuraytracer_tpu/denoise/unet.py`` (training/model.py:48-133,
core/unet.cpp:356-590): 3x3 convs stride 1 pad 1 with fused ReLU, 2x2 max
pools, x2 nearest upsamples, skip concats including the input image,
channels 32/48/64/80/96 -> 112/96/64/64/32 -> out.

The JAX U-Net has no Pallas kernel (its convs are XLA's), so the convs here
are ``torch.nn.functional.conv2d`` (cuDNN on the card). Weights stay in the
TZA archives' OIHW layout; the module takes NCHW input, and
:func:`unet_apply` takes the JAX package's NHWC.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

UNET_ALIGNMENT = 16  # images padded to multiples of this (model.py:85, unet.h:22)
UNET_RECEPTIVE_FIELD = 174  # unet.h:21 (defines the tiling overlap)

_EC1, _EC2, _EC3, _EC4, _EC5 = 32, 48, 64, 80, 96
_DC4, _DC3, _DC2, _DC1A, _DC1B = 112, 96, 64, 64, 32


def conv_specs(in_channels: int, out_channels: int = 3):
    """[(name, cin, cout)] for every conv in the network."""
    ic = in_channels
    return [
        ("enc_conv0", ic, _EC1),
        ("enc_conv1", _EC1, _EC1),
        ("enc_conv2", _EC1, _EC2),
        ("enc_conv3", _EC2, _EC3),
        ("enc_conv4", _EC3, _EC4),
        ("enc_conv5a", _EC4, _EC5),
        ("enc_conv5b", _EC5, _EC5),
        ("dec_conv4a", _EC5 + _EC3, _DC4),
        ("dec_conv4b", _DC4, _DC4),
        ("dec_conv3a", _DC4 + _EC2, _DC3),
        ("dec_conv3b", _DC3, _DC3),
        ("dec_conv2a", _DC3 + _EC1, _DC2),
        ("dec_conv2b", _DC2, _DC2),
        ("dec_conv1a", _DC2 + ic, _DC1A),
        ("dec_conv1b", _DC1A, _DC1B),
        ("dec_conv0", _DC1B, out_channels),
    ]


class UNet(nn.Module):
    """The denoising U-Net; ``forward`` takes NCHW with H, W multiples of 16."""

    def __init__(self, in_channels: int, out_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.convs = nn.ModuleDict({
            name: nn.Conv2d(cin, cout, 3, padding=1)
            for name, cin, cout in conv_specs(in_channels, out_channels)
        })

    def _conv(self, name: str, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        # JAX's _conv_relu: the weights and the bias take the activations'
        # dtype (bf16 under "mixed", over float32 master weights), and ReLU
        # runs in it. Under autograd it is max(y, 0), whose gradient splits
        # in half where y is exactly 0, as jnp.maximum's does (F.relu's is 0
        # there; zero biases over dead inputs make such ties common in
        # training); without autograd F.relu gives the same values.
        conv = self.convs[name]
        y = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1)
        if not relu:
            return y
        return torch.maximum(y, y.new_zeros(())) if y.requires_grad else F.relu(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % UNET_ALIGNMENT or x.shape[3] % UNET_ALIGNMENT:
            raise ValueError(f"input H/W must be multiples of {UNET_ALIGNMENT}, got {tuple(x.shape)}")
        c = self._conv
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        inp = x
        x = c("enc_conv1", c("enc_conv0", x))
        x = pool1 = F.max_pool2d(x, 2)
        x = pool2 = F.max_pool2d(c("enc_conv2", x), 2)
        x = pool3 = F.max_pool2d(c("enc_conv3", x), 2)
        x = F.max_pool2d(c("enc_conv4", x), 2)
        x = c("enc_conv5b", c("enc_conv5a", x))
        x = c("dec_conv4b", c("dec_conv4a", torch.cat([up(x), pool3], 1)))
        x = c("dec_conv3b", c("dec_conv3a", torch.cat([up(x), pool2], 1)))
        x = c("dec_conv2b", c("dec_conv2a", torch.cat([up(x), pool1], 1)))
        x = c("dec_conv1b", c("dec_conv1a", torch.cat([up(x), inp], 1)))
        return c("dec_conv0", x, relu=False)

    @classmethod
    def from_tza(cls, tensors: dict) -> "UNet":
        """Build from ``{name: (array, layout)}``: 'oihw' conv weights and
        'x' biases, as ``denoise/tza.py`` reads them."""
        w0, layout = tensors["enc_conv0.weight"]
        out_ch = tensors["dec_conv0.weight"][0].shape[0]
        net = cls(int(w0.shape[1]), int(out_ch))
        state = {}
        for key, (arr, layout) in tensors.items():
            if key.endswith(".weight") and layout != "oihw":
                raise ValueError(f"unexpected weight layout {layout} for {key}")
            state[f"convs.{key}"] = torch.tensor(np.asarray(arr), dtype=torch.float32)
        net.load_state_dict(state)
        return net


def params_from_jax(params: dict) -> UNet:
    """The port's module from the JAX package's parameter dict
    ``{name: {'w': HWIO, 'b': [O]}}`` (arrays of any array type)."""
    tensors = {}
    for name, p in params.items():
        tensors[f"{name}.weight"] = (np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1)), "oihw")
        tensors[f"{name}.bias"] = (np.asarray(p["b"], np.float32), "x")
    return UNet.from_tza(tensors)


def jax_tree(net: UNet, of=lambda p: p) -> dict:
    """``of(parameter)`` for every conv's weight and bias in the JAX
    package's layout ``{name: {'w': HWIO, 'b': [O]}}``, as float32 numpy
    arrays (the trainer also lays out Adam's moments this way)."""
    tree = {}
    for name, conv in net.convs.items():
        w = of(conv.weight).detach().float().cpu().numpy()
        tree[name] = {"w": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))),
                      "b": of(conv.bias).detach().float().cpu().numpy().copy()}
    return tree


def params_to_jax(net: UNet) -> dict:
    """The inverse of :func:`params_from_jax`: the JAX package's parameter
    dict ``{name: {'w': HWIO, 'b': [O]}}`` as float32 numpy arrays."""
    return jax_tree(net)


def init_unet_tensors(in_channels: int, out_channels: int = 3, seed: int = 0) -> dict:
    """He-initialized weights in TZA form, from a seeded ``torch.Generator``.
    The JAX package's ``init_unet_params`` draws its weights with
    ``jax.random.normal``, so the two inits differ; to start both from the
    same weights, export one and load it (``TrainConfig.init_from``)."""
    gen = torch.Generator().manual_seed(seed)
    tensors = {}
    for name, cin, cout in conv_specs(in_channels, out_channels):
        std = math.sqrt(2.0 / (9 * cin))
        w = torch.randn((cout, cin, 3, 3), generator=gen) * std
        tensors[f"{name}.weight"] = (w.numpy(), "oihw")
        tensors[f"{name}.bias"] = (np.zeros(cout, np.float32), "x")
    return tensors


def net_dtype(device) -> torch.dtype:
    """The net's number format: bfloat16 on the card, float32 on the CPU
    (the JAX package's choice: bf16 on an accelerator, f32 on the CPU)."""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and matmuls in full IEEE float32 (no TF32) on
    CUDA for the block; the previous settings come back after it."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def unet_apply(net: UNet, x: torch.Tensor) -> torch.Tensor:
    """Forward pass in the JAX package's layout: x [N, H, W, C] -> [N, H, W, 3]."""
    with torch.inference_mode(), no_tf32():
        return net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def unet_train_apply(net: UNet, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The training forward, with autograd: x [N, H, W, C] cast to ``dtype``
    (bfloat16 under "mixed"), the output [N, H, W, 3] back in float32, as
    the JAX trainer computes ``unet_apply(params, x.astype(dtype))``. The
    caller sets TF32 (:func:`no_tf32` around forward and backward)."""
    return net(x.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
