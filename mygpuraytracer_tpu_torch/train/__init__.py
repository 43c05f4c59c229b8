"""The denoiser's training toolkit (the port of ``mygpuraytracer_tpu/train``):
losses and MS-SSIM, tile datasets and rendered training pairs, the host-fed
and device-resident trainers, export to .tza, Infer and the LR range test."""

from .losses import get_loss_function
from .train import TrainConfig, train
