"""Train a denoiser weight slot on .npy training pairs and export it to TZA.

Usage:
    python -m mygpuraytracer_tpu_torch.apps.train_denoiser [weights_name] [data_dir] [epochs]
        [max_lr] [loss] [--device cuda|cpu] [--out PATH.tza] [--result-dir DIR]

The counterpart of ``scripts/train_denoiser.py``: the same positional
arguments and defaults (rt_ldr_alb, data/denoise, 200 epochs, 2e-4,
l1_msssim), the same per-slot transfer table and the same ``TrainConfig``
(16 steps of batch 8 per epoch, 128^2 tiles, float32, a checkpoint every
25 epochs), trained by the host-fed ``train()``. ``--out`` (default
``weights/<name>.tza``, where the filter's weights search finds it) and
``--result-dir`` (default ``results/<name>``, checkpoints and log.jsonl)
say where it writes; ``--device`` where it trains (default cuda).
"""

from __future__ import annotations

import argparse
import os
import sys


def slot_transfer(name: str) -> tuple[str, bool, bool]:
    """(transfer, hdr, snorm) of a weight slot, as the runtime packs its
    inputs (RTFilter/RTLightmapFilter getTransferFunc and snorm rules,
    core/unet.cpp:613-621,693-763)."""
    if name.startswith("rtlightmap"):
        return "log", True, False
    if name == "rt_nrm":
        return "linear", False, True
    if name == "rt_alb":
        return "srgb", False, False
    return ("pu" if "hdr" in name else "srgb"), "hdr" in name, False


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train a denoiser weight slot and export it to .tza")
    p.add_argument("name", nargs="?", default="rt_ldr_alb",
                   help="weight slot: rt_ldr_alb (color + albedo) | rt_ldr (color) | ...")
    p.add_argument("data_dir", nargs="?", default="data/denoise")
    p.add_argument("epochs", nargs="?", type=int, default=200)
    p.add_argument("max_lr", nargs="?", type=float, default=2e-4)
    p.add_argument("loss", nargs="?", default="l1_msssim")
    p.add_argument("--device", default="cuda", help="torch device to train on (default cuda)")
    p.add_argument("--out", help="the .tza to write (default weights/<name>.tza)")
    p.add_argument("--result-dir", help="checkpoints and log.jsonl (default results/<name>)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..denoise.weights import WEIGHTS_CHANNELS
    from ..train.export import export_weights
    from ..train.train import TrainConfig, train

    transfer, hdr, snorm = slot_transfer(args.name)
    cfg = TrainConfig(
        data_dir=args.data_dir,
        result_dir=args.result_dir or f"results/{args.name}",
        in_channels=WEIGHTS_CHANNELS[args.name],
        loss=args.loss,
        num_epochs=args.epochs,
        steps_per_epoch=16,
        batch_size=8,
        tile_size=128,
        max_lr=args.max_lr,
        precision="float32",
        save_epochs=25,
        transfer=transfer,
        hdr=hdr,
        snorm=snorm,
    )
    params = train(cfg, device=args.device, log_fn=lambda rec: print(
        f"epoch {rec['epoch']}: loss {rec['loss']:.4f} "
        f"lr {rec['lr']:.2e} {rec['images_per_sec']:.1f} img/s", flush=True))

    out = args.out or f"weights/{args.name}.tza"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    export_weights(params, out)
    print(f"exported {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
