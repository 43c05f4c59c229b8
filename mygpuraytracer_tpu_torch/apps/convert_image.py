"""Image format conversion CLI (training/convert_image.py).

The port's counterpart of ``mygpuraytracer_tpu/apps/convert_image.py``.

Usage: python -m mygpuraytracer_tpu_torch.apps.convert_image IN OUT [--exposure E] [--srgb]
Supported: .pfm, .hdr, .exr, .npy (float) and .png/.ppm (LDR). ``--srgb``
encodes an LDR output through ``denoise/color.py`` (``sanitize`` to [0, 1],
then ``SRGBTransfer``), on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="convert image formats")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--exposure", type=float, default=1.0,
                   help="linear exposure multiplier applied before saving")
    p.add_argument("--srgb", action="store_true",
                   help="apply sRGB encode when writing an LDR format")
    args = p.parse_args(argv)

    from ..utils.image_io import load_image, save_image

    img = load_image(args.input) * args.exposure
    if args.srgb and args.output.lower().endswith((".png", ".ppm")):
        import torch

        from ..denoise.color import SRGBTransfer, sanitize

        t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        img = SRGBTransfer().forward(sanitize(t, 0.0, 1.0)).numpy()
    save_image(args.output, img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
