"""Split a multi-channel EXR into per-feature images.

The port's counterpart of ``mygpuraytracer_tpu/apps/split_exr.py``: the
reference's training/split_exr.py contract (feature-name aliases per
renderer, optional --layer prefix, writes <name>.<feature>.exr) on the
pure-Python EXR backend (utils/exr.py) instead of OpenImageIO; output
compression is ZIP rather than PIZ (not in the subset).

Usage: python -m mygpuraytracer_tpu_torch.apps.split_exr IN.exr [--layer NAME]
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

# Feature aliases, in priority order (training/split_exr.py:43-66).
FEATURES = {
    "hdr": [
        ("R", "G", "B"),
        ("Noisy Image.R", "Noisy Image.G", "Noisy Image.B"),
        ("Beauty.R", "Beauty.G", "Beauty.B"),
    ],
    "a": [("A",)],
    "alb": [
        ("albedo.R", "albedo.G", "albedo.B"),
        ("Denoising Albedo.R", "Denoising Albedo.G", "Denoising Albedo.B"),
        ("VisibleDiffuse.R", "VisibleDiffuse.G", "VisibleDiffuse.B"),
        ("diffuse.R", "diffuse.G", "diffuse.B"),
        ("DiffCol.R", "DiffCol.G", "DiffCol.B"),
    ],
    "nrm": [
        ("normal.R", "normal.G", "normal.B"),
        ("N.R", "N.G", "N.B"),
        ("Denoising Normal.X", "Denoising Normal.Y", "Denoising Normal.Z"),
        ("Normals.R", "Normals.G", "Normals.B"),
        ("VisibleNormals.R", "VisibleNormals.G", "VisibleNormals.B"),
        ("OptixNormals.R", "OptixNormals.G", "OptixNormals.B"),
    ],
    "z": [("Denoising Depth.Z",)],
}


def split_exr(path: str, layer: str | None = None) -> list[str]:
    from ..utils.exr import read_exr_channels, write_exr

    name, ext = os.path.splitext(path)
    if ext == ".cxr":  # Corona EXR
        ext = ".exr"
    if ext.lower() != ".exr":
        raise ValueError("image must be EXR")
    chans, _ = read_exr_channels(path)

    layer_channels = defaultdict(set)
    for channel in chans:
        if len(channel.split(".")) >= 3:
            lyr, ch = channel.split(".", 1)
            layer_channels[lyr].add(ch)
        else:
            layer_channels[None].add(channel)
    if not layer and len(layer_channels) == 1:
        layer = list(layer_channels)[0]

    written = []
    for feature, alias_lists in FEATURES.items():
        for feature_channels in alias_lists:
            if layer:
                feature_channels = tuple(f"{layer}.{f}" for f in feature_channels)
            if set(feature_channels).issubset(chans):
                out = name + "." + feature + ext
                img = np.stack([chans[c] for c in feature_channels], axis=-1)
                new_names = ["R", "G", "B"] if img.shape[-1] == 3 else ["Y"]
                write_exr(out, img, half=False, channel_names=new_names)
                written.append(out)
                break
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Splits a multi-channel EXR image into multiple feature images."
    )
    ap.add_argument("input")
    ap.add_argument("--layer", default=None)
    args = ap.parse_args(argv)
    for out in split_exr(args.input, args.layer):
        print(out)


if __name__ == "__main__":
    main()
