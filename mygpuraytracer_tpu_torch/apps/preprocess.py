"""Dataset preprocessing CLI — training/preprocess.py parity.

The port of ``mygpuraytracer_tpu/apps/preprocess.py``: every flag, with
``--device`` (default ``cuda``, ``cpu`` on request) in place of the JAX
app's ``--platform``. The JAX app runs on the CPU unless told otherwise
(its preprocess.py:172-178); the port follows its own rule that entry
points run on the card, so pass ``--device cpu`` where there is none.

Scans a dataset directory for EXR/PFM feature images in the reference's
naming convention (``<name>_<spp|ref>.<feature>.exr`` sample groups,
training/dataset.py:158-197), assembles input/target feature stacks with the
reference's clipping + range conventions (dataset.py:85-146), applies
exposure + the transfer function + fp16 conversion (preprocess.py:38-50),
and writes the result into the framework's training-dataset format:
``<preproc_dir>/<dataset>/<input>.input.npy`` + ``.target.npy`` pairs (what
train/dataset.py TileDataset consumes) plus ``samples.json`` / ``config.json``.

The reference packs preprocessed images into one memory-mapped TZA archive;
here each pair is an .npy file — the trainers load whole images and crop
them, so a flat file-per-image layout serves the same role with no archive
bookkeeping.

Flag surface mirrors training/config.py:42-110 for the ``preprocess`` tool:
positional features, --clean_aux, -f/--filter, -P/--preproc_dir,
-t/--train_data, -v/--valid_data, -D/--data_dir, -x/--transfer, -c/--config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from glob import glob

import numpy as np

FEATURE_ALIASES = {"albedo": "alb", "normal": "nrm"}
MAIN_FEATURES = ("hdr", "ldr", "sh1")


def normalize_features(features: list[str]) -> list[str]:
    feats = [FEATURE_ALIASES.get(f, f) for f in features]
    out = []
    for f in feats:
        if f not in out:
            out.append(f)
    return out


def get_main_feature(features: list[str]) -> str:
    main = [f for f in features if f in MAIN_FEATURES]
    if len(main) != 1:
        raise SystemExit("error: exactly one main feature (hdr/ldr/sh1) required")
    return main[0]


def default_transfer(main_feature: str, filter_name: str) -> str:
    # training/config.py defaults: RT hdr->pu, ldr->srgb; RTLightmap->log
    if filter_name == "RTLightmap":
        return "log"
    return "pu" if main_feature == "hdr" else "srgb"


def _feature_suffixes(features: list[str]) -> list[str]:
    suffixes = []
    for f in features:
        suffixes += ["sh1x", "sh1y", "sh1z"] if f == "sh1" else [f]
    return suffixes


def image_exists(prefix: str, features: list[str], ext: str) -> bool:
    return all(
        os.path.isfile(f"{prefix}.{s}.{ext}") for s in _feature_suffixes(features)
    )


def load_image_features(prefix: str, features: list[str], ext: str) -> np.ndarray:
    """Stack features channel-wise with the reference's range conventions
    (training/dataset.py:85-146): hdr >= 0, ldr/alb in [0,1], nrm/sh1
    mapped [-1,1] -> [0,1]."""
    from ..utils.image_io import load_image

    images = []
    for f in features:
        if f == "hdr":
            img = np.maximum(load_image(f"{prefix}.hdr.{ext}"), 0.0)
            images.append(img)
        elif f == "ldr":
            images.append(np.clip(load_image(f"{prefix}.ldr.{ext}"), 0.0, 1.0))
        elif f == "sh1":
            for axis in ("sh1x", "sh1y", "sh1z"):
                sh1 = np.clip(load_image(f"{prefix}.{axis}.{ext}"), -1.0, 1.0)
                images.append(sh1 * 0.5 + 0.5)
        elif f == "alb":
            images.append(np.clip(load_image(f"{prefix}.alb.{ext}"), 0.0, 1.0))
        elif f == "nrm":
            nrm = np.clip(load_image(f"{prefix}.nrm.{ext}"), -1.0, 1.0)
            images.append(nrm * 0.5 + 0.5)
        else:
            raise SystemExit(f"error: unknown feature {f!r}")
    return np.concatenate([i.astype(np.float32) for i in images], axis=2)


def get_image_sample_groups(directory: str, input_features: list[str],
                            target_features: list[str], ext: str):
    """(group, [input names], target name) per the reference's grouping:
    trailing _<n>/_<n>spp/_ref/_gt/_target suffixes collapse into one group;
    the lexicographically last member is the target (dataset.py:158-197)."""
    filenames = glob(os.path.join(directory, "**", f"*.*.{ext}"), recursive=True)
    groups = defaultdict(set)
    for filename in filenames:
        name = os.path.relpath(filename, directory)
        name, _, _ = name.rsplit(".", 2)
        group = name
        if "_" in name:
            prefix, suffix = name.rsplit("_", 1)
            suffix = suffix.lower()
            if (suffix.isdecimal()
                    or (suffix.endswith("spp") and suffix[:-3].isdecimal())
                    or suffix in ("ref", "reference", "gt", "target")):
                group = prefix
        groups[group].add(name)

    sample_groups = []
    for group in sorted(groups):
        names = sorted(groups[group])
        if len(names) > 1:
            input_names, target_name = names[:-1], names[-1]
        else:
            input_names, target_name = names, None
        if all(image_exists(os.path.join(directory, n), input_features, ext)
               for n in input_names):
            if target_name and not image_exists(
                    os.path.join(directory, target_name), target_features, ext):
                target_name = None
            sample_groups.append((group, input_names, target_name))
    return sample_groups


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Preprocesses training and validation datasets "
                    "(training/preprocess.py parity)")
    p.add_argument("features", type=str, nargs="*",
                   help="set of input features (hdr|ldr|sh1|albedo|alb|normal|nrm)")
    p.add_argument("--clean_aux", action="store_true",
                   help="aux features are noise-free (read from the target)")
    p.add_argument("-f", "--filter", default="RT", choices=["RT", "RTLightmap"])
    p.add_argument("-P", "--preproc_dir", default="preproc",
                   help="directory of preprocessed datasets")
    p.add_argument("-t", "--train_data", help="name of the training dataset")
    p.add_argument("-v", "--valid_data", help="name of the validation dataset")
    p.add_argument("-D", "--data_dir", default="data",
                   help="directory of datasets")
    p.add_argument("-x", "--transfer",
                   choices=["linear", "srgb", "pu", "log"], default=None)
    p.add_argument("-c", "--config",
                   help="load configuration from a JSON file "
                        "(overrides command-line arguments)")
    p.add_argument("--ext", default="exr", choices=["exr", "pfm"],
                   help="feature-image extension to scan for")
    p.add_argument("--device", default="cuda",
                   help="torch device of the transfer and autoexposure (default cuda)")
    args = p.parse_args(argv)
    if args.config:
        with open(args.config) as fh:
            for k, v in json.load(fh).items():
                setattr(args, k, v)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from ..denoise import color as color_mod

    device = torch.device(args.device)

    features = normalize_features(args.features or ["hdr", "alb", "nrm"])
    main_feature = get_main_feature(features)
    n_main = 9 if main_feature == "sh1" else 3

    if args.clean_aux:
        input_features, target_features = [main_feature], features
    else:
        input_features, target_features = features, [main_feature]

    transfer_kind = args.transfer or default_transfer(main_feature, args.filter)
    transfer = color_mod.make_transfer(transfer_kind)

    def preprocess_image(image: np.ndarray, exposure: float) -> np.ndarray:
        """Transfer the main channels, clamp to 1, fp16 (preprocess.py:38-50)."""
        color = image[..., :n_main]
        if main_feature == "hdr":
            color = color * exposure
        color = transfer.forward(torch.from_numpy(np.ascontiguousarray(color)).to(device))
        color = np.minimum(color.cpu().numpy(), 1.0)
        image = image.copy()
        image[..., :n_main] = color
        return np.nan_to_num(image.astype(np.float16))

    def preprocess_dataset(data_name: str) -> None:
        input_dir = os.path.join(args.data_dir, data_name)
        print(f"\n== preprocessing {input_dir}")
        if not os.path.isdir(input_dir):
            print("   (missing — skipped)")
            return
        output_dir = os.path.join(args.preproc_dir, data_name)
        os.makedirs(output_dir, exist_ok=True)

        samples = []
        for group, input_names, target_name in get_image_sample_groups(
                input_dir, input_features, target_features, args.ext):
            if not target_name:
                continue
            print(target_name)
            target_image = load_image_features(
                os.path.join(input_dir, target_name), target_features, args.ext)
            exposure = (
                float(color_mod.autoexposure(torch.from_numpy(
                    np.ascontiguousarray(target_image[..., :3])).to(device)))
                if main_feature == "hdr" else 1.0
            )
            target_pre = preprocess_image(target_image, exposure)
            for input_name in input_names:
                print(input_name)
                input_image = load_image_features(
                    os.path.join(input_dir, input_name), input_features, args.ext)
                if input_image.shape[:2] != target_image.shape[:2]:
                    raise SystemExit(
                        "error: input/target resolution mismatch for this sample group")
                input_pre = preprocess_image(input_image, exposure)
                if args.clean_aux:
                    # noisy main + clean aux channels from the target
                    input_pre = np.concatenate(
                        [input_pre, target_pre[..., n_main:]], axis=2)
                flat = input_name.replace(os.sep, "__")
                np.save(os.path.join(output_dir, f"{flat}.input.npy"), input_pre)
                np.save(os.path.join(output_dir, f"{flat}.target.npy"),
                        target_pre[..., :n_main])
                samples.append((input_name, target_name))

        with open(os.path.join(output_dir, "samples.json"), "w") as fh:
            json.dump(samples, fh, indent=1)
        with open(os.path.join(output_dir, "config.json"), "w") as fh:
            json.dump({
                "features": features,
                "main_feature": main_feature,
                "clean_aux": bool(args.clean_aux),
                "filter": args.filter,
                "transfer": transfer_kind,
            }, fh, indent=1)
        print(f"Wrote {len(samples)} sample pairs to {output_dir}")

    for dataset in (args.train_data, args.valid_data):
        if dataset:
            preprocess_dataset(dataset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
