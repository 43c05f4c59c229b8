"""HDR/LDR image file I/O for the denoiser apps.

The port's own copy of ``mygpuraytracer_tpu/utils/image_io.py``. Covers the
reference's app formats (apps/utils/image_io.cpp): PFM (the portable float
format OIDN tests use), Radiance HDR, EXR (utils/exr.py), plus PNG (read
and written on zlib alone, utils/png.py) and NPY. PFM, HDR and EXR files are
written byte for byte as the JAX package writes them.
"""

from __future__ import annotations

import os

import numpy as np

from .png import read_png, write_png


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file to HxWx3 (or HxW) float32, top-down orientation."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(
            f.read(w * h * channels * 4), dtype="<f4" if scale < 0 else ">f4"
        )
        img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
        img = img[::-1]  # PFM stores bottom-up
        if abs(scale) != 1.0:
            img = img * abs(scale)
        return np.ascontiguousarray(img.astype(np.float32))


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        header = b"Pf"
        channels = 1
    else:
        header = b"PF"
        channels = img.shape[2]
        if channels != 3:
            raise ValueError("PFM supports 1 or 3 channels")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write a Radiance RGBE (.hdr) file — image::saveHDR parity
    (apps/src/image.cpp:41-45 via stb_image_write)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    rgb = img[..., :3]
    maxc = rgb.max(axis=-1)
    valid = maxc >= 1e-32
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float64)
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    exp = np.where(valid, e, 0)
    mant = np.where(valid, m, 0.0)
    scale = np.where(valid, mant * 256.0 / np.where(valid, maxc, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())  # flat (non-RLE) scanlines


def read_hdr(path: str) -> np.ndarray:
    """Read a flat (non-RLE) Radiance RGBE file written by write_hdr."""
    with open(path, "rb") as f:
        if f.readline().strip() not in (b"#?RADIANCE", b"#?RGBE"):
            raise ValueError("not a Radiance HDR file")
        line = f.readline()
        while line.strip():
            line = f.readline()
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = np.frombuffer(f.read(h * w * 4), np.uint8).reshape(h, w, 4)
    exp = data[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))
    return (data[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def load_image(path: str) -> np.ndarray:
    """Load an image as HxWx3 float32 (LDR formats are mapped to [0,1])."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        img = read_pfm(path)
    elif ext == ".hdr":
        img = read_hdr(path)
    elif ext == ".npy":
        img = np.load(path).astype(np.float32)
    elif ext == ".png":
        img = read_png(path).astype(np.float32) / 255.0
    elif ext in (".exr", ".cxr"):
        from .exr import read_exr

        img = read_exr(path)
    else:
        raise ValueError(f"unsupported image format: {ext}")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def save_image(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        write_pfm(path, img)
    elif ext == ".hdr":
        write_hdr(path, img)
    elif ext == ".npy":
        np.save(path, np.asarray(img, np.float32))
    elif ext == ".png":
        write_png(path, img)
    elif ext == ".exr":
        from .exr import write_exr

        write_exr(path, np.asarray(img, np.float32))
    else:
        raise ValueError(f"unsupported image format: {ext}")


def compare_images(a: np.ndarray, b: np.ndarray, threshold: float = 1e-4):
    """apps/utils/image_io compareImage: count of pixels whose relative error
    exceeds threshold, plus the max relative error."""
    denom = np.maximum(np.abs(b), 1e-3)
    rel = np.abs(a - b) / denom
    return int((rel > threshold).sum()), float(rel.max())
