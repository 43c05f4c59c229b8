"""Minimal dependency-free PNG read/write.

Replaces the reference's stb_image_write-based ``image::savePNG``
(apps/src/image.cpp:22-39): float image is clamped to [0,1] and quantized to
8-bit RGB.  Uses Pillow when available (faster), with a pure zlib fallback so
the framework has no hard imaging dependency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:  # Pillow is optional
    from PIL import Image  # type: ignore

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp a float HxWx3 image to [0,1] and quantize to uint8.

    Matches apps/src/image.cpp:26-37 (clamp then *255, truncation via cast).
    """
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an HxWx3 image (float in [0,1] or uint8) as PNG."""
    data = to_uint8(img)
    if data.ndim == 2:
        data = np.repeat(data[..., None], 3, axis=-1)
    if data.shape[-1] == 4:
        data = data[..., :3]
    h, w, _ = data.shape
    if _HAVE_PIL:
        Image.fromarray(data, mode="RGB").save(path)
        return
    # Pure-python fallback: filter 0 per scanline + zlib.
    raw = b"".join(b"\x00" + data[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an image file to an HxWxC uint8 array."""
    if _HAVE_PIL:
        return np.asarray(Image.open(path).convert("RGB"))
    raise RuntimeError("read_png requires Pillow in this build")


def load_texture(path: str, flip_vertical: bool = True) -> np.ndarray:
    """Load a texture image as HxWxC uint8.

    Mirrors the reference's stbi_set_flip_vertically_on_load(true) +
    stbi_load (apps/src/scene.cpp:133-139): textures are stored bottom-up.
    """
    if not _HAVE_PIL:
        raise RuntimeError("texture loading requires Pillow in this build")
    img = Image.open(path)
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    # Normalize to uint8 where textures enter the pipeline: atlas packing
    # (scene/device_scene.py) byte-packs texels under a uint8 contract, and
    # stbi_load in the reference likewise returns 8-bit channels. 16-bit
    # PNGs (PIL yields uint16) and float images are downconverted here.
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)
    elif arr.dtype in (np.float32, np.float64):
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    elif arr.dtype == np.bool_:
        arr = arr.astype(np.uint8) * np.uint8(255)
    elif arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if flip_vertical:
        arr = arr[::-1]
    return np.ascontiguousarray(arr)
