"""Dependency-free PNG read/write, on zlib alone.

Replaces the reference's stb_image / stb_image_write calls
(apps/src/image.cpp:22-39, apps/src/scene.cpp:133-139). ``write_png`` clamps
a float image to [0,1] and quantizes it to 8-bit RGB; ``decode_png`` reads
the 8-bit colour types (gray, gray+alpha, RGB, RGBA, palette) with all five
scanline filters, and refuses interlaced files and other bit depths.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels per pixel in the scanlines (palette: one index).
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp a float HxWx3 image to [0,1] and quantize to uint8.

    Matches apps/src/image.cpp:26-37 (clamp then *255, truncation via cast).
    """
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    return struct.pack(">I", len(payload)) + tag + payload + crc


def encode_png(img: np.ndarray) -> bytes:
    """The RGB PNG file of an HxWx3 image (float in [0,1] or uint8)."""
    data = to_uint8(img)
    if data.ndim == 2:
        data = np.repeat(data[..., None], 3, axis=-1)
    if data.shape[-1] == 4:
        data = data[..., :3]
    h, w, _ = data.shape
    raw = b"".join(b"\x00" + data[i].tobytes() for i in range(h))  # filter 0 per row
    return b"".join((_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
                     _chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an HxWx3 image (float in [0,1] or uint8) as an RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter_sequential(kind: int, line: bytes, prior: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4) rows: each byte depends on the one decoded
    bpp bytes before it."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """Decode PNG bytes to an HxWxC uint8 array: C = 1 gray, 2 gray+alpha,
    3 RGB, 4 RGBA; a palette image expands to RGB (as stb_image does)."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{name}: bit depth {depth}, colour type {ctype} is not supported "
                         "(8-bit gray, gray+alpha, RGB, RGBA or palette only)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{name}: image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the all-zero row above the image
    for y in range(h):
        kind, line, prior = int(rows[y, 0]), rows[y, 1:], out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # Sub: a running sum per channel, modulo 256
            out[y + 1] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y + 1] = line + prior
        elif kind in (3, 4):
            out[y + 1] = np.frombuffer(
                _unfilter_sequential(kind, line.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"{name}: unknown filter type {kind} in row {y}")
    img = out[1:].reshape(h, w, bpp)
    if ctype == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index out of range")
        img = palette[img[..., 0]]
    return np.ascontiguousarray(img)


def read_png(path: str) -> np.ndarray:
    """Read a PNG file to an HxWx3 RGB uint8 array (gray is repeated,
    alpha dropped)."""
    with open(path, "rb") as f:
        img = decode_png(f.read(), path)
    if img.shape[-1] < 3:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_texture(path: str, flip_vertical: bool = True) -> np.ndarray:
    """Load a texture image as HxWxC uint8 (C = its channels; palette
    images come as RGB). Textures are uint8 by contract: atlas packing
    (scene/device_scene.py) byte-packs their texels.

    Mirrors the reference's stbi_set_flip_vertically_on_load(true) +
    stbi_load (apps/src/scene.cpp:133-139): textures are stored bottom-up.
    """
    with open(path, "rb") as f:
        arr = decode_png(f.read(), path)
    if flip_vertical:
        arr = arr[::-1]
    return np.ascontiguousarray(arr)
