"""Minimal pure-Python OpenEXR reader/writer (numpy and zlib only).

The port's own copy of ``mygpuraytracer_tpu/utils/exr.py``: the same reader
and writer, byte for byte in what they write.

The reference reads/writes EXR through OpenImageIO (apps/utils/
image_io.cpp loadImageOIIO/saveImageOIIO) and its whole training corpus is
EXR feature images (training/preprocess.py, split_exr.py). This implements
the subset those paths actually need, from the OpenEXR 2.0 file-format
spec: single-part scanline files, HALF/FLOAT/UINT channels, NO_COMPRESSION
/ ZIPS / ZIP (zlib + the byte-interleave/delta predictor), increasing or
decreasing line order, arbitrary data windows, arbitrary channel sets.

No code is taken from OpenEXR; the chunk layout and predictor are from the
published format documentation.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_TYPES = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
                np.dtype(np.float32): 2}
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16}


def _predictor_decode(data: bytes) -> bytes:
    """Inverse of the EXR zip transform: undo the delta predictor, then
    de-interleave the two half-planes."""
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    arr[1:] -= 128
    arr = (np.cumsum(arr) & 0xFF).astype(np.uint8)
    half = (len(arr) + 1) // 2
    out = np.empty(len(arr), np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half : half + len(arr) // 2]
    return out.tobytes()


def _predictor_encode(data: bytes) -> bytes:
    """EXR zip transform: interleave-split, then delta-encode."""
    src = np.frombuffer(data, np.uint8)
    tmp = np.concatenate([src[0::2], src[1::2]]).astype(np.int64)
    d = np.empty_like(tmp)
    d[0] = tmp[0]
    d[1:] = (tmp[1:] - tmp[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def _read_attr_value(typ: str, data: bytes):
    if typ == "box2i":
        return struct.unpack("<4i", data)
    if typ == "int":
        return struct.unpack("<i", data)[0]
    if typ == "float":
        return struct.unpack("<f", data)[0]
    if typ == "compression" or typ == "lineOrder":
        return data[0]
    if typ == "chlist":
        chans = []
        pos = 0
        while data[pos] != 0:
            end = data.index(b"\x00", pos)
            name = data[pos:end].decode("latin-1")
            ptype, xs, ys = struct.unpack("<i4xii", data[end + 1 : end + 17])
            chans.append((name, ptype, xs, ys))
            pos = end + 17
        return chans
    return data  # keep raw for types we don't interpret


def read_exr_channels(path: str):
    """Read an EXR file -> (dict channel-name -> HxW float32/uint32 array,
    header dict)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: multi-part EXR not supported")
    if version & 0x800:
        raise ValueError(f"{path}: deep data not supported")
    if version & 0x1000:
        raise ValueError(f"{path}: tiled EXR not supported")

    pos = 8
    header: dict = {}
    while buf[pos] != 0:
        e = buf.index(b"\x00", pos)
        name = buf[pos:e].decode("latin-1")
        pos = e + 1
        e = buf.index(b"\x00", pos)
        typ = buf[pos:e].decode("latin-1")
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        header[name] = _read_attr_value(typ, buf[pos : pos + size])
        pos += size
    pos += 1  # header terminator

    xmin, ymin, xmax, ymax = header["dataWindow"]
    width, height = xmax - xmin + 1, ymax - ymin + 1
    comp = header.get("compression", _NO_COMPRESSION)
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported compression {comp}")
    lpb = _LINES_PER_BLOCK[comp]
    chans = header["channels"]
    for _name, _ptype, xs, ys in chans:
        if xs != 1 or ys != 1:
            raise ValueError(f"{path}: subsampled channels not supported")

    n_blocks = (height + lpb - 1) // lpb
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    out = {
        name: np.empty((height, width), _PIXEL_DTYPES[ptype])
        for name, ptype, _, _ in chans
    }
    line_bytes = sum(
        width * np.dtype(_PIXEL_DTYPES[pt]).itemsize for _, pt, _, _ in chans
    )
    for off in offsets:
        y, nbytes = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + nbytes]
        rows = min(lpb, ymax + 1 - y)
        raw_size = rows * line_bytes
        if comp in (_ZIPS, _ZIP) and nbytes < raw_size:
            data = _predictor_decode(zlib.decompress(data))
        b = 0
        for r in range(rows):
            for name, ptype, _, _ in chans:
                dt = np.dtype(_PIXEL_DTYPES[ptype])
                n = width * dt.itemsize
                out[name][y - ymin + r] = np.frombuffer(data, dt, width, b)
                b += n
    if header.get("lineOrder", 0) == 1:  # DECREASING_Y
        out = {k: v[::-1] for k, v in out.items()}
    return (
        {k: (v if v.dtype == np.uint32 else v.astype(np.float32)) for k, v in out.items()},
        header,
    )


def read_exr(path: str) -> np.ndarray:
    """Read an EXR as HxWxC float32, RGB(A) channel order when present
    (the apps/utils/image_io.cpp loadImage contract)."""
    chans, _ = read_exr_channels(path)
    names = list(chans)
    order = [n for n in ("R", "G", "B", "A") if n in chans]
    if not order:  # e.g. single-channel or layered file: alphabetical
        order = sorted(names)
    if len(order) == 1:
        return chans[order[0]][..., None]
    return np.stack([chans[n] for n in order], axis=-1)


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return (name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data)


def write_exr(path: str, img: np.ndarray, half: bool = True,
              channel_names=None, compression: int = _ZIP) -> None:
    """Write HxWxC (or HxW) data as a scanline EXR (ZIP-compressed by
    default; ``half=False`` stores FLOAT channels)."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = (["Y"], ["Y", "A"], ["R", "G", "B"], ["R", "G", "B", "A"])[
            c - 1
        ] if c <= 4 else [f"c{i:02d}" for i in range(c)]
    if len(channel_names) != c:
        raise ValueError("channel_names length mismatch")
    if img.dtype == np.uint32:
        dt = np.dtype(np.uint32)
    else:
        dt = np.dtype(np.float16 if half else np.float32)
    ptype = _PIXEL_TYPES[dt]
    planes = {n: np.ascontiguousarray(img[..., i]).astype(dt)
              for i, n in enumerate(channel_names)}
    names = sorted(channel_names)  # EXR stores channels alphabetically

    chl = b""
    for n in names:
        # name\0, pixelType i32, pLinear u8 + 3 reserved, xSampling, ySampling
        chl += (n.encode() + b"\x00" + struct.pack("<i", ptype)
                + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1))
    chl += b"\x00"

    header = b"".join([
        _attr("channels", "chlist", chl),
        _attr("compression", "compression", bytes([compression])),
        _attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)),
        _attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)),
        _attr("lineOrder", "lineOrder", b"\x00"),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\x00"

    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lpb - 1) // lpb
    chunks = []
    for bi in range(n_blocks):
        y0 = bi * lpb
        rows = min(lpb, h - y0)
        raw = b"".join(
            planes[n][y0 + r].tobytes() for r in range(rows) for n in names
        )
        if compression in (_ZIPS, _ZIP):
            comp = zlib.compress(_predictor_encode(raw))
            data = comp if len(comp) < len(raw) else raw
        else:
            data = raw
        chunks.append(struct.pack("<ii", y0, len(data)) + data)

    base = 8 + len(header) + 8 * n_blocks
    offsets, off = [], base
    for ch in chunks:
        offsets.append(off)
        off += len(ch)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for ch in chunks:
            f.write(ch)
