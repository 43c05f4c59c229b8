"""Tensor Archive (TZA) reader and writer.

Fresh implementation of the OIDN weights container from its format spec
(authoritative sources: core/tza.cpp:27-100 and training/tza.py):

    header:  u16 magic = 0x41D7, u8 major = 2, u8 minor, u64 table_offset
    tensors: raw data, each 64-byte aligned
    table:   u32 count, then per tensor:
             u16 name_len + name, u8 ndims, u32 dims[ndims],
             layout chars (one per dim, e.g. 'oihw' or 'x'),
             1 dtype char ('f'=f32, 'h'=f16, 'b'=i8, 'B'=u8), u64 offset

Supports the layouts OIDN emits: 'oihw' conv weights and 'x' biases.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x41D7
VERSION = (2, 0)

_DTYPE_TO_CHAR = {
    np.dtype(np.float32): "f",
    np.dtype(np.float16): "h",
    np.dtype(np.int8): "b",
    np.dtype(np.uint8): "B",
}
_CHAR_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CHAR.items()}


def read_tza(path_or_bytes) -> dict[str, tuple[np.ndarray, str]]:
    """Returns {name: (array, layout)}. Raises ValueError on a bad archive —
    including git-LFS pointer stubs."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()

    if buf[:len(b"version https://git-lfs")] == b"version https://git-lfs":
        raise ValueError(
            "file is a git-LFS pointer stub, not a real TZA archive "
            "(fetch real OIDN v1.4 weights or export trained ones)"
        )
    if len(buf) < 12:
        raise ValueError("truncated TZA archive")
    magic, major, minor, table_offset = struct.unpack_from("<HBBQ", buf, 0)
    if magic != MAGIC:
        raise ValueError("invalid tensor archive (bad magic)")
    if major != VERSION[0]:
        raise ValueError(f"unsupported TZA version {major}.{minor}")

    pos = table_offset
    (count,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    out: dict[str, tuple[np.ndarray, str]] = {}
    for _ in range(count):
        (name_len,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        name = buf[pos : pos + name_len].decode()
        pos += name_len
        (ndims,) = struct.unpack_from("<B", buf, pos)
        pos += 1
        dims = struct.unpack_from(f"<{ndims}I", buf, pos)
        pos += 4 * ndims
        layout = buf[pos : pos + ndims].decode("ascii")
        pos += ndims
        dtype_char = buf[pos : pos + 1].decode("ascii")
        pos += 1
        (offset,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        dtype = _CHAR_TO_DTYPE[dtype_char]
        n_elems = int(np.prod(dims)) if dims else 1
        arr = np.frombuffer(buf, dtype=dtype, count=n_elems, offset=offset).reshape(dims)
        out[name] = (arr.copy(), layout)
    return out


def write_tza(path: str, tensors: dict[str, tuple[np.ndarray, str]]) -> None:
    """Write ``{name: (array, layout)}`` in table order, each tensor 64-byte
    aligned, the table after the last one (byte for byte the JAX package's
    writer)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<HBBQ", MAGIC, VERSION[0], VERSION[1], 0))
        table = []
        for name, (arr, layout) in tensors.items():
            arr = np.ascontiguousarray(arr)
            if len(layout) != arr.ndim:
                raise ValueError(f"layout '{layout}' does not match rank of '{name}'")
            if arr.dtype not in _DTYPE_TO_CHAR:
                raise ValueError(f"unsupported dtype {arr.dtype}")
            f.write(b"\x00" * ((-f.tell()) % 64))
            table.append((name, arr.shape, layout, _DTYPE_TO_CHAR[arr.dtype], f.tell()))
            f.write(arr.tobytes())
        f.write(b"\x00" * ((-f.tell()) % 64))
        table_offset = f.tell()
        f.write(struct.pack("<I", len(table)))
        for name, shape, layout, dchar, offset in table:
            encoded = name.encode()
            f.write(struct.pack("<H", len(encoded)) + encoded)
            f.write(struct.pack(f"<B{len(shape)}I", len(shape), *shape))
            f.write(layout.encode("ascii") + dchar.encode("ascii"))
            f.write(struct.pack("<Q", offset))
        f.seek(4)
        f.write(struct.pack("<Q", table_offset))
