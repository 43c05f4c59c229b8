"""The native OBJ loader (``native/objload.cpp``), built for the host.

The JAX package parses OBJ geometry with this C++ loader, which also sorts
the triangles along a Morton curve of their centroids with ``std::sort``.
``device_scene.build_device_scene`` then re-sorts the faces stably into
128-face clusters, so faces whose codes tie keep the loader's order, and the
cluster layout (``face_plane``, the cluster AABBs) depends on it. To lay out
a mesh exactly as the JAX package does, the port runs the same source: at
first use the host C++ compiler builds it (one call, about a second) into
the gitignored ``_build/`` beside the CUDA kernels, and ``ctypes`` loads it.
The repository's prebuilt ``native/libmygpurt_native.so`` is not loaded: it
is compiled with ``-march=native`` for the machine that built it.

Without a host compiler ``native_parse_obj`` returns None and the caller
parses in Python, in file order; renders then differ from the JAX package's
only where two faces tie exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO, "native", "objload.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared"]

_FP = ctypes.POINTER(ctypes.c_float)
_lib = None
_tried = False


def _build() -> str | None:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None or not os.path.isfile(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libobjload_{digest}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"warning: building {SOURCE} failed; parsing OBJ files in Python\n{proc.stderr}",
              file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def native_lib() -> ctypes.CDLL | None:
    """The loaded loader library, built on first use; None without a host
    C++ compiler."""
    global _lib, _tried
    if not _tried:
        _tried = True
        path = _build()
        if path is not None:
            lib = ctypes.CDLL(path)
            lib.obj_parse.restype = ctypes.c_long
            lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_FP),
                                      ctypes.POINTER(_FP), _FP, _FP]
            lib.obj_free_buffers.argtypes = [_FP, _FP]
            _lib = lib
    return _lib


def native_parse_obj(path: str, morton_order: bool = True):
    """Parse an OBJ natively. Returns (tri_pos [n,3,3], tri_uv [n,3,2],
    aabb_min [3], aabb_max [3]), or None when the library is unavailable or
    the file cannot be parsed."""
    lib = native_lib()
    if lib is None:
        return None
    tri_pos, tri_uv = _FP(), _FP()
    mn, mx = (ctypes.c_float * 3)(), (ctypes.c_float * 3)()
    n = lib.obj_parse(path.encode(), int(morton_order), ctypes.byref(tri_pos),
                      ctypes.byref(tri_uv), mn, mx)
    if n < 0:
        return None
    try:
        pos = (np.ctypeslib.as_array(tri_pos, shape=(n, 3, 3)).copy() if n
               else np.zeros((0, 3, 3), np.float32))
        uv = (np.ctypeslib.as_array(tri_uv, shape=(n, 3, 2)).copy() if n
              else np.zeros((0, 3, 2), np.float32))
    finally:
        lib.obj_free_buffers(tri_pos, tri_uv)
    return pos, uv, np.array(mn[:], np.float32), np.array(mx[:], np.float32)
