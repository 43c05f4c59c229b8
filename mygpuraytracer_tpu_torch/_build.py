"""Build and load the port's CUDA kernels.

At first use, one ``nvcc`` call compiles every ``csrc/*.cu`` for sm_90a
into one shared library with a plain C interface, which ``ctypes`` loads.
The library lands in ``_build/`` beside this file, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
at once. Nothing here includes PyTorch's headers: the build takes seconds.

Run ``python -m mygpuraytracer_tpu_torch._build`` to build and print the
library's path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# C signature of every exported function: (restype, argtypes).
SIGNATURES = {
    # csrc/megakernel.cu
    "k1_accumulate": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _I, _I, _F, _F, _P]),
}

_lib = None
build_seconds: float | None = None  # wall time of this process's nvcc run


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libmygpurt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if this version is not built yet; return the path."""
    global build_seconds
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


if __name__ == "__main__":
    library()
    print(build(), f"nvcc {build_seconds:.1f} s" if build_seconds else "(cached)")
