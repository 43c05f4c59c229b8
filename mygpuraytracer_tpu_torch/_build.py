"""Build and load the port's CUDA kernels.

At first use, one ``nvcc`` per ``csrc/*.cu`` source, all started together,
compiles each for sm_90a into a shared library with a plain C interface,
which ``ctypes`` loads. A library lands in ``_build/`` beside this file,
named by its source and a hash of the source, the shared headers and the
flags, so a changed source rebuilds and an unchanged one loads at once.
Nothing here includes PyTorch's headers: a build takes seconds.

Run ``python -m mygpuraytracer_tpu_torch._build`` to build and print the
libraries' paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# ptxas prints each kernel's registers, shared memory and spills (build_log).
REPORT_FLAGS = ["-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# C signature of every exported function: (restype, argtypes).
SIGNATURES = {
    # csrc/megakernel.cu
    "k1_accumulate": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U, _U, _I, _I, _F, _F,
                           _I, _I, _P]),
    "k1_blocks_per_sm": (_I, [_I, _I, _I, _I]),
    # csrc/mesh_hit.cu
    "mesh_hit": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # csrc/prng.cu
    "k6_uniforms": (_I, [_I, _P, _I, _I, _P]),
    # csrc/bounce.cu
    "k5_bounce": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _I, _I, _I, _P]),
}

_lib = None
build_seconds: float | None = None  # wall time of this process's nvcc runs
build_log = ""  # nvcc's messages (ptxas resource usage) from this process's builds


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))


def _headers() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh"))


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *_headers()]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build() -> list[str]:
    """Compile every source whose library is not built yet, one nvcc each,
    in parallel; return the libraries' paths."""
    global build_seconds, build_log
    outs = [library_path(s) for s in _sources()]
    todo = [(s, o) for s, o in zip(_sources(), outs) if not os.path.isfile(o)]
    if not todo:
        return outs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *REPORT_FLAGS, "-o", tmp, src]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, tmp, out, proc in jobs:
        stdout, stderr = proc.communicate()
        build_log += stdout + stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return outs


def stream_handle(device) -> int:
    """The cudaStream_t of the current CUDA stream on ``device`` (a CUDA
    tensor's device, so its index is set), as an int, from torch's C
    accessor: ``torch.cuda.current_stream(device)`` builds a Stream object
    per call, which costs a small kernel (K6 at [4, N]) more than its
    launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def library() -> types.SimpleNamespace:
    """Every exported kernel entry point (``SIGNATURES``) as an attribute,
    from the libraries built on first use."""
    global _lib
    if _lib is None:
        fns = {}
        for path in build():
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.restype, fn.argtypes = restype, argtypes
                    fns[name] = fn
        missing = set(SIGNATURES) - set(fns)
        if missing:
            raise RuntimeError(f"kernel libraries lack {sorted(missing)}")
        _lib = types.SimpleNamespace(**fns)
    return _lib


if __name__ == "__main__":
    library()
    print(*build(), f"nvcc {build_seconds:.1f} s" if build_seconds else "(cached)", build_log,
          sep="\n")
