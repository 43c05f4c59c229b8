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

import contextlib
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
_L = ctypes.c_longlong
# C signature of every exported function: (restype, argtypes).
SIGNATURES = {
    # csrc/megakernel.cu
    "k1_accumulate": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _U, _U, _I, _I,
                           _F, _F, _I, _I, _P]),
    "k1_blocks_per_sm": (_I, [_I, _I, _I, _I]),
    # csrc/mesh_hit.cu
    "mesh_hit": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # csrc/prims_hit.cu
    "prims_hit": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _I,
                       _P]),
    # csrc/prng.cu
    "k6_uniforms": (_I, [_I, _P, _I, _I, _I, _U, _U, _P, _P]),
    "threefry_uniforms": (_I, [_P, _I, _I, _L, _L, _U, _U, _P, _P]),
    # csrc/bounce.cu
    "k5_bounce": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _I, _P, _P,
                       _I, _I, _P]),
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


def device_guard(device):
    """A context that makes ``device`` (a CUDA tensor's) current for a
    launch, whose C side launches on the current device, so a mesh of cards
    launches each kernel on its own card; nothing when it is current
    already (torch.cuda.device's switch and restore cost host time per
    launch)."""
    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device) -> int:
    """The cudaStream_t of the current CUDA stream on ``device`` (a CUDA
    tensor's device, so its index is set), as an int, from torch's C
    accessor: ``torch.cuda.current_stream(device)`` builds a Stream object
    per call, which costs a small kernel (K6 at [4, N]) more than its
    launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


# Launches counted on the device, per (kernel, device): an int64 scalar to
# which each wrapper adds one on the launch's stream right after its launch,
# so that the replays of a CUDA graph that recorded the launch add to it too
# (render/graphs.py). The wrappers' own LAUNCHES count calls on the host.
_on_device: dict = {}


def count_on_device(kernel: str, device) -> None:
    """Add one to ``kernel``'s launches counted on ``device``, on the
    current stream."""
    import torch

    key = (kernel, torch.device(device))
    count = _on_device.get(key)
    if count is None:
        if key[1].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}'s first launch on {key[1]} is in a CUDA graph "
                               "capture: its count would live in the graph's memory")
        count = _on_device[key] = torch.zeros((), dtype=torch.int64, device=key[1])
    count += 1


def launches_on_device(kernel: str) -> int:
    """``kernel``'s launches counted on the devices since
    :func:`zero_launches_on_device` (reads them: a host sync)."""
    return sum(int(count) for (name, _), count in _on_device.items() if name == kernel)


def zero_launches_on_device() -> None:
    """Set every launch count kept on a device to 0, in place (a graph that
    adds to one keeps its address)."""
    for count in _on_device.values():
        count.zero_()


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
