"""K1's CUDA source, compiled for the host, against its plain version.

The CUDA kernel has no CPU mode. This test compiles csrc/megakernel.cu with
the host C++ compiler instead: a small header stands in for the CUDA
built-ins (rsqrtf as 1/sqrtf, __uint_as_float, blockIdx...), and the
launch becomes a loop over blocks and threads. What it checks is the
kernel's logic: record layout, RNG counters, raygen, intersection, shading
and accumulation. Built with -ffp-contract=off and exact 1/sqrt, the host
build must equal the plain PyTorch version bit for bit on the color, and
within 1e-5 on the AOVs (a normalize may round once differently). The card
itself (FMA contraction, its math library) is checked by chip_smoke.py.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import rng
from mygpuraytracer_tpu_torch.render import megakernel
from mygpuraytracer_tpu_torch.scene import builtin, load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 24

HOST_STUB = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define CUDART_INF_F INFINITY
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
struct HostDim { unsigned x, y, z; };
static HostDim blockIdx, threadIdx, blockDim;
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fmul_rn(float a, float b) { return a * b; }
"""
LAUNCH = re.compile(r"k1_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);",
                    re.S)


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (REPO / "mygpuraytracer_tpu_torch/csrc/megakernel.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", HOST_STUB).replace("#include <math_constants.h>", "")
    src, count = LAUNCH.subn(
        r"(void)stream; for (int b_ = 0; b_ < blocks; ++b_) for (int t_ = 0; t_ < THREADS; ++t_)"
        r" { blockIdx.x = b_; threadIdx.x = t_; blockDim.x = THREADS; k1_kernel(\1); }", src)
    assert count == 1, "the kernel launch in megakernel.cu changed; update this test"
    d = tmp_path_factory.mktemp("k1host")
    (d / "k1.cpp").write_text(src)
    so = d / "libk1host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(REPO / "mygpuraytracer_tpu_torch/csrc"),
                    "-o", str(so), str(d / "k1.cpp")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    restype, argtypes = _build.SIGNATURES["k1_accumulate"]
    lib.k1_accumulate.restype, lib.k1_accumulate.argtypes = restype, argtypes
    return lib


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cube(d):
    v = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    f = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    (d / "cube.obj").write_text(
        "mtllib cube.mtl\n" + "".join(f"v {x} {y} {z}\n" for x, y, z in v)
        + "".join("f " + " ".join(map(str, q)) + "\n" for q in f))
    (d / "cube.mtl").write_text("newmtl cube\nKd 0.8 0.6 0.2\nKs 0.9 0.9 0.9\nNi 1.5\n")
    text = (REPO / "scenes/builtin_cornell.txt").read_text().rstrip()
    (d / "cube.txt").write_text(
        text + "\n\nOBJECT 7\nobj\ncube.obj\nTRANS 2 2 0\nROTAT 0 30 0\nSCALE 1.2 1.2 1.2\n")
    s = load_scene(str(d / "cube.txt"))
    s.set_resolution(RES, RES)
    return s


CASES = {
    "cornell": (lambda d: builtin.cornell_box(resolution=(RES, RES)), {}, 1),
    "cornellGlass": (lambda d: builtin.cornell_glass(resolution=(RES, RES)), {}, 1),
    "dof": (lambda d: builtin.cornell_box(resolution=(RES, RES)), {"depth_of_field": True}, 1),
    "noAA": (lambda d: builtin.cornell_glass(resolution=(RES, RES)),
             {"antialiasing": False, "cache_first_bounce": False}, 1),
    "cubeObj": (_cube, {}, 1),
    "glassFrom4": (lambda d: builtin.cornell_glass(resolution=(RES, RES)), {}, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_build_of_k1_matches_plain(case, host_k1, tmp_path):
    make, opts, start = CASES[case]
    dev, meta = build_device_scene(make(tmp_path), device="cpu")
    options = RenderOptions(megakernel=True, **opts)
    key = rng.make_key(9)
    iters, n = 3, RES * RES
    init = torch.rand((9, n), generator=torch.Generator().manual_seed(1))
    acc_k, acc_p = init.clone(), init.clone()
    record = megakernel.scene_record(meta, dev.camera)
    err = host_k1.k1_accumulate(
        record.data_ptr(), acc_k.data_ptr(), n, RES, RES, meta.trace_depth, start, iters,
        key[0], key[1], int(options.antialiasing), int(options.depth_of_field),
        options.lens_radius, options.focal_distance, None)
    assert err == 0
    megakernel.megakernel_accumulate_reference(dev, meta, options, acc_p, start, iters, key)
    assert torch.equal(acc_k[0:3], acc_p[0:3])
    assert float((acc_k[3:9] - acc_p[3:9]).abs().max()) < 1e-5
