"""The mesh kernel's CUDA source, compiled for the host, against its plain
version.

The CUDA kernel has no CPU mode. This test compiles csrc/mesh_hit.cu with
the host C++ compiler instead: a small header stands in for the CUDA
built-ins (the _rn intrinsics as plain IEEE operations, shared memory as a
static array, __syncthreads_or as its own argument), and the launch becomes
a loop over blocks of one thread each. So the kernel's own code runs: the
slab test, the copy of each visited cluster into the shared panel, the
plane-form face test and the first-minimum update; only the block-wide
vote is trivial. Built with -ffp-contract=off, it must equal the plain
PyTorch version (ops/mesh_hit.py) bit for bit on every output and on the
visit counts. The card itself is checked by chip_smoke.py and
tests/test_torch_mesh_cuda.py.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene
from test_torch_mesh_tiers import ship_rays

REPO = pathlib.Path(__file__).resolve().parent.parent

HOST_STUB = r"""
#include <cmath>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define CUDART_INF_F INFINITY
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
struct HostDim { unsigned x, y, z; };
static HostDim blockIdx, threadIdx, blockDim;
inline void __syncthreads() {}
inline bool __syncthreads_or(bool p) { return p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
"""
LAUNCH = re.compile(
    r"mesh_hit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (REPO / "mygpuraytracer_tpu_torch/csrc/mesh_hit.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", HOST_STUB).replace("#include <math_constants.h>", "")
    src, count = LAUNCH.subn(
        r"(void)stream; (void)blocks; for (int b_ = 0; b_ < n; ++b_)"
        r" { blockIdx.x = b_; threadIdx.x = 0; blockDim.x = 1; mesh_hit_kernel(\1); }", src)
    assert count == 1, "the kernel launch in mesh_hit.cu changed; update this test"
    d = tmp_path_factory.mktemp("meshhost")
    (d / "mesh_hit.cpp").write_text(src)
    so = d / "libmeshhost.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(REPO / "mygpuraytracer_tpu_torch/csrc"),
                    "-o", str(so), str(d / "mesh_hit.cpp")], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(so))
    lib.mesh_hit.restype, lib.mesh_hit.argtypes = _build.SIGNATURES["mesh_hit"]
    return lib


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _host_mesh_hit(lib, dev, rays):
    n = rays.shape[1]
    out = torch.full((mh.OUT_ROWS, n), float("nan"))
    visits = torch.full((n,), -1, dtype=torch.int32)
    err = lib.mesh_hit(rays.data_ptr(), dev.face_plane.data_ptr(), dev.cluster_bounds.data_ptr(),
                       out.data_ptr(), visits.data_ptr(), n, dev.face_plane.shape[1],
                       dev.cluster_bounds.shape[1], None)
    assert err == 0
    return out, visits


@pytest.mark.parametrize("scene", ["cornellShip", "shipTexOnly"])
def test_host_build_of_mesh_kernel_matches_plain(scene, host_kernel):
    ts = load_scene(str(REPO / f"scenes/{scene}.txt"))
    dev, meta = build_device_scene(ts, 128, device="cpu")
    o_np, d_np = ship_rays(n=700, seed=11)
    o = trace.Vec3(*(torch.from_numpy(o_np[:, i].copy()) for i in range(3)))
    d = trace.Vec3(*(torch.from_numpy(d_np[:, i].copy()) for i in range(3)))
    t_cap = trace.intersect_primitives_soa(meta, o, d).t
    # a fifth of the lanes dead: the padding convention
    dead = torch.from_numpy(np.random.default_rng(11).random(700) < 0.2)
    rays = torch.stack([torch.where(dead, 1e7, o.x), torch.where(dead, 1e7, o.y),
                        torch.where(dead, 1e7, o.z), torch.where(dead, 1.0, d.x),
                        torch.where(dead, 0.0, d.y), torch.where(dead, 0.0, d.z),
                        torch.where(dead, 0.0, t_cap)]).contiguous()
    out_h, visits_h = _host_mesh_hit(host_kernel, dev, rays)
    out_p, visits_p = mh.mesh_hit_reference(dev.face_plane, dev.cluster_bounds, rays,
                                            with_visits=True)
    assert torch.equal(out_h.view(torch.int32), out_p.view(torch.int32))  # bit for bit
    assert torch.equal(visits_h, visits_p)
    assert int((out_p[4] >= 0).sum()) > 50 and int(visits_p[dead].sum()) == 0
