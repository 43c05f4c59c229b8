"""K5's and K6's CUDA sources, compiled for the host, against their plain
versions.

A CUDA kernel has no CPU mode. These tests compile csrc/bounce.cu (K5) and
csrc/prng.cu (K6) with the host C++ compiler instead: a small header stands
in for the CUDA built-ins (the _rn intrinsics as plain IEEE operations,
rsqrtf as 1/sqrtf, shared memory as static arrays, a warp shuffle and a
block vote as their own argument), and a launch becomes a loop.

K5 runs in blocks of one thread, as the mesh kernel's host test does: the
block reductions then reduce over one ray, but the walk's own code runs,
its near-to-far order, its two stopping bounds and the shared panel. Built
with -ffp-contract=off and exact 1/sqrt, it must equal the plain version
(the wavefront over the plain walk, ``trace_sample`` with
``ops/trace.py::bvh_scene_hit_nearfar``, as
render/megakernel.py::bvh_bounce_accumulate_reference runs it) bit for bit
on the color, under both random streams, at 24x24, depth 8, 2 iterations; the
AOVs within 1e-5 (a normalize may round once differently, as for K1). The
first image row is replaced by rays that miss everything, so the walk has
to end on key exhaustion there. K6 must equal its plain version bit for
bit. The card itself is checked by chip_smoke.py and the requires_cuda
tests.
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
from mygpuraytracer_tpu_torch.ops import prng, rng, trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import megakernel, pathtrace
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "mygpuraytracer_tpu_torch/csrc"
RES = 24
DEPTH = 8
ITERS = 2

HOST_STUB = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define CUDART_INF_F INFINITY
typedef void* cudaStream_t;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
struct HostDim { unsigned x, y, z; };
static HostDim blockIdx, threadIdx, blockDim;
inline void __syncthreads() {}
inline bool __syncthreads_or(bool p) { return p; }
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
"""


def _host_build(tmp_path_factory, source: str, launch: re.Pattern, loop: str, name: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC / source).read_text()
    src = src.replace("#include <cuda_runtime.h>", HOST_STUB).replace("#include <math_constants.h>", "")
    src, count = launch.subn(loop, src)
    assert count == 1, f"the kernel launch in {source} changed; update this test"
    d = tmp_path_factory.mktemp(name)
    (d / f"{name}.cpp").write_text(src)
    so = d / f"lib{name}.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(so), str(d / f"{name}.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    return lib


@pytest.fixture(scope="module")
def host_k5(tmp_path_factory):
    lib = _host_build(
        tmp_path_factory, "bounce.cu",
        re.compile(r"k5_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);",
                   re.S),
        r"(void)stream; (void)blocks; for (int b_ = 0; b_ < n; ++b_)"
        r" { blockIdx.x = b_; threadIdx.x = 0; blockDim.x = 1; k5_kernel(\1); }", "k5host")
    lib.k5_bounce.restype, lib.k5_bounce.argtypes = _build.SIGNATURES["k5_bounce"]
    return lib


@pytest.fixture(scope="module")
def host_k6(tmp_path_factory):
    lib = _host_build(
        tmp_path_factory, "prng.cu",
        re.compile(r"k6_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);",
                   re.S),
        r"(void)stream; for (int b_ = 0; b_ < blocks; ++b_) for (int t_ = 0; t_ < THREADS; ++t_)"
        r" { blockIdx.x = b_; threadIdx.x = t_; blockDim.x = THREADS; k6_kernel(\1); }", "k6host")
    lib.k6_uniforms.restype, lib.k6_uniforms.argtypes = _build.SIGNATURES["k6_uniforms"]
    return lib


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(name):
    s = load_scene(str(REPO / f"scenes/{name}.txt"))
    s.set_resolution(RES, RES)
    s.state.trace_depth = DEPTH
    return build_device_scene(s, device="cpu")


def _with_miss_row(generate):
    """generate_camera_rays whose first image row points away from the
    scene (+z from the camera, out of the box's open side)."""
    def wrapped(cam, resolution, options, uniforms):
        o, d = generate(cam, resolution, options, uniforms)
        row = torch.arange(o.x.shape[0]) < resolution[0]
        away = Vec3(torch.where(row, 0.0, d.x), torch.where(row, 0.0, d.y),
                    torch.where(row, 1.0, d.z))
        return o, away
    return wrapped


@pytest.mark.parametrize("mode", ["threefry", "pallas"])
@pytest.mark.parametrize("scene", ["cornellShip", "shipOnly"])
def test_host_build_of_k5_matches_plain(scene, mode, host_k5, monkeypatch):
    dev, meta = _scene(scene)
    assert megakernel._uses_bvh(meta)
    options = RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto")
    generate = _with_miss_row(pathtrace.generate_camera_rays)
    monkeypatch.setattr(pathtrace, "generate_camera_rays", generate)
    key = rng.make_key(5)
    n = RES * RES
    init = torch.rand((9, n), generator=torch.Generator().manual_seed(2))
    acc_k, acc_p = init.clone(), init.clone()
    visits = torch.zeros(n, dtype=torch.int32)
    record = megakernel.scene_record(meta, dev.camera)
    fp, bounds = dev.face_plane, dev.cluster_bounds
    k = pathtrace.num_rng_streams(DEPTH)
    everyone = torch.ones(n, dtype=torch.bool)
    query = lambda o, d, active=None: trace.bvh_scene_hit_nearfar(
        meta, fp, o, d, everyone if active is None else active, bounds)
    for it in range(1, ITERS + 1):
        ikey = rng.iteration_key(key, it)
        seed = rng.randint(ikey)
        # The plain side: the wavefront over the plain walk, on the stream ``mode`` names.
        U = prng.uniforms_reference(seed, k, n) if mode == "pallas" else rng.uniform(ikey, (k, n))
        pathtrace.accumulate_sample(
            acc_p, pathtrace.trace_sample(dev, meta, options, it, U, query), it)
        o, d = generate(dev.camera, meta.resolution, options, U)
        rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z]).contiguous()
        if it == 1:  # the first row really misses the whole scene
            first = trace.bvh_scene_hit(meta, fp, Vec3(*rays[0:3]), Vec3(*rays[3:6]), bounds)
            assert not bool(first.hit[:RES].any()) and bool(first.hit[RES:].any())
        err = host_k5.k5_bounce(
            rays.data_ptr(), record.data_ptr(), fp.data_ptr(), bounds.data_ptr(),
            acc_k.data_ptr(), visits.data_ptr(), n, DEPTH, it, int(mode == "pallas"),
            ikey[0], ikey[1], seed, fp.shape[1], bounds.shape[1], None)
        assert err == 0
    assert torch.equal(acc_k[0:3], acc_p[0:3])
    assert float((acc_k[3:9] - acc_p[3:9]).abs().max()) < 1e-5
    assert torch.equal(acc_k[0:3, :RES], init[0:3, :RES])  # the missing row adds black
    assert int(visits.sum()) > 0


@pytest.mark.parametrize("seed", [0, -5, 2**31 - 1])
def test_host_build_of_k6_matches_plain(seed, host_k6):
    k, n = 7, 2048 + 333
    out = torch.full((k, n), float("nan"))
    assert host_k6.k6_uniforms(seed, out.data_ptr(), k, n, None) == 0
    assert torch.equal(out, prng.uniforms_reference(seed, k, n))
