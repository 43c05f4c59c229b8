"""K5's and K6's CUDA sources, compiled for the host, against their plain
versions.

A CUDA kernel has no CPU mode. These tests compile csrc/bounce.cu (K5) and
csrc/prng.cu (K6) with the host C++ compiler instead: a small header stands
in for the CUDA built-ins (the _rn intrinsics as plain IEEE operations,
rsqrtf as 1/sqrtf, float4 loads), and a launch becomes a loop. K5's warp
is 32 lanes, each on its own stack, that meet at each of its warp-wide
calls (ballot, shuffle, minimum, sum), so the warp's shared steps run as on
the card: the bounce loop and the walk's rounds uniform over the warp, and
each round's leaves tested by the whole warp (a holder's ray broadcast, 4
faces a lane, the least t and then the least face index at it).

Each thread walks its ray over the cluster tree on its own stack, so the
host build runs the kernel's whole walk: the near-child-first order, the
stack and its pruning against the running best, the faces of
``face_gather``. Built with -ffp-contract=off and exact 1/sqrt, it must
equal the plain version (the wavefront over the plain walk,
``trace_sample`` with ``ops/trace.py::bvh_scene_hit_nearfar``, as
render/megakernel.py::bvh_bounce_accumulate_reference runs it) bit for bit
on the color, under both random streams, at 23x23 (529 pixels: the last
block of 64 threads has 17 lanes in the image, 15 lanes of its first warp
and its whole second warp past it) and at 24x24 (576 pixels, whole
blocks), depth 8, 2 iterations; the AOVs within 1e-5 (a normalize may round once differently,
as for K1). The one allowance: the tree walk visits clusters near to far
where the plain walk goes in ascending id, so among faces at exactly equal
t in two clusters another may win. A pixel whose color differs must show
such a tie on the plain version's own path (two faces at its nearest t,
found by testing every face), and the test prints each one; no other pixel
may differ. The first image row is replaced by rays that miss everything,
so the walk has to end on an empty stack there. The counters agree with
the plain version's paths: the warps' live lanes over their bounce rounds
are its ray-bounces, and every cluster visit lies below a visited node.
K6 must equal its plain
version bit for bit. The card itself is checked by chip_smoke.py and the
requires_cuda tests.
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
from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import prng, rng, trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import megakernel, pathtrace
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "mygpuraytracer_tpu_torch/csrc"
DEPTH = 8
ITERS = 2

HOST_STUB = r"""
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <functional>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define CUDART_INF_F INFINITY
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9;
inline int cudaGetLastError() { return 0; }
// The device: HOST_SMS multiprocessors holding HOST_BLOCKS_PER_SM blocks
// each, so a launch sized by the occupancy query gets a grid small enough
// that each lane runs several pixels.
constexpr int HOST_SMS = 1, HOST_BLOCKS_PER_SM = 4;
enum { cudaDevAttrMultiProcessorCount, cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = HOST_SMS; return cudaSuccess; }
template <typename F> cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) {
  *v = HOST_BLOCKS_PER_SM;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t bytes, cudaStream_t) {
  std::memset(p, v, bytes);
  return cudaSuccess;
}
// Blocks run one after another and so do a block's warps: a barrier holds
// only in blocks of one warp (the K1 host test launches those).
inline void __syncthreads() {}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;
struct float4 { float x, y, z, w; };
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
template <typename T> T atomicAdd(T* p, T v) {
  const T old = *p; *p += v; return old;
}
// A warp is 32 lanes on one host thread, each on its own stack (ucontext),
// taking turns at every warp-wide call: a lane posts its value and passes
// to the next lane; when the turn comes back, all 32 have posted, and it
// reads. Two slot banks by call parity keep a fast lane's next post from
// overwriting what a slow one still reads. A lane that reaches a call the
// others have not made marks the warp broken, and the launch reports it.
struct HostWarp {
  ucontext_t main_ctx, ctx[32];
  unsigned lane_x[32];
  uint64_t slot[2][32];
  long calls[32];
  bool done[32];
  int lane;
  bool broken;
  std::function<void()> body;
};
static HostWarp* host_warp = nullptr;
static void host_lane_main() { host_warp->body(); }
inline void host_yield() {
  HostWarp& w = *host_warp;
  const int from = w.lane;
  for (int k = 1; k < 32; ++k) {
    const int to = (from + k) % 32;
    if (w.done[to]) continue;
    w.lane = to;
    threadIdx.x = w.lane_x[to];
    swapcontext(&w.ctx[from], &w.ctx[to]);
    return;
  }
}
inline const uint64_t* host_post(uint64_t v) {
  HostWarp& w = *host_warp;
  const int me = w.lane;
  const long k = ++w.calls[me];
  w.slot[k & 1][me] = v;
  host_yield();
  for (int l = 0; l < 32; ++l) w.broken |= w.calls[l] < k;
  return w.slot[k & 1];
}
// Runs body() as the 32 lanes of one warp whose first thread is first_x;
// true if the lanes did not meet at every warp-wide call.
inline bool host_run_warp(std::function<void()> body, unsigned first_x) {
  constexpr size_t STACK = 1 << 18;
  static std::vector<char> stacks(32 * STACK);
  HostWarp w{};
  w.body = std::move(body);
  for (int l = 0; l < 32; ++l) {
    getcontext(&w.ctx[l]);
    w.ctx[l].uc_stack.ss_sp = stacks.data() + l * STACK;
    w.ctx[l].uc_stack.ss_size = STACK;
    w.ctx[l].uc_link = &w.main_ctx;
    makecontext(&w.ctx[l], host_lane_main, 0);
    w.lane_x[l] = first_x + l;
  }
  host_warp = &w;
  for (int next = 0; next >= 0;) {
    w.lane = next;
    threadIdx.x = w.lane_x[next];
    swapcontext(&w.main_ctx, &w.ctx[next]);
    w.done[w.lane] = true;  // that lane's body returned
    next = -1;
    for (int k = 1; k <= 32 && next < 0; ++k) {
      if (!w.done[(w.lane + k) % 32]) next = (w.lane + k) % 32;
    }
  }
  host_warp = nullptr;
  return w.broken;
}
inline int host_lane() { return host_warp->lane; }
template <typename T> T host_shfl(T v, int src) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  bits = host_post(bits)[src & 31];
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}
template <typename T> T __shfl_sync(unsigned, T v, int src) { return host_shfl(v, src); }
template <typename T> T __shfl_xor_sync(unsigned, T v, int m) { return host_shfl(v, host_lane() ^ m); }
inline unsigned __ballot_sync(unsigned, bool p) {
  const uint64_t* all = host_post(p ? 1ull << host_lane() : 0ull);
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out |= static_cast<unsigned>(all[l]);
  return out;
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const uint64_t* all = host_post(v);
  unsigned out = v;
  for (int l = 0; l < 32; ++l) out = std::min(out, static_cast<unsigned>(all[l]));
  return out;
}
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const uint64_t* all = host_post(v);
  unsigned out = 0;
  for (int l = 0; l < 32; ++l) out += static_cast<unsigned>(all[l]);
  return out;
}
// Outside the warp-wide calls the lanes run apart: each is its own active set.
inline unsigned __activemask() { return 1u << host_lane(); }
"""
# K5's launch: every warp of every block in turn, as 32 lanes (host_run_warp).
K5_LOOP = (
    r"(void)stream; blockDim.x = THREADS; bool host_broken = false;"
    r" for (int b_ = 0; b_ < blocks; ++b_) for (int w_ = 0; w_ < THREADS / 32; ++w_) {"
    r" blockIdx.x = b_; host_broken |= host_run_warp([&] { kernel(\1); }, w_ * 32); }"
    r" if (host_broken) return 99;")


def _host_build(tmp_path_factory, source: str, launch: re.Pattern, loop: str, name: str,
                replace: tuple[tuple[str, str], ...] = ()):
    """Compile ``source`` for the host under HOST_STUB, its launch rewritten
    by ``launch`` -> ``loop`` and each (old, new) of ``replace`` applied
    once; the loaded library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (CSRC / source).read_text()
    src = src.replace("#include <cuda_runtime.h>", HOST_STUB).replace("#include <math_constants.h>", "")
    src, count = launch.subn(loop, src)
    assert count == 1, f"the kernel launch in {source} changed; update this test"
    for old, new in replace:
        assert src.count(old) == 1, f"{old!r} in {source} changed; update this test"
        src = src.replace(old, new)
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
        re.compile(r"kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);",
                   re.S),
        K5_LOOP, "k5host")
    lib.k5_bounce.restype, lib.k5_bounce.argtypes = _build.SIGNATURES["k5_bounce"]
    return lib


@pytest.fixture(scope="module")
def host_k6(tmp_path_factory):
    lib = _host_build(
        tmp_path_factory, "prng.cu",
        re.compile(r"k6_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);",
                   re.S),
        r"(void)stream; gridDim = grid; blockDim.x = THREADS;"
        r" for (unsigned y_ = 0; y_ < grid.y; ++y_) for (unsigned b_ = 0; b_ < grid.x; ++b_)"
        r" for (int t_ = 0; t_ < THREADS; ++t_)"
        r" { blockIdx.x = b_; blockIdx.y = y_; threadIdx.x = t_; k6_kernel(\1); }", "k6host")
    lib.k6_uniforms.restype, lib.k6_uniforms.argtypes = _build.SIGNATURES["k6_uniforms"]
    return lib


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(name, res):
    s = load_scene(str(REPO / f"scenes/{name}.txt"))
    s.set_resolution(res, res)
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


def _exact_ties(meta, face_plane, o, d, t_cap) -> list[tuple[float, list[float]]]:
    """Per ray: (its nearest face t below t_cap, the geom ids of every face
    at exactly that t), testing every face with the plain version's
    arithmetic (ops/mesh_hit.py::mesh_hit_reference)."""
    f = face_plane[:, :meta.num_faces]
    ro, rd = torch.stack([o.x, o.y, o.z])[:, :, None], torch.stack([d.x, d.y, d.z])[:, :, None]
    t = (f[3] - mh._dot(ro, f[0:3])) / mh._clamp_eps(mh._dot(rd, f[0:3]))
    u = mh._dot(ro, f[4:7]) + t * mh._dot(rd, f[4:7]) - f[7]
    v = mh._dot(ro, f[8:11]) + t * mh._dot(rd, f[8:11]) - f[11]
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > mh.HIT_EPS) & (t < t_cap[:, None])
    t = torch.where(ok, t, torch.inf)
    best = t.min(dim=1).values
    return [(float(b), f[12, (row == b) & torch.isfinite(row)].tolist()) for b, row in zip(best, t)]


@pytest.mark.parametrize("res", [23, 24])  # a ragged last block; whole blocks
@pytest.mark.parametrize("mode", ["threefry", "pallas"])
@pytest.mark.parametrize("scene", ["cornellShip", "shipOnly"])
def test_host_build_of_k5_matches_plain(scene, mode, res, host_k5, monkeypatch):
    dev, meta = _scene(scene, res)
    assert megakernel._uses_bvh(meta)
    options = RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto")
    generate = _with_miss_row(pathtrace.generate_camera_rays)
    monkeypatch.setattr(pathtrace, "generate_camera_rays", generate)
    key = rng.make_key(5)
    n = res * res
    init = torch.rand((9, n), generator=torch.Generator().manual_seed(2))
    acc_k, acc_p = init.clone(), init.clone()
    visits = torch.zeros(n, dtype=torch.int32)
    stats = torch.zeros(megakernel.STATS, dtype=torch.int64)
    record = megakernel.scene_record(meta, dev.camera)
    fp, bounds = dev.face_plane, dev.cluster_bounds
    k = pathtrace.num_rng_streams(DEPTH)
    everyone = torch.ones(n, dtype=torch.bool)
    queries = []  # every mesh query of the plain side: its rays and their t_cap

    def query(o, d, active=None):
        active = everyone if active is None else active
        queries.append((o, d, trace.intersect_primitives_soa(meta, o, d).t, active))
        return trace.bvh_scene_hit_nearfar(meta, fp, o, d, active, bounds)

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
            assert not bool(first.hit[:res].any()) and bool(first.hit[res:].any())
        err = host_k5.k5_bounce(
            rays.data_ptr(), record.data_ptr(), dev.face_gather.data_ptr(),
            dev.cluster_tree.data_ptr(), acc_k.data_ptr(), visits.data_ptr(), stats.data_ptr(),
            n, DEPTH, it, int(mode == "pallas"), ikey[0], ikey[1], seed, bounds.shape[1],
            megakernel.tree_depth(bounds.shape[1]), None)
        assert err == 0
    differ = (acc_k[0:3] != acc_p[0:3]).any(dim=0).nonzero().squeeze(1)
    for p in differ.tolist():  # the one allowance: an exact-t tie on the plain path
        ties = [(t, gids) for o, d, t_cap, active in queries if bool(active[p])
                for t, gids in _exact_ties(meta, fp, Vec3(o.x[p:p + 1], o.y[p:p + 1], o.z[p:p + 1]),
                                           Vec3(d.x[p:p + 1], d.y[p:p + 1], d.z[p:p + 1]),
                                           t_cap[p:p + 1])
                if len(gids) > 1]
        assert ties, f"pixel {p} differs without an exact-t tie on its plain path"
        print(f"pixel {p} differs at an exact-t tie: t, geom ids of the tied faces {ties}")
    same = torch.ones(n, dtype=torch.bool)
    same[differ] = False
    assert torch.equal(acc_k[0:3, same], acc_p[0:3, same])
    assert float((acc_k[3:9, same] - acc_p[3:9, same]).abs().max()) < 1e-5
    assert torch.equal(acc_k[0:3, :res], init[0:3, :res])  # the missing row adds black
    nodes, walk_iters, rounds, ended = stats.tolist()
    total = int(visits.sum())
    assert total > 0 and nodes >= total
    assert walk_iters == nodes  # host lanes walk apart: each its own step
    if not len(differ):  # the same paths: live lane-rounds are the plain ray-bounces
        assert 32 * rounds - ended == sum(int(active.sum()) for *_, active in queries)
    assert 0 < ended < 32 * rounds


@pytest.mark.parametrize("seed", [0, -5, 2**31 - 1])
@pytest.mark.parametrize("k", [1, 7, 28])
def test_host_build_of_k6_matches_plain(seed, k, host_k6):
    n = 2048 + 333
    out = torch.full((k, n), float("nan"))
    assert host_k6.k6_uniforms(seed, out.data_ptr(), k, n, None) == 0
    assert torch.equal(out, prng.uniforms_reference(seed, k, n))
