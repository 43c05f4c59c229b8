"""K1's CUDA source, compiled for the host, against its plain version.

The CUDA kernel has no CPU mode. This test compiles csrc/megakernel.cu with
the host C++ compiler instead, under the warp stand-in of
tests/test_torch_k5_host.py: the CUDA built-ins as plain C++ (rsqrtf as
1/sqrtf, float4, the occupancy query of a device of one SM that holds 4
blocks), and each warp as 32 lanes on their own stacks that meet at each
warp-wide call (ballot, shuffle), so a collective that not every lane
reaches fails the launch (code 99) instead of hanging. Blocks are one warp
(a block's warps run one after another here, so a barrier holds only
within one warp), and the launch's grid is small, so each lane fetches
several pixels from the queue and starts a new path whenever one ends. What
it checks is the kernel's logic: the queue, the flat loop, the shared copy
of the record, RNG counters, raygen, intersection, shading and
accumulation. Built with -ffp-contract=off and exact 1/sqrt, the host build
must equal the plain PyTorch version bit for bit on the color, and within
1e-5 on the AOVs (a normalize may round once differently), whatever the
grid; the counting build's live lane-rounds must be the plain wavefront's
ray-bounces. The card itself (FMA contraction, its math library, block
sizes 64-256) is checked by chip_smoke.py and tests/test_torch_k1_cuda.py.
"""

import re

import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import rng
from mygpuraytracer_tpu_torch.render import megakernel, pathtrace
from mygpuraytracer_tpu_torch.scene import builtin, load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene
from test_torch_k5_host import REPO, _host_build

RES = 24
THREADS = 32  # one warp per block (see above)

# The launch: every warp of every block in turn, as 32 lanes (host_run_warp).
LAUNCH = re.compile(r"kernel<<<blocks, threads, smem, st>>>\((.*?)\);", re.S)
LOOP = (r"(void)st; blockDim.x = threads; bool host_broken = false;"
        r" for (int b_ = 0; b_ < blocks; ++b_) for (int w_ = 0; w_ < threads / 32; ++w_) {"
        r" blockIdx.x = b_; host_broken |= host_run_warp([&] { kernel(\1); }, w_ * 32); }"
        r" if (host_broken) return 99;")
# Dynamic shared memory: a static array on the host, as large as any record here.
SHARED = ("extern __shared__ float4 shared_rec[];", "static float4 shared_rec[1 << 14];")


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "megakernel.cu", LAUNCH, LOOP, "k1host", (SHARED,))
    lib.k1_accumulate.restype, lib.k1_accumulate.argtypes = _build.SIGNATURES["k1_accumulate"]
    return lib


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cube(d, res):
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
    s.set_resolution(res, res)
    return s


cornell = lambda d, res: builtin.cornell_box(resolution=(res, res))
glass = lambda d, res: builtin.cornell_glass(resolution=(res, res))

# name: (scene, options, start iteration, iterations, resolution, blocks per SM)
CASES = {
    "cornell": (cornell, {}, 1, 3, RES, 0),
    "cornellGlass": (glass, {}, 1, 3, RES, 0),
    "dof": (cornell, {"depth_of_field": True}, 1, 3, RES, 0),
    "noAA": (glass, {"antialiasing": False, "cache_first_bounce": False}, 1, 3, RES, 0),
    "cubeObj": (_cube, {}, 1, 3, RES, 0),
    "glassFrom4": (glass, {}, 4, 3, RES, 0),
    # one block of 32 lanes: each lane runs 18 pixels
    "oneBlock": (glass, {}, 1, 3, RES, 1),
    # 529 pixels: the queue runs dry in the middle of a warp
    "ragged23": (glass, {}, 1, 3, 23, 0),
    "oneIteration": (glass, {}, 1, 1, RES, 0),
}


def _scene(case, tmp_path):
    make, opts, start, iters, res, blocks_per_sm = CASES[case]
    dev, meta = build_device_scene(make(tmp_path, res), device="cpu")
    return dev, meta, RenderOptions(megakernel=True, **opts), start, iters, blocks_per_sm


def _launch(lib, dev, meta, options, acc, start, iters, key, blocks_per_sm, stats=None):
    width, height = meta.resolution
    record = megakernel.scene_record(meta, dev.camera)
    queue = torch.full((1,), 12345, dtype=torch.int32)  # the launch zeroes it
    err = lib.k1_accumulate(
        record.data_ptr(), acc.data_ptr(), queue.data_ptr(),
        stats.data_ptr() if stats is not None else None, meta.num_geoms, len(meta.mega_faces),
        width * height, width, height, meta.trace_depth, start, iters, key[0], key[1],
        int(options.antialiasing), int(options.depth_of_field), options.lens_radius,
        options.focal_distance, THREADS, blocks_per_sm, None)
    assert err == 0
    return int(queue[0])


def _plain_with_bounces(dev, meta, options, acc, start, iters, key, monkeypatch):
    """The plain version into ``acc``; its ray-bounces per pixel: the lanes
    each scene query of the wavefront tests (all at bounce 0, the live
    paths after)."""
    n = meta.resolution[0] * meta.resolution[1]
    bounces = torch.zeros(n, dtype=torch.int64)
    query = pathtrace.intersect_soa

    def counted(meta_, dev_, o, d, *args, active=None, **kwargs):
        bounces.add_(1 if active is None else active.long())
        return query(meta_, dev_, o, d, *args, active=active, **kwargs)

    monkeypatch.setattr(pathtrace, "intersect_soa", counted)
    megakernel.megakernel_accumulate_reference(dev, meta, options, acc, start, iters, key)
    return bounces


@pytest.mark.parametrize("case", list(CASES))
def test_host_build_of_k1_matches_plain(case, host_k1, tmp_path):
    dev, meta, options, start, iters, blocks_per_sm = _scene(case, tmp_path)
    key = rng.make_key(9)
    n = meta.resolution[0] * meta.resolution[1]
    init = torch.rand((9, n), generator=torch.Generator().manual_seed(1))
    acc_k, acc_p = init.clone(), init.clone()
    fetched = _launch(host_k1, dev, meta, options, acc_k, start, iters, key, blocks_per_sm)
    assert fetched >= n  # every pixel was taken from the queue
    megakernel.megakernel_accumulate_reference(dev, meta, options, acc_p, start, iters, key)
    assert torch.equal(acc_k[0:3], acc_p[0:3])
    assert float((acc_k[3:9] - acc_p[3:9]).abs().max()) < 1e-5
    if start > 1:  # no first hit of iteration 1 in this batch: the AOVs stay
        assert torch.equal(acc_k[3:9], init[3:9])


@pytest.mark.parametrize("case", ["cornellGlass", "ragged23"])
def test_host_k1_grids_and_counters(case, host_k1, tmp_path, monkeypatch):
    """Two grid sizes and the counting build give the same accumulators bit
    for bit; the counters agree with the plain version's paths."""
    dev, meta, options, start, iters, _ = _scene(case, tmp_path)
    key = rng.make_key(4)
    n = meta.resolution[0] * meta.resolution[1]
    init = torch.rand((9, n), generator=torch.Generator().manual_seed(3))
    runs = {}
    for blocks_per_sm, counting in ((1, False), (3, False), (0, True)):
        acc = init.clone()
        stats = torch.zeros(megakernel.K1_STATS, dtype=torch.int64) if counting else None
        _launch(host_k1, dev, meta, options, acc, start, iters, key, blocks_per_sm, stats)
        runs[blocks_per_sm] = acc, stats
    assert torch.equal(runs[1][0], runs[3][0]) and torch.equal(runs[1][0], runs[0][0])
    acc_p = init.clone()
    bounces = _plain_with_bounces(dev, meta, options, acc_p, start, iters, key, monkeypatch)
    assert torch.equal(runs[0][0][0:3], acc_p[0:3])
    rounds, live, raygens, raygen_rounds, fetches, atomics, tail = runs[0][1].tolist()
    lanes = THREADS * min(4, -(-n // THREADS))  # the grid: 4 blocks of 32 lanes
    assert live == int(bounces.sum())  # the same paths: live lane-rounds are the ray-bounces
    assert raygens == n * iters and fetches == n
    assert raygens / 32 <= raygen_rounds <= min(raygens, rounds)
    assert lanes // 32 <= atomics <= fetches + lanes
    assert 0 < tail < rounds and live <= 32 * rounds
