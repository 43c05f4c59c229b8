"""K1 on the card against its plain version, for the paths chip_smoke.py
does not drive: listed mesh faces, depth of field, batches that start past
iteration 1. Besides: block sizes 64/128/256 and grids of other sizes give
the same accumulators bit for bit (which lane takes which pixel from the
queue changes nothing), so do repeated launches, and the counting build's
live lane-rounds are the plain wavefront's ray-bounces within 1e-4 relative
(a path that branches the other way under the kernel's rounding may bounce
a different number of times).

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k1_cuda.py
Without a CUDA device every case skips. Tolerance (chip_smoke.py's bars):
under 1% of pixels whose mean color or first-hit AOVs differ by more than
1e-2, and rmse < 1e-3 over the other pixels. The kernel contracts
multiply-adds and rounds rsqrt differently, so a ray at an edge can take the
other geom and its path diverges.
"""

import pathlib

import pytest
import torch

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import rng
from mygpuraytracer_tpu_torch.render import megakernel, pathtrace
from mygpuraytracer_tpu_torch.scene import builtin, load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 96


def _cube_scene(d: pathlib.Path):
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
    scene = load_scene(str(d / "cube.txt"))
    scene.set_resolution(RES, RES)
    return scene


CASES = {
    "cubeObj": (_cube_scene, {}, 1),
    "dof": (lambda d: builtin.cornell_box(resolution=(RES, RES)), {"depth_of_field": True}, 1),
    "glassFrom5": (lambda d: builtin.cornell_glass(resolution=(RES, RES)), {}, 5),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(CASES))
def test_k1_matches_plain(case, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    make, opts, start = CASES[case]
    dev, meta = build_device_scene(make(tmp_path), device="cuda")
    options = RenderOptions(megakernel=True, **opts)
    assert megakernel.supports_megakernel(meta, options)
    key = rng.make_key(3)
    iters = 8
    acc_k = torch.zeros((9, RES * RES), device="cuda")
    acc_p = torch.zeros_like(acc_k)
    megakernel.megakernel_accumulate(dev, meta, options, acc_k, start, iters, key)
    megakernel.megakernel_accumulate_reference(dev, meta, options, acc_p, start, iters, key)
    torch.cuda.synchronize()
    # mean images: under 1% of pixels off by more than 1e-2 (paths that
    # branch the other way under the kernel's rounding), rmse < 1e-3 over the rest
    d = ((acc_k[0:3] - acc_p[0:3]) / iters).abs().amax(dim=0)
    agree = d <= 1e-2
    assert float((~agree).float().mean()) < 0.01
    assert float(d[agree].pow(2).mean().sqrt()) < 1e-3
    # AOVs: under 1% of pixels off by more than 1e-2 (edge pixels whose first
    # hit changes geom under the kernel's rounding; chip_smoke.py's bar)
    off = ((acc_k[3:9] - acc_p[3:9]).abs() > 1e-2).any(dim=0).float().mean()
    assert float(off) < 0.01
    assert bool(torch.isfinite(acc_k).all()) and float(acc_k[0:3].mean()) > 0


@pytest.mark.requires_cuda
def test_k1_wrapper_rejects_bad_accumulator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev, meta = build_device_scene(builtin.cornell_box(resolution=(8, 8)), device="cuda")
    opts = RenderOptions(megakernel=True)
    for bad in (torch.zeros((9, 64), device="cuda", dtype=torch.float64),
                torch.zeros((9, 63), device="cuda"),
                torch.zeros((64, 9), device="cuda").t()):
        with pytest.raises(ValueError):
            megakernel.megakernel_accumulate(dev, meta, opts, bad, 1, 1, rng.make_key(0))


def _cornell_glass(device="cuda"):
    dev, meta = build_device_scene(builtin.cornell_glass(resolution=(RES, RES)), device=device)
    return dev, meta, RenderOptions(megakernel=True)


@pytest.mark.requires_cuda
def test_k1_launch_shapes_and_repeats_are_bitwise_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    dev, meta, options = _cornell_glass()
    key = rng.make_key(7)
    accs = {}
    for threads, blocks_per_sm in ((64, 0), (128, 0), (256, 0), (128, 1), (0, 0), (0, 0)):
        acc = torch.zeros((9, RES * RES), device="cuda")
        megakernel.megakernel_accumulate(dev, meta, options, acc, 1, 4, key, threads=threads,
                                         blocks_per_sm=blocks_per_sm)
        accs.setdefault((threads, blocks_per_sm), []).append(acc)
    torch.cuda.synchronize()
    first = accs[64, 0][0]
    assert bool(torch.isfinite(first).all()) and float(first[0:3].mean()) > 0
    for runs in accs.values():
        for acc in runs:
            assert torch.equal(acc, first)


@pytest.mark.requires_cuda
def test_k1_counting_build_live_lanes_are_plain_ray_bounces(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    dev, meta, options = _cornell_glass()
    key, iters, n = rng.make_key(11), 8, RES * RES
    acc = torch.zeros((9, n), device="cuda")
    stats = torch.zeros(megakernel.K1_STATS, dtype=torch.int64, device="cuda")
    megakernel.megakernel_accumulate(dev, meta, options, acc, 1, iters, key, stats=stats)
    rounds, live, raygens, raygen_rounds, fetches, atomics, tail = stats.tolist()
    bounces = [0]
    query = pathtrace.intersect_soa

    def counted(meta_, dev_, o, d, *args, active=None, **kwargs):
        bounces[0] += n if active is None else int(active.sum())
        return query(meta_, dev_, o, d, *args, active=active, **kwargs)

    monkeypatch.setattr(pathtrace, "intersect_soa", counted)
    megakernel.megakernel_accumulate_reference(dev, meta, options, torch.zeros_like(acc), 1,
                                               iters, key)
    assert abs(live - bounces[0]) <= 1e-4 * bounces[0]
    assert raygens == n * iters and fetches == n
    assert raygens / 32 <= raygen_rounds <= min(raygens, rounds)
    assert 0 < atomics <= fetches + 32 * rounds and 0 <= tail < rounds
    assert live <= 32 * rounds
