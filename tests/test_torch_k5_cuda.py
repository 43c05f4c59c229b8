"""K5 on the card against its plain version, and the Renderer's route to it.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k5_cuda.py
Without a CUDA device every case skips: the kernel has no CPU mode.
Tolerance (K1's, chip_smoke.py's bars), at 128x128 over 4 iterations:
under 1% of pixels whose mean color or first-hit AOVs differ by more than
1e-2, and rmse < 1e-3 over the other pixels. The kernel contracts
multiply-adds in the primitive tests and shade and rounds rsqrt otherwise,
and its near-to-far tree walk may find a face whose t rounds below its own
box's entry where the ascending plain walk does not, so a few paths may
diverge. The counting build changes nothing in the image,
and the walk's counters (clusters tested per ray, tree nodes, warp
traversal iterations, warp bounce rounds, lanes of ended paths) are
consistent: every visit lies below a visited node, and every pixel's first
bounce is a live lane-round.
"""

import pathlib

import pytest
import torch

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prng, rng
from mygpuraytracer_tpu_torch.render import Renderer, megakernel, pathtrace
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 128
OPTIONS = RenderOptions(megakernel=True, bounce_megakernel=True)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")


def _scene(name):
    s = load_scene(str(REPO / f"scenes/{name}.txt"))
    s.set_resolution(RES, RES)
    return s


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["threefry", "auto"])
@pytest.mark.parametrize("name", ["cornellShip", "shipOnly"])
def test_k5_matches_plain(name, mode):
    _need_cuda()
    dev, meta = build_device_scene(_scene(name), device="cuda")
    options = RenderOptions(megakernel=True, bounce_megakernel=True, rng=mode)
    key = rng.make_key(3)
    iters = 4
    acc_k = torch.zeros((9, RES * RES), device="cuda")
    acc_p = torch.zeros_like(acc_k)
    visits = torch.zeros(RES * RES, dtype=torch.int32, device="cuda")
    before = megakernel.BOUNCE_LAUNCHES
    megakernel.bvh_bounce_accumulate(dev, meta, options, acc_k, 1, iters, key, visits=visits)
    uncounted = torch.zeros_like(acc_k)
    megakernel.bvh_bounce_accumulate(dev, meta, options, uncounted, 1, iters, key)
    assert torch.equal(uncounted, acc_k)  # the counting build (visits) gives the same image
    megakernel.bvh_bounce_accumulate_reference(dev, meta, options, acc_p, 1, iters, key)
    torch.cuda.synchronize()
    assert megakernel.BOUNCE_LAUNCHES == before + 2 * iters
    d = ((acc_k[0:3] - acc_p[0:3]) / iters).abs().amax(dim=0)
    agree = d <= 1e-2
    assert float((~agree).float().mean()) < 0.01
    assert float(d[agree].pow(2).mean().sqrt()) < 1e-3
    off = ((acc_k[3:9] - acc_p[3:9]).abs() > 1e-2).any(dim=0).float().mean()
    assert float(off) < 0.01
    assert bool(torch.isfinite(acc_k).all()) and float(acc_k[0:3].mean()) > 0
    assert int(visits.sum()) > 0


@pytest.mark.requires_cuda
def test_renderer_routes_big_meshes_to_k5_and_k6():
    _need_cuda()
    r = Renderer(_scene("cornellShip"), RenderOptions(megakernel=True, bounce_megakernel=True,
                                                      rng="auto"), device="cuda")
    assert r.use_megakernel and megakernel._uses_bvh(r.meta)
    k5, k6, k1 = megakernel.BOUNCE_LAUNCHES, prng.LAUNCHES, megakernel.LAUNCHES
    img = r.render(iterations=3, batch=2)
    assert (megakernel.BOUNCE_LAUNCHES - k5, prng.LAUNCHES - k6) == (3, 3)
    assert megakernel.LAUNCHES == k1
    assert img.shape == (RES, RES, 3) and img.mean() > 1e-3
    default = Renderer(_scene("cornellShip"), RenderOptions(megakernel=True), device="cuda")
    assert not default.use_megakernel  # bounce_megakernel stays opt-in


@pytest.mark.requires_cuda
def test_k5_wrapper_rejects_bad_input():
    _need_cuda()
    dev, meta = build_device_scene(_scene("shipOnly"), device="cuda")
    for bad in (torch.zeros((9, RES * RES), device="cuda", dtype=torch.float64),
                torch.zeros((9, RES * RES - 1), device="cuda")):
        with pytest.raises(ValueError):
            megakernel.bvh_bounce_accumulate(dev, meta, OPTIONS, bad, 1, 1, rng.make_key(0))
    with pytest.raises(ValueError):  # not opted in
        megakernel.bvh_bounce_accumulate(dev, meta, RenderOptions(megakernel=True),
                                         torch.zeros((9, RES * RES), device="cuda"), 1, 1,
                                         rng.make_key(0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["cornellShip", "shipOnly"])
def test_k5_counters(name):
    _need_cuda()
    r = Renderer(_scene(name), OPTIONS, device="cuda")
    n = RES * RES
    ikey = rng.iteration_key(r.base_key, 1)
    U = prng.iteration_uniforms(OPTIONS, ikey, 1, 4, n, "cuda")
    o, d = pathtrace.generate_camera_rays(r.dev.camera, r.meta.resolution, OPTIONS, U)
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])
    acc = torch.zeros((9, n), device="cuda")
    visits = torch.zeros(n, dtype=torch.int32, device="cuda")
    stats = torch.zeros(megakernel.STATS, dtype=torch.int64, device="cuda")
    megakernel.bounce_launch(r.dev, r.meta, OPTIONS, acc, rays, 1, ikey, r.record, visits, stats)
    default = torch.zeros_like(acc)
    megakernel.bounce_launch(r.dev, r.meta, OPTIONS, default, rays, 1, ikey, r.record)
    torch.cuda.synchronize()
    assert torch.equal(acc, default)  # the counting build changes nothing
    total = int(visits.sum())
    nodes, walk_iters, rounds, ended = stats.tolist()
    assert 0 < total <= nodes <= 32 * walk_iters  # every visit lies below a visited node
    assert 0 <= ended < 32 * rounds and 32 * rounds - ended >= n  # every pixel's bounce 0 is live
