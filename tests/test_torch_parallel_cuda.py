"""The multi-device paths on the card, over the mesh ("cuda:0", "cuda:0"):
one card named twice, so the split, the per-device launches and the merge
run as on a mesh of two cards (this measures semantics, not scaling).

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_cuda.py
Without a CUDA device every case skips.

Tolerances: the pixel mode through K1 bit for bit against a sequential
render of one iteration per launch (a lane reads and writes a pixel's sums
once per launch, so both sides must launch per iteration), and through K5
and the wavefront bit for bit against the single-device render; the sample
mode rtol and atol 1e-4 (the JAX tests' bar: K1's sums over a device's
iterations round in another order); the Filter's mesh bit for bit against
the single-device execute (every pixel has one writer).
"""

import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.denoise import Device, DeviceBuffer
from mygpuraytracer_tpu_torch.parallel import (make_mesh, render_multichip_sample,
                                               sharded_render_step)
from mygpuraytracer_tpu_torch.parallel.mesh import replicate
from mygpuraytracer_tpu_torch.render import Renderer, megakernel
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 96


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_mesh(devices=("cuda:0", "cuda:0"))


def _ship(name):
    s = load_scene(str(REPO / f"scenes/{name}.txt"))
    s.set_resolution(RES, RES)
    return s


CASES = {
    "k1": (lambda: cornell_box(resolution=(RES, RES)), dict(megakernel=True), 4),
    "k5": (lambda: _ship("cornellShip"),
           dict(megakernel=True, bounce_megakernel=True, rng="auto"), 2),
    "wavefront": (lambda: _ship("cornellShipTex"), {}, 1),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(CASES))
def test_pixel_mode_is_bitwise_the_single_device(case, mesh):
    make, opts, iters = CASES[case]
    r = Renderer(make(), RenderOptions(**opts), seed=3, device="cuda")
    step_fn, make_state = sharded_render_step(r.meta, r.options, mesh)
    image, albedo, cache = make_state()
    devs = replicate(r.dev, mesh)
    launches = megakernel.LAUNCHES + megakernel.BOUNCE_LAUNCHES
    for it in range(1, iters + 1):
        image, albedo, cache = step_fn(devs, image, albedo, cache, it, r.base_key)
    if case != "wavefront":  # one launch per device and iteration
        assert megakernel.LAUNCHES + megakernel.BOUNCE_LAUNCHES - launches == 2 * iters
    for _ in range(iters):
        r.step()  # one iteration per launch, as the step
    assert torch.equal(torch.cat(image.base, dim=1), r.acc)


@pytest.mark.requires_cuda
def test_sample_mode_matches_the_sequential_render(mesh):
    r = Renderer(cornell_box(resolution=(RES, RES)), RenderOptions(megakernel=True), seed=5,
                 device="cuda")
    launches = megakernel.LAUNCHES
    img, alb, nrm = render_multichip_sample(r.dev, r.meta, r.options, r.base_key, 16, mesh)
    assert megakernel.LAUNCHES - launches == 2  # one K1 launch per device
    r.render(16)
    np.testing.assert_allclose(torch.stack(img).cpu().numpy(), r.acc[0:3].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.stack([*alb, *nrm]), r.acc[3:9])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("max_mem", [0, 3000])
def test_filter_mesh_is_bitwise_the_single_device(mesh, max_mem):
    g = np.random.default_rng(1)
    h, w = 600, 1000
    images = {"color": g.random((h, w, 3), np.float32) * 4,
              "albedo": g.random((h, w, 3), np.float32),
              "normal": g.random((h, w, 3), np.float32) * 2 - 1}
    dev = Device()
    dev.commit()
    outs = []
    for m in (None, mesh):
        f = dev.new_filter("RT")
        for name, img in images.items():
            f.set_image(name, DeviceBuffer(img))
        out = DeviceBuffer(np.zeros((h, w, 3), np.float32))
        f.set_image("output", out)
        f.set("hdr", True)
        f.set("maxMemoryMB", max_mem)
        f.set("mesh", m)
        f.commit()
        f.execute()
        outs.append(out.array)
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[0], outs[1])
