"""The plain reference against the port at a tiny size on the CPU: the
render bit for bit (the same operations in the same order), the U-Net
against the port's Filter in float32, the PNG and TZA readers against the
port's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench.reference import pathtrace as ref_pt
from rtbench.reference import scene as ref_scene
from rtbench.reference import unet as ref_unet

SHIP_OPTIONS = dict(megakernel=True, mesh_pallas=True, winner_table="oct", mesh_sort="need")


def port_acc(path, res, iters, seed, options):
    from mygpuraytracer_tpu_torch.config import RenderOptions
    from mygpuraytracer_tpu_torch.render import Renderer
    from mygpuraytracer_tpu_torch.scene import load_scene

    scene = load_scene(path)
    scene.set_resolution(res, res)
    r = Renderer(scene, RenderOptions(**options), seed=seed, device="cpu")
    r.step_many(iters)
    return r.acc.numpy()


def ref_acc(path, res, iters, seed, pixels=None):
    scene = ref_scene.load_scene(path)
    ref_scene.set_resolution(scene, res, res)
    tracer = ref_pt.Tracer(scene, "cpu")
    pix = torch.arange(res * res) if pixels is None else torch.as_tensor(pixels)
    total, albedo, segments = tracer.render(pix, 1, iters, seed)
    return total.numpy(), albedo.numpy(), segments


@pytest.mark.parametrize("path,res,iters,options", [
    ("scenes/builtin_cornell.txt", 16, 3, dict(megakernel=True)),
    ("scenes/cornellShipTex.txt", 12, 2, SHIP_OPTIONS),
], ids=["cornell_k1", "shiptex_wavefront"])
def test_render_bit_for_bit(in_repo, path, res, iters, options):
    torch.set_num_threads(2)
    acc = port_acc(path, res, iters, 4242, options)
    total, albedo, segments = ref_acc(path, res, iters, 4242)
    assert np.array_equal(total, acc[0:3])
    assert np.array_equal(albedo, acc[3:6])
    assert res * res * iters <= segments <= res * res * iters * 8


def test_render_at_sampled_pixels_equals_the_whole_image(in_repo):
    total, albedo, _ = ref_acc("scenes/builtin_cornell.txt", 16, 2, 7)
    pix = np.array([0, 17, 100, 255])
    t2, a2, _ = ref_acc("scenes/builtin_cornell.txt", 16, 2, 7, pix)
    assert np.array_equal(t2, total[:, pix]) and np.array_equal(a2, albedo[:, pix])


def test_control_render_is_bfloat16(in_repo):
    scene = ref_scene.load_scene("scenes/builtin_cornell.txt")
    ref_scene.set_resolution(scene, 8, 8)
    total, _, _ = ref_pt.Tracer(scene, "cpu", torch.bfloat16).render(torch.arange(64), 1, 2, 3)
    assert total.dtype == torch.bfloat16


def test_unet_matches_the_port_filter_in_float32(in_repo):
    from mygpuraytracer_tpu_torch.apps.raytrace import denoise_beauty

    rng = np.random.default_rng(0)
    color = rng.uniform(0, 1.5, (32, 48, 3)).astype(np.float32)
    albedo = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    port, _ = denoise_beauty(color, albedo, "cpu")
    net = ref_unet.UNet(ref_unet.read_tza("weights/rt_ldr_alb.tza"), "cpu")
    ref = ref_unet.denoise(net, color, albedo, "cpu")
    assert np.abs(port - ref).max() < 1e-5
    ctrl = ref_unet.denoise(ref_unet.UNet(ref_unet.read_tza("weights/rt_ldr_alb.tza"), "cpu",
                                          ref_unet.fp8), color, albedo, "cpu")
    assert np.abs(ctrl - ref).max() > 1e-3


def test_readers_agree_with_the_port(in_repo):
    from mygpuraytracer_tpu_torch.denoise.tza import read_tza
    from mygpuraytracer_tpu_torch.utils.png import load_texture

    for name in ("kd", "ks", "ke", "bump"):
        path = f"scenes/textures/ship_{name}.png"
        assert np.array_equal(ref_scene.read_map(path), load_texture(path, flip_vertical=True))
    ours = ref_unet.read_tza("weights/rt_ldr_alb.tza")
    theirs = read_tza("weights/rt_ldr_alb.tza")
    assert set(ours) == set(theirs)
    assert all(np.array_equal(ours[k], theirs[k][0].astype(np.float32)) for k in ours)


def test_oct8_round_trip_is_close():
    v = np.random.default_rng(1).normal(size=(100, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    back = ref_scene.oct8_decode(*ref_scene.oct8(v))
    assert np.abs(back - v).max() < 0.03
