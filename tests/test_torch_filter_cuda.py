"""The Filter API on the card: the single pass against the monitored
per-tile path, in place, DeviceBuffers against host arrays, and the card
against the CPU.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_filter_cuda.py
Without a CUDA device every case skips: ``Device()`` means CUDA and has no
CPU fallback. Tolerances: the port's own paths on one device agree within
atol 1e-6 (the same convolutions on the same windows); the card's float32
net (TF32 off) against the CPU's within atol 1e-5, rtol 1e-4 (summation
order only).
"""

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.denoise import Device, DeviceBuffer, OidnError

PATH_ATOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: Device() runs on CUDA only")
    dev = Device()
    dev.commit()
    return dev


def rand(seed, h, w, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * np.random.default_rng(seed).random((h, w, 3))).astype(np.float32)


def run(dev, images, monitored=False, inplace=False, buffers=False, f32=False, **params):
    f = dev.new_filter("RT")
    if f32:
        f._network_dtype = lambda: torch.float32
    wrap = (lambda a: DeviceBuffer(a, dev.torch_device)) if buffers else np.copy
    attached = {n: wrap(img) for n, img in images.items()}
    for name, img in attached.items():
        f.set_image(name, img)
    h, w = images["color"].shape[:2]
    out = attached["color"] if inplace else wrap(np.zeros((h, w, 3), np.float32))
    f.set_image("output", out)
    for k, v in params.items():
        f.set(k, v)
    if monitored:
        f.set_progress_monitor_function(lambda p: True)
    f.commit()
    f.execute()
    return out.numpy() if buffers else out


def images(h, w, normal=True):
    out = {"color": rand(1, h, w, 0.0, 4.0), "albedo": rand(2, h, w)}
    if normal:
        out["normal"] = rand(3, h, w, -1.0, 1.0)
    return out


@pytest.mark.requires_cuda
def test_default_device_is_cuda(card):
    assert card.torch_device.type == "cuda"
    with pytest.raises(OidnError) as ei:
        card.new_filter("RT").set_image("color", DeviceBuffer(np.zeros((4, 4, 3)), "cpu"))
    assert ei.value.code == OidnError.INVALID_ARGUMENT


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("max_mem", [0, 3000])
def test_single_pass_matches_monitored(card, f32, max_mem):
    # Sizes on the 16-pixel alignment: in one tile off it, the two paths pad
    # a normal differently, as the JAX package's do (test_torch_filter_tiles.py).
    imgs = images(704, 608)
    single = run(card, imgs, f32=f32, hdr=True, maxMemoryMB=max_mem)
    monitored = run(card, imgs, monitored=True, f32=f32, hdr=True, maxMemoryMB=max_mem)
    assert np.isfinite(single).all()
    np.testing.assert_allclose(single, monitored, atol=PATH_ATOL, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("monitored", [False, True])
def test_inplace_matches_out_of_place(card, monitored):
    imgs = images(700, 610, normal=False)
    ref = run(card, imgs, monitored=monitored, maxMemoryMB=0)
    got = run(card, imgs, monitored=monitored, inplace=True, maxMemoryMB=0)
    np.testing.assert_allclose(got, ref, atol=PATH_ATOL, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("max_mem,monitored,inplace", [
    (3000, False, False), (0, False, False), (0, True, False), (0, False, True)],
    ids=["single-tile", "tiled", "tiled-monitored", "tiled-inplace"])
def test_device_buffer_matches_host(card, max_mem, monitored, inplace):
    imgs = images(540, 960)
    host = run(card, imgs, hdr=True, maxMemoryMB=max_mem, monitored=monitored)
    got = run(card, imgs, buffers=True, inplace=inplace, hdr=True, maxMemoryMB=max_mem,
              monitored=monitored)
    np.testing.assert_allclose(got, host, atol=PATH_ATOL, rtol=0)


@pytest.mark.requires_cuda
def test_single_pass_does_not_synchronise(card):
    """DeviceBuffers in and out, tiled, autoexposure: the execute makes no
    synchronising call (torch.cuda's sync debug mode raises on one)."""
    f = card.new_filter("RT")
    for name, img in images(700, 610).items():
        f.set_image(name, DeviceBuffer(img, card.torch_device))
    obuf = DeviceBuffer(np.zeros((700, 610, 3), np.float32), card.torch_device)
    f.set_image("output", obuf)
    f.set("hdr", True)
    f.set("maxMemoryMB", 0)
    f.commit()
    f.execute()  # warm-up: cuDNN's first calls
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f.execute()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(obuf.numpy()).all()


@pytest.mark.requires_cuda
def test_card_f32_matches_cpu(card):
    imgs = images(400, 300)
    cpu = Device("cpu")
    cpu.commit()
    got = run(card, imgs, f32=True, maxMemoryMB=0)
    want = run(cpu, imgs, maxMemoryMB=0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
