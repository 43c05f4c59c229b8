"""The port's tiled execute against the JAX package's, on the CPU: progress
and cancel, in place, the single pass against the monitored per-tile path,
and DeviceBuffers (CPU tensors here) against host arrays.

Mirrors ``tests/test_denoise.py:378-458,586-741``. The port against JAX:
atol 1e-5, rtol 1e-4 (the port's U-Net bar). The port's own paths against
each other: atol 1e-6 (JAX's bar for the same comparison), or equal where
JAX's test asks for equality. ``maxMemoryMB=0`` forces the 288-pixel
minimum tile, so these small images run several tiles.
"""

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu.denoise import Device as JaxDevice
from mygpuraytracer_tpu.denoise import DeviceBuffer as JaxDeviceBuffer
from mygpuraytracer_tpu.denoise import OidnError as JaxOidnError

from mygpuraytracer_tpu_torch.denoise import Device, DeviceBuffer, OidnError

ATOL, RTOL = 1e-5, 1e-4
PATH_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def rand(seed, h, w, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * np.random.default_rng(seed).random((h, w, 3))).astype(np.float32)


def run(dev, images: dict, kind="RT", monitored=False, inplace=False, buffers=False, **params):
    """Denoise copies of ``images`` on ``dev``; returns the output as a host
    array. ``buffers``: every image a DeviceBuffer; ``inplace``: the output
    is the first input; ``monitored``: a progress monitor forces the
    per-tile host path."""
    jax_side = isinstance(dev, JaxDevice)
    wrap = (lambda a: JaxDeviceBuffer(a)) if jax_side else (lambda a: DeviceBuffer(a, "cpu"))
    f = dev.new_filter(kind)
    attached = {n: wrap(img) if buffers else img.copy() for n, img in images.items()}
    for name, img in attached.items():
        f.set_image(name, img)
    first = next(iter(attached.values()))
    h, w = first.shape[:2]
    out = first if inplace else (wrap(np.zeros((h, w, 3), np.float32)) if buffers
                                 else np.zeros((h, w, 3), np.float32))
    f.set_image("output", out)
    for k, v in params.items():
        f.set(k, v)
    if monitored:
        f.set_progress_monitor_function(lambda p: True)
    f.commit()
    f.execute()
    return out.numpy() if buffers else out


def jax_and_port(images, **kw):
    jd, pd = JaxDevice(), Device("cpu")
    jd.commit()
    pd.commit()
    return run(jd, images, **kw), run(pd, images, **kw)


def port(images, **kw):
    pd = Device("cpu")
    pd.commit()
    return run(pd, images, **kw)


def assert_parity(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_progress_and_cancel_match_jax():
    """The same progress values as JAX's, monotone from 0 to 1; a monitor
    that returns False at 0.5 cancels with the same code, recorded on the
    device (oidnTest.cpp:378-458)."""
    h, w = 400, 344  # 3x2 tiles at maxMemoryMB=0
    seqs, codes = [], []
    for dev in (JaxDevice(), Device("cpu")):
        dev.commit()
        seen = []
        f = dev.new_filter("RT")
        f.set_image("color", rand(0, h, w))
        f.set_image("albedo", rand(1, h, w))
        f.set_image("output", np.zeros((h, w, 3), np.float32))
        f.set("maxMemoryMB", 0)
        f.set_progress_monitor_function(lambda p: seen.append(p) or True)
        f.commit()
        f.execute()
        calls = []
        f.set_progress_monitor_function(lambda p: calls.append(p) or p < 0.5)
        with pytest.raises((OidnError, JaxOidnError)) as ei:
            f.execute()
        seqs.append((seen, calls))
        codes.append((ei.value.code, dev.get_error()[0]))
    assert seqs[1] == seqs[0]
    seen = seqs[1][0]
    assert seen[0] == 0.0 and seen[-1] == 1.0 and len(seen) == 3 * 2 + 2
    assert all(b >= a for a, b in zip(seen, seen[1:]))
    assert codes[1] == codes[0] == (OidnError.CANCELLED, OidnError.CANCELLED)


def test_inplace_matches_out_of_place():
    """Output = color buffer equals out of place: tiled single pass, single
    tile, and the monitored path's outputTemp/outputCopy
    (core/unet.cpp:455-460,187-189); and the same pixels as JAX's."""
    images = {"color": rand(3, 400, 200)}
    for max_mem, monitored in ((0, False), (3000, False), (0, True)):
        ref = port(images, maxMemoryMB=max_mem, monitored=monitored)
        got = port(images, maxMemoryMB=max_mem, monitored=monitored, inplace=True)
        np.testing.assert_array_equal(got, ref)
    want, got = jax_and_port(images, maxMemoryMB=0, inplace=True)
    assert_parity(got, want)


@pytest.mark.parametrize("case", [
    dict(shape=(520, 344), features=("color", "albedo"), params={}),
    dict(shape=(400, 200), features=("color", "albedo", "normal"), params={"hdr": True}),
    dict(shape=(300, 420), features=("color",), params={"hdr": True, "inputScale": 0.5}),
    dict(shape=(300, 290), features=("color",), params={"directional": True},
         kind="RTLightmap"),
    dict(shape=(40, 56), features=("color", "albedo"), params={}, max_mem=3000),
], ids=["ldr-4x2", "hdr-nrm-3x1-band", "hdr-scale-2x2", "lightmap-dir-2x1", "single-tile"])
def test_single_pass_matches_monitored(case):
    """The single pass on the device (no progress monitor) equals the
    monitored per-tile path within 1e-6, ragged last tiles, re-anchored
    windows and the alignment band included; each equals JAX's."""
    h, w = case["shape"]
    signed = lambda n: n == "normal" or case.get("kind") == "RTLightmap"
    images = {n: rand(h + w + i, h, w, -1.0 if signed(n) else 0.0, 1.0 if signed(n) else 2.0)
              for i, n in enumerate(case["features"])}
    kw = dict(kind=case.get("kind", "RT"), maxMemoryMB=case.get("max_mem", 0), **case["params"])
    jd, pd = JaxDevice(), Device("cpu")
    jd.commit()
    pd.commit()
    single = run(pd, images, **kw)
    monitored = run(pd, images, monitored=True, **kw)
    assert_parity(single, monitored, atol=PATH_ATOL, rtol=0)
    assert_parity(single, run(jd, images, **kw))
    assert_parity(monitored, run(jd, images, monitored=True, **kw))


def test_single_tile_normal_pad_band_follows_jax():
    """At a size off the 16-pixel alignment in one tile, JAX's single pass
    packs the image and then zero-pads (a padded normal reads 0), while its
    monitored path packs a zeroed window (a padded normal reads 0.5); the
    two differ near the border. The port follows JAX on each path."""
    images = {"color": rand(4, 40, 56), "albedo": rand(5, 40, 56),
              "normal": rand(6, 40, 56, -1.0, 1.0)}
    for monitored in (False, True):
        want, got = jax_and_port(images, monitored=monitored)
        assert_parity(got, want)
    assert np.abs(port(images) - port(images, monitored=True)).max() > 1e-3


@pytest.mark.parametrize("shape,max_mem,monitored,inplace", [
    ((120, 168), 3000, False, False),
    ((400, 200), 0, False, False),
    ((400, 200), 0, True, False),
    ((400, 200), 0, False, True),
    ((400, 200), 0, True, True),
], ids=["single-tile", "tiled", "tiled-monitored", "tiled-inplace", "tiled-monitored-inplace"])
def test_device_buffer_matches_host(shape, max_mem, monitored, inplace):
    """DeviceBuffer in and out (the oidnNewBuffer-on-device analog,
    oidnBenchmark.cpp:121-165) gives the host arrays' pixels within 1e-6,
    on the single pass and the monitored path, in place too; and JAX's
    DeviceBuffer pixels within the parity bar."""
    h, w = shape
    images = {"color": rand(21, h, w, 0.0, 2.0), "albedo": rand(22, h, w)}
    kw = dict(maxMemoryMB=max_mem, monitored=monitored, hdr=True)
    host = port(images, **kw)
    want, got = jax_and_port(images, buffers=True, inplace=inplace, **kw)
    assert_parity(got, host, atol=PATH_ATOL, rtol=0)
    assert_parity(got, want)


def test_device_buffer_inputs_stay_and_half_output():
    """Inputs stay resident and unchanged; a Half3 output buffer stays
    float16 and holds the float32 result rounded once."""
    pd = Device("cpu")
    pd.commit()
    color, albedo = rand(31, 64, 80), rand(32, 64, 80)
    f = pd.new_filter("RT")
    cbuf = DeviceBuffer(color, "cpu")
    f.set_image("color", cbuf)
    f.set_image("albedo", DeviceBuffer(albedo, "cpu"))
    obuf = DeviceBuffer(np.zeros((64, 80, 3), np.float16), "cpu")
    f.set_image("output", obuf)
    f.commit()
    f.execute()
    np.testing.assert_array_equal(cbuf.numpy(), color)
    assert obuf.dtype == torch.float16
    ref = port({"color": color, "albedo": albedo})
    np.testing.assert_array_equal(obuf.numpy(), ref.astype(np.float16))


def test_device_buffer_aliasing_is_detected():
    """Two DeviceBuffers over one tensor alias: in place, the plan charges
    the outputTemp image (unet.cpp:455-460), as for one buffer attached
    twice; disjoint tensors do not alias."""
    pd = Device("cpu")
    pd.commit()
    t = torch.zeros((1001, 700, 3))

    def plan(output):
        f = pd.new_filter("RT")
        f.set_image("color", DeviceBuffer(t[:1000], "cpu"))
        f.set_image("output", output)
        f.set("maxMemoryMB", 200)
        f.commit()
        return f._output_aliases_input(), f.scratch_bytes

    shared, shared_bytes = plan(DeviceBuffer(t[:1000], "cpu"))
    view, _ = plan(DeviceBuffer(t[1:], "cpu"))
    apart, apart_bytes = plan(DeviceBuffer(torch.zeros((1000, 700, 3)), "cpu"))
    assert shared and view and not apart
    assert shared_bytes > apart_bytes


def test_single_pass_never_reads_back(monkeypatch):
    """With DeviceBuffers in and out, the tiled single pass makes no host
    synchronisation: no .item(), .cpu(), .numpy(), .tolist() or bool() of a
    tensor from the first tile to the last."""
    pd = Device("cpu")
    pd.commit()
    f = pd.new_filter("RT")
    f.set_image("color", DeviceBuffer(rand(41, 400, 200, 0.0, 4.0), "cpu"))
    f.set_image("albedo", DeviceBuffer(rand(42, 400, 200), "cpu"))
    obuf = DeviceBuffer(np.zeros((400, 200, 3), np.float32), "cpu")
    f.set_image("output", obuf)
    f.set("hdr", True)  # autoexposure on the device too
    f.set("maxMemoryMB", 0)
    f.commit()
    assert f.tile_counts == (3, 1)

    def refuse(*args, **kwargs):
        raise AssertionError("host synchronisation in the single pass")

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "numpy", "tolist", "__bool__"):
            m.setattr(torch.Tensor, name, refuse)
        f.execute()
    assert np.isfinite(obuf.numpy()).all()
