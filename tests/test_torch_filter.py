"""The port's Filter API against the JAX package's, on the CPU: lifecycle,
degenerate sizes, sanitisation, the weight table, RTLightmap, Half3 and
strided images, the tile plan, the transfers and user weights.

Mirrors ``tests/test_denoise.py``'s oidnTest surface case for case. Both
sides get the same numpy inputs, made from a seed, and the committed
``weights/*.tza``. Outputs agree within the port's U-Net bar, atol 1e-5 and
rtol 1e-4 (float32 transcendentals and convolution sums round differently in
XLA and PyTorch); tile plans and scratch sizes agree integer for integer.
The tiled, in-place, progress and DeviceBuffer cases are in
``test_torch_filter_tiles.py``.
"""

import itertools
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mygpuraytracer_tpu.denoise import Device as JaxDevice
from mygpuraytracer_tpu.denoise import OidnError as JaxOidnError
from mygpuraytracer_tpu.denoise import color as jax_color
from mygpuraytracer_tpu.denoise import filter as jax_filter
from mygpuraytracer_tpu.denoise import weights as jax_weights

from mygpuraytracer_tpu_torch.denoise import Device, DeviceBuffer, OidnError
from mygpuraytracer_tpu_torch.denoise import color, weights
from mygpuraytracer_tpu_torch.denoise import filter as port_filter
from mygpuraytracer_tpu_torch.denoise.unet import UNet

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def devices():
    jd, pd = JaxDevice(), Device("cpu")
    jd.commit()
    pd.commit()
    return jd, pd


def const(h, w, value=0.5):
    return np.full((h, w, 3), value, np.float32)


def denoise(dev, images: dict, kind="RT", out_dtype=np.float32, **params):
    """One filter on ``dev`` over copies of ``images``; returns (output, filter)."""
    f = dev.new_filter(kind)
    for name, img in images.items():
        f.set_image(name, img.copy())
    h, w = next(iter(images.values())).shape[:2]
    out = np.zeros((h, w, 3), out_dtype)
    f.set_image("output", out)
    for k, v in params.items():
        f.set(k, v)
    f.commit()
    f.execute()
    return out, f


def both(images: dict, kind="RT", **params):
    """(JAX output, port output, port filter) on fresh devices."""
    jd, pd = devices()
    want, _ = denoise(jd, images, kind, **params)
    got, f = denoise(pd, images, kind, **params)
    return want, got, f


def assert_parity(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=ATOL, rtol=RTOL)


def rand(seed, h, w, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * np.random.default_rng(seed).random((h, w, 3))).astype(np.float32)


# ----------------------------------------------------------------------------
# Lifecycle (oidnTest.cpp:56-272)


def test_single_filter_multiple_frames():
    """Three frames through one filter, each equal to JAX's."""
    images = {"color": rand(0, 48, 40), "albedo": rand(1, 48, 40)}
    jd, pd = devices()
    want, jf = denoise(jd, images)
    got, pf = denoise(pd, images)
    for _ in range(2):
        jf.execute()
        pf.execute()
        assert_parity(got, want)
    assert np.isfinite(got).all()


def test_multiple_filters_size_churn():
    """small -> large -> medium on one device (oidnTest.cpp:94-164)."""
    jd, pd = devices()
    for size in (32, 128, 64):
        images = {"color": rand(size, size, size), "albedo": const(size, size)}
        want, _ = denoise(jd, images)
        got, _ = denoise(pd, images)
        assert got.shape == (size, size, 3)
        assert_parity(got, want)


def test_multiple_devices():
    images = {"color": rand(2, 33, 49), "albedo": const(33, 49)}
    out1, _ = denoise(devices()[1], images)
    out2, _ = denoise(devices()[1], images)
    np.testing.assert_array_equal(out1, out2)
    want, _ = denoise(devices()[0], images)
    assert_parity(out1, want)


def test_filter_update_same_size_swap():
    jd, pd = devices()
    outs = []
    for dev in (jd, pd):
        out, f = denoise(dev, {"color": const(48, 48), "albedo": const(48, 48)})
        f.set_image("color", const(48, 48, 0.9))
        f.commit()
        f.execute()
        outs.append(out)
    assert_parity(outs[1], outs[0])


def _error_of(dev, fn):
    """(code, message) of the OidnError ``fn(dev)`` raises."""
    err = JaxOidnError if isinstance(dev, JaxDevice) else OidnError
    with pytest.raises(err) as ei:
        fn(dev)
    return ei.value.code, str(ei.value)


def _resize_mismatch(dev):
    _, f = denoise(dev, {"color": const(48, 48), "albedo": const(48, 48)})
    f.set_image("color", const(64, 64))  # mismatch vs output
    f.commit()


def _missing_output(dev):
    f = dev.new_filter("RT")
    f.set_image("color", const(16, 16))
    f.commit()


def _hdr_srgb(dev):
    f = dev.new_filter("RT")
    f.set_image("color", const(16, 16))
    f.set_image("output", np.zeros((16, 16, 3), np.float32))
    f.set("hdr", True)
    f.set("srgb", True)
    f.commit()


def _directional_hdr(dev):
    f = dev.new_filter("RTLightmap")
    f.set_image("color", const(16, 16))
    f.set_image("output", np.zeros((16, 16, 3), np.float32))
    f.set("directional", True)
    f.set("hdr", True)
    f.commit()


def _no_features(dev):
    f = dev.new_filter("RT")
    f.set_image("output", np.zeros((16, 16, 3), np.float32))
    f.commit()


def _unknown_filter(dev):
    dev.new_filter("Bogus")


def _uncommitted_device(dev):
    type(dev)(*(() if isinstance(dev, JaxDevice) else ("cpu",))).new_filter("RT")


def _bad_param(dev):
    dev.new_filter("RT").get("noSuchParam")


@pytest.mark.parametrize("case", [_resize_mismatch, _missing_output, _hdr_srgb, _directional_hdr,
                                  _no_features, _unknown_filter, _uncommitted_device, _bad_param],
                         ids=lambda f: f.__name__.strip("_"))
def test_errors_match_jax(case):
    """The same code and message as the JAX filter; commit errors are
    recorded on the device and passed to its error function."""
    jd, pd = devices()
    seen = []
    pd.set_error_function(lambda code, msg: seen.append(code))
    want = _error_of(jd, case)
    got = _error_of(pd, case)
    assert got == want
    if case in (_resize_mismatch, _missing_output, _hdr_srgb, _directional_hdr, _no_features):
        assert seen == [got[0]]
        assert pd.get_error() == got == jd.get_error()
        assert pd.get_error() == (OidnError.NONE, "")


def test_filter_remove_image():
    jd, pd = devices()
    outs = []
    for dev in (jd, pd):
        out, f = denoise(dev, {"color": rand(3, 32, 32), "albedo": const(32, 32)})
        f.remove_image("albedo")  # falls back to color-only weights
        f.commit()
        f.execute()
        assert f._weights_name == "rt_ldr"
        outs.append(out)
    assert_parity(outs[1], outs[0])


@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (1, 2), (3, 2), (2, 16)])
def test_degenerate_sizes(h, w):
    want, got, _ = both({"color": rand(h * 7 + w, h, w), "albedo": const(h, w)})
    assert np.isfinite(got).all()
    assert_parity(got, want)


def test_zero_size_noop():
    """Size zero runs nothing and reports progress 0 then 1 (oidnTest.cpp:276-320)."""
    seqs = []
    for dev in devices():
        seen = []
        f = dev.new_filter("RT")
        f.set_image("color", np.zeros((0, 0, 3), np.float32))
        f.set_image("output", np.zeros((0, 0, 3), np.float32))
        f.set_progress_monitor_function(lambda p: seen.append(p) or True)
        f.commit()
        f.execute()
        seqs.append(seen)
    assert seqs[1] == seqs[0] == [0.0, 1.0]


@pytest.mark.parametrize("hdr", [False, True])
def test_sanitization(hdr):
    """NaN/Inf/negative inputs give finite output, equal to JAX's
    (oidnTest.cpp:324-374)."""
    img = const(40, 40, 0.5)
    img[5, 5] = np.nan
    img[6, 6] = np.inf
    img[7, 7] = -np.inf
    img[8, 8] = -1.0
    alb = const(40, 40, 0.5)
    alb[3, 3] = np.nan
    want, got, _ = both({"color": img, "albedo": alb}, hdr=hdr, inputScale=1.0)
    assert np.isfinite(got).all() and (got >= 0).all()
    if not hdr:
        assert (got <= 1.0).all()
    assert_parity(got, want)


@pytest.mark.parametrize("hdr,scale", [(True, math.nan), (True, 0.25), (False, 2.0)],
                         ids=["hdr-autoexposure", "hdr-inputScale", "ldr-inputScale"])
def test_input_scale(hdr, scale):
    """Autoexposure (inputScale NaN, hdr) and a user inputScale scale the
    input and un-scale the output as JAX's do."""
    images = {"color": rand(4, 40, 56, 0.0, 8.0), "albedo": rand(5, 40, 56)}
    want, got, _ = both(images, hdr=hdr, inputScale=scale)
    assert_parity(got, want)


# ----------------------------------------------------------------------------
# The feature -> weights table (core/unet.cpp:311-336)

FEATURES = [c for r in (1, 2, 3) for c in itertools.combinations(("color", "albedo", "normal"), r)]


@pytest.mark.parametrize("features,mode,clean", list(itertools.product(
    FEATURES, ("ldr", "hdr", "srgb"), (False, True))),
    ids=lambda v: "+".join(v) if isinstance(v, tuple) else str(v))
def test_weight_selection_table(features, mode, clean):
    """The same weights name, or the same refusal, for every combination of
    features, hdr/srgb and cleanAux."""
    results = []
    for dev in devices():
        f = dev.new_filter("RT")
        for name in features:
            f.set_image(name, const(16, 16))
        f.set_image("output", np.zeros((16, 16, 3), np.float32))
        f.set("hdr", mode == "hdr")
        f.set("srgb", mode == "srgb")
        f.set("cleanAux", clean)
        try:
            f.commit()
            results.append(("ok", f._weights_name, f._transfer_kind(), f._snorm()))
        except (OidnError, JaxOidnError) as e:
            results.append(("error", e.code, str(e)))
    assert results[1] == results[0]


@pytest.mark.parametrize("directional", [False, True])
def test_rtlightmap(directional):
    """hdr (LogTransfer, rtlightmap_hdr) and directional (snorm linear,
    rtlightmap_dir), executed and held against JAX."""
    img = rand(6, 32, 40, -1.0, 1.0) if directional else rand(6, 32, 40, 0.0, 4.0)
    want, got, f = both({"color": img}, kind="RTLightmap", directional=directional)
    assert f._weights_name == ("rtlightmap_dir" if directional else "rtlightmap_hdr")
    assert f._transfer_kind() == ("linear" if directional else "log")
    assert np.isfinite(got).all()
    assert_parity(got, want)


def test_parameter_surface():
    jd, pd = devices()
    jf, pf = jd.new_filter("RT"), pd.new_filter("RT")
    for name in ("alignment", "overlap", "hdr", "srgb", "maxMemoryMB", "cleanAux"):
        assert pf.get(name) == jf.get(name)
    assert pf.get("overlap") == port_filter.OVERLAP == 96
    assert math.isnan(pf.get("inputScale"))
    assert pd.get("version") == jd.get("version") == 10402
    for knob, value in (("numThreads", 4), ("setAffinity", False), ("verbose", 0)):
        pd.set(knob, value)
        assert pd.get(knob) == value
    assert (port_filter.MAX_IMAGE_DIM, port_filter.DEFAULT_MAX_MEMORY_MB) == (
        jax_filter.MAX_IMAGE_DIM, jax_filter.DEFAULT_MAX_MEMORY_MB)
    lm = pd.new_filter("RTLightmap")
    assert lm.get("hdr") is True
    lm.set("directional", True)
    assert (lm.get("hdr"), lm.get("directional")) == (False, True)


# ----------------------------------------------------------------------------
# No hidden fallback


def test_default_device_needs_cuda():
    """Device() and Device("cuda") mean CUDA; without a card they raise and
    never run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is not reachable")
    for kind in ((), ("cuda",), ("default",)):
        with pytest.raises(OidnError) as ei:
            Device(*kind)
        assert ei.value.code == OidnError.UNSUPPORTED_HARDWARE
    with pytest.raises(OidnError) as ei:
        Device("tpu")
    assert ei.value.code == OidnError.INVALID_ARGUMENT
    assert Device("cpu").torch_device == torch.device("cpu")


def test_device_buffer_refuses_window_and_mesh_refuses_devices():
    """A DeviceBuffer takes no window or stride (the JAX package ignores
    them); the 'mesh' parameter takes a parallel.mesh.Mesh or None."""
    pd = devices()[1]
    f = pd.new_filter("RT")
    buf = DeviceBuffer(const(8, 8), device="cpu")
    for kwargs in ({"width": 8, "height": 8}, {"byte_offset": 12}, {"pixel_byte_stride": 16},
                   {"row_byte_stride": 8 * 16}):
        with pytest.raises(OidnError) as ei:
            f.set_image("color", buf, **kwargs)
        assert ei.value.code == OidnError.INVALID_ARGUMENT
    f.set_image("color", buf)  # no window: accepted
    f.set("mesh", None)
    with pytest.raises(OidnError) as ei:
        f.set("mesh", object())
    assert ei.value.code == OidnError.INVALID_ARGUMENT
    assert f.get("mesh") is None
    from mygpuraytracer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=("cpu", "cpu"))
    f.set("mesh", mesh)
    assert f.get("mesh") is mesh


# ----------------------------------------------------------------------------
# Half3 + strided images (core/image.h:12-66; oidnDenoise.cpp:362 half tolerance)


def test_half_images_match_float_within_1e2():
    img, alb = rand(0, 40, 40), rand(1, 40, 40)
    pd = devices()[1]
    out32, _ = denoise(pd, {"color": img, "albedo": alb})
    half = {"color": img.astype(np.float16), "albedo": alb.astype(np.float16)}
    out16, _ = denoise(pd, half, out_dtype=np.float16)
    assert out16.dtype == np.float16 and np.isfinite(out16).all()
    denom = np.maximum(np.abs(out32), 1e-3)
    assert (np.abs(out16.astype(np.float32) - out32) / denom).max() <= 1e-2
    want, _ = denoise(devices()[0], half, out_dtype=np.float16)
    # One float16 rounding of the output apart at most.
    np.testing.assert_allclose(out16.astype(np.float32), want.astype(np.float32),
                               atol=ATOL, rtol=2 ** -10)


def _strided(dev, rgba, rgba_out, h, w):
    f = dev.new_filter("RT")
    f.set_image("color", rgba, width=w, height=h, pixel_byte_stride=16)
    f.set_image("output", rgba_out, width=w, height=h, pixel_byte_stride=16)
    f.commit()
    f.execute()


def test_strided_interleaved_rgba_buffer():
    """pixelByteStride = 16 over an RGBA float buffer; the strided output
    view writes back in place, alpha untouched; equal to the contiguous run
    and to JAX's."""
    h = w = 32
    rgba = np.random.default_rng(1).random((h, w, 4)).astype(np.float32)
    outs = []
    for dev in devices():
        rgba_out = np.full((h, w, 4), -7.0, np.float32)
        _strided(dev, rgba.copy(), rgba_out, h, w)
        assert (rgba_out[..., 3] == -7.0).all()
        outs.append(rgba_out)
    assert_parity(outs[1], outs[0])
    contiguous, _ = denoise(devices()[1], {"color": np.ascontiguousarray(rgba[..., :3])})
    np.testing.assert_allclose(outs[1][..., :3], contiguous, atol=1e-6)


def test_strided_byte_offset_and_row_stride():
    """A cropped window inside a larger buffer via byteOffset + rowByteStride."""
    big = np.random.default_rng(2).random((48, 48, 3)).astype(np.float32)
    h = w = 24
    outs = []
    for dev in devices():
        f = dev.new_filter("RT")
        f.set_image("color", big.copy(), width=w, height=h, byte_offset=(8 * 48 + 4) * 3 * 4,
                    row_byte_stride=48 * 3 * 4)
        out = np.zeros((h, w, 3), np.float32)
        f.set_image("output", out)
        f.commit()
        f.execute()
        outs.append(out)
    assert_parity(outs[1], outs[0])
    crop, _ = denoise(devices()[1], {"color": np.ascontiguousarray(big[8:8 + h, 4:4 + w])})
    np.testing.assert_allclose(outs[1], crop, atol=1e-6)


@pytest.mark.parametrize("buf,kwargs", [
    (np.zeros(100, np.float32), {"width": 10, "height": 10}),  # needs 300 floats
    (np.zeros((4, 4, 3), np.float64), {}),  # bad dtype
    (np.zeros((4, 4, 3), np.float32), {"width": 4, "height": 4, "pixel_byte_stride": 6}),
    (np.zeros((4, 4, 4), np.float64), {"width": 4, "height": 4}),  # 8-byte format
    (np.zeros((4, 4), np.float32), {}),  # not HxWx3
], ids=["short", "f64", "stride", "f64-window", "2d"])
def test_strided_view_bounds_checked(buf, kwargs):
    codes = []
    for dev in devices():
        with pytest.raises((OidnError, JaxOidnError)) as ei:
            dev.new_filter("RT").set_image("color", buf, **kwargs)
        codes.append((ei.value.code, str(ei.value)))
    assert codes[1] == codes[0]


# ----------------------------------------------------------------------------
# The tile plan: integer for integer


@pytest.mark.parametrize("in_ch", [3, 6, 9])
def test_scratch_bytes_match_jax(in_ch):
    for th, tw in itertools.product((16, 288, 304, 1088, 2160, 2144), (16, 288, 1104, 1920, 2016)):
        for temp in (0, (3 * th * tw * 4 + 63) // 64 * 64):
            assert port_filter._scratch_bytes(th, tw, in_ch, temp) == \
                jax_filter._scratch_bytes(th, tw, in_ch, temp)


def _plan(dev, kind, features, h, w, max_mem, inplace):
    """Commit a filter over broadcast (zero-stride, unshared) images; its
    tile shape, counts and grid. In place, the output is the first input."""
    view = lambda: np.broadcast_to(np.zeros(3, np.float32), (h, w, 3))
    images = {name: view() for name in features}
    f = dev.new_filter(kind)
    for name, img in images.items():
        f.set_image(name, img)
    f.set_image("output", images[features[0]] if inplace else view())
    f.set("maxMemoryMB", max_mem)
    f.commit()
    return f.tile_shape, f.tile_counts, f._tile_grid(h, w)


@pytest.mark.parametrize("kind,features,h,w", [
    ("RT", ("color", "albedo", "normal"), 1080, 1920),
    ("RT", ("color", "albedo", "normal"), 2160, 3840),
    ("RT", ("color", "albedo"), 800, 800),
    ("RT", ("color",), 520, 344),
    ("RT", ("color", "albedo"), 33, 49),
    ("RTLightmap", ("color",), 4096, 4096),
    ("RTLightmap", ("color",), 1000, 3000),
], ids=lambda v: "+".join(v) if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("inplace", [False, True])
def test_plan_tiles_match_jax(kind, features, h, w, inplace):
    """maxMemoryMB -> tile shape, counts and grid, equal to JAX's for the
    default budget, 512, 64 and 0 MB, out of place and in place (which
    charges outputTemp); the grid covers every pixel exactly once."""
    jd, pd = devices()
    for max_mem in (3000, 512, 64, 0):
        want = _plan(jd, kind, features, h, w, max_mem, inplace)
        got = _plan(pd, kind, features, h, w, max_mem, inplace)
        assert got == want, (max_mem, got[:2], want[:2])
        cover = np.zeros((h, w), np.int32)
        for oh, ow, th, tw in got[2]:
            cover[oh:oh + th, ow:ow + tw] += 1
        assert cover.min() == 1 and cover.max() == 1


def test_tile_plan_exact_accounting():
    """tests/test_denoise.py's 1080p 9-channel cases, and the denoise
    matrix of apps/benchmark.py: 1x1 under 3000 MB at 1080p (1,092 MiB of
    planned scratch), 1x2 at 4K, 2x2 for a 4096^2 lightmap, 3x4 at 4K under
    512 MB."""
    pd = devices()[1]
    nine = ("color", "albedo", "normal")
    for mb, want in {3000: (1, 1), 512: (2, 2), 64: (6, 12), 0: (10, 18)}.items():
        assert _plan(pd, "RT", nine, 1080, 1920, mb, False)[1] == want
    f = pd.new_filter("RT")
    for name in nine + ("output",):
        f.set_image(name, np.broadcast_to(np.zeros(3, np.float32), (1080, 1920, 3)))
    f.commit()
    assert round(f.scratch_bytes / (1 << 20)) == 1092
    assert _plan(pd, "RT", nine, 2160, 3840, 3000, False)[:2] == ((2160, 2016), (1, 2))
    assert _plan(pd, "RTLightmap", ("color",), 4096, 4096, 3000, False)[:2] == ((2144, 2144), (2, 2))
    assert _plan(pd, "RT", nine, 2160, 3840, 512, False)[:2] == ((848, 1104), (3, 4))


# ----------------------------------------------------------------------------
# Transfers and weights


def _samples():
    gen = np.random.default_rng(5)
    return np.concatenate([gen.random(500) * 2, gen.random(500) * 1e-5, gen.random(500) * 3e3,
                           [0.0, 1.0, 65504.0]]).astype(np.float32)


@pytest.mark.parametrize("kind", ["linear", "srgb", "pu", "log"])
def test_make_transfer_matches_jax(kind):
    y = _samples()
    x = np.clip(y, 0.0, 1.0)
    tf, jtf = color.make_transfer(kind, 0.3), jax_color.make_transfer(kind, 0.3)
    assert type(tf).__name__ == type(jtf).__name__ and tf.kind == jtf.kind == kind
    assert tf.input_scale == jtf.input_scale and tf.output_scale == jtf.output_scale
    np.testing.assert_allclose(tf.forward(torch.from_numpy(y)).numpy(),
                               np.asarray(jtf.forward(jnp.asarray(y))), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(tf.inverse(torch.from_numpy(x)).numpy(),
                               np.asarray(jtf.inverse(jnp.asarray(x))), rtol=2e-6, atol=1e-7)
    # A 0-d float32 tensor scale, as Filter.execute passes it.
    scale = color.make_transfer(kind, torch.tensor(0.3, dtype=torch.float32))
    assert float(scale.output_scale) == pytest.approx(1 / 0.3, rel=1e-7)


def test_log_transfer_roundtrip():
    y = torch.logspace(-4, 4, 51)
    tf = color.make_transfer("log")
    np.testing.assert_allclose(tf.inverse(tf.forward(y)).numpy(), y.numpy(), rtol=2e-2)


def test_load_params_from_blob_matches_jax(tmp_path):
    """set_data("weights", blob): the blob's tensors, JAX's parameters
    transposed, and the same output as the committed default weights."""
    blob = (REPO / "weights" / "rt_ldr_alb.tza").read_bytes()
    tensors, random_w = weights.load_params_from_blob(blob)
    jparams, jrandom = jax_weights.load_params_from_blob(blob)
    assert random_w is jrandom is False
    for name, p in jparams.items():
        np.testing.assert_array_equal(tensors[f"{name}.weight"][0],
                                      np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(tensors[f"{name}.bias"][0], np.asarray(p["b"]))
    assert UNet.from_tza(tensors).in_channels == 6
    images = {"color": rand(7, 32, 48), "albedo": rand(8, 32, 48)}
    jd, pd = devices()
    outs = []
    for dev in (jd, pd):
        f = dev.new_filter("RT")
        f.set_data("weights", blob)
        for n, img in images.items():
            f.set_image(n, img.copy())
        out = np.zeros((32, 48, 3), np.float32)
        f.set_image("output", out)
        f.commit()
        f.execute()
        outs.append(out)
    assert_parity(outs[1], outs[0])
    default, _ = denoise(pd, images)
    np.testing.assert_array_equal(outs[1], default)

