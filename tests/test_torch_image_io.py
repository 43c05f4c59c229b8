"""The port's image I/O (utils/image_io.py, utils/exr.py) against the JAX
package's: the cases of ``tests/test_exr.py`` and ``tests/test_apps.py``'s
HDR round trip; the port writes PFM, HDR and EXR files byte for byte as JAX
does, and reads JAX's files to the same arrays."""

import numpy as np
import pytest

from mygpuraytracer_tpu.utils import exr as jax_exr
from mygpuraytracer_tpu.utils import image_io as jax_io

from mygpuraytracer_tpu_torch.utils import exr, image_io


def _hdr(h=37, w=53, c=3, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.gamma(1.5, 1.0, size=(h, w, c)).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = 117.0  # out-of-LDR-range value survives
    return img


def _same_file(tmp_path, name, write_port, write_jax):
    """Both writers' bytes for one file name; returns the JAX file's path."""
    p, j = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
    write_port(str(p))
    write_jax(str(j))
    assert p.read_bytes() == j.read_bytes()
    return str(j)


def test_predictor_roundtrip():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 256, 1001):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert exr._predictor_encode(raw) == jax_exr._predictor_encode(raw)
        assert exr._predictor_decode(exr._predictor_encode(raw)) == raw


@pytest.mark.parametrize("compression", [0, 2, 3])
@pytest.mark.parametrize("half", [True, False])
def test_exr_roundtrip(tmp_path, compression, half):
    img = _hdr()
    path = _same_file(tmp_path, "t.exr", lambda p: exr.write_exr(p, img, half, compression=compression),
                      lambda p: jax_exr.write_exr(p, img, half, compression=compression))
    back = exr.read_exr(path)
    expect = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(back, expect)
    np.testing.assert_array_equal(back, jax_exr.read_exr(path))


@pytest.mark.parametrize("c", [1, 4])
def test_exr_single_channel_and_alpha(tmp_path, c):
    img = _hdr(c=c)
    path = _same_file(tmp_path, "y.exr", lambda p: exr.write_exr(p, img, half=False),
                      lambda p: jax_exr.write_exr(p, img, half=False))
    np.testing.assert_array_equal(exr.read_exr(path), img)


def test_exr_uint_channels(tmp_path):
    img = np.arange(24, dtype=np.uint32).reshape(4, 6, 1) * 100000
    path = _same_file(tmp_path, "u.exr", lambda p: exr.write_exr(p, img),
                      lambda p: jax_exr.write_exr(p, img))
    chans, header = exr.read_exr_channels(path)
    np.testing.assert_array_equal(chans["Y"], img[..., 0])
    assert header["dataWindow"] == jax_exr.read_exr_channels(path)[1]["dataWindow"]


def test_exr_layered_channels(tmp_path):
    """split_exr-style multi-layer files: the channel dict keeps all names."""
    img, alb = _hdr(c=3, seed=2), _hdr(c=3, seed=3)
    names = ["R", "G", "B", "albedo.R", "albedo.G", "albedo.B"]
    data = np.concatenate([img, alb], axis=-1)
    path = _same_file(tmp_path, "multi.exr",
                      lambda p: exr.write_exr(p, data, half=False, channel_names=names),
                      lambda p: jax_exr.write_exr(p, data, half=False, channel_names=names))
    chans, _ = exr.read_exr_channels(path)
    assert set(chans) == set(names)
    np.testing.assert_array_equal(chans["albedo.G"], alb[..., 1])
    np.testing.assert_array_equal(exr.read_exr(path), img)  # the RGB display channels


def test_exr_16line_blocks_tall_image(tmp_path):
    """ZIP blocks span 16 scanlines; a height off a multiple hits the ragged last block."""
    img = _hdr(h=45, w=8)
    path = _same_file(tmp_path, "tall.exr", lambda p: exr.write_exr(p, img, half=False, compression=3),
                      lambda p: jax_exr.write_exr(p, img, half=False, compression=3))
    np.testing.assert_array_equal(exr.read_exr(path), img)


@pytest.mark.parametrize("ext", [".exr", ".pfm", ".hdr", ".npy"])
def test_save_and_load_image(tmp_path, ext):
    """save_image writes what the JAX package's writes (.npy: the same
    array); load_image reads it to the same array."""
    img = _hdr()
    if ext == ".npy":
        image_io.save_image(str(tmp_path / f"x{ext}"), img)
        path = str(tmp_path / f"x{ext}")
    else:
        path = _same_file(tmp_path, f"x{ext}", lambda p: image_io.save_image(p, img),
                          lambda p: jax_io.save_image(p, img))
    back = image_io.load_image(path)
    np.testing.assert_array_equal(back, jax_io.load_image(path))
    assert back.shape == img.shape and back.dtype == np.float32
    if ext in (".pfm", ".npy"):
        np.testing.assert_array_equal(back, img)


def test_pfm_gray_and_big_endian(tmp_path):
    """A one-channel PFM loads as three equal channels; a big-endian PFM
    (positive scale) with |scale| != 1 scales its values."""
    gray = _hdr(c=1)[..., 0]
    path = _same_file(tmp_path, "g.pfm", lambda p: image_io.write_pfm(p, gray),
                      lambda p: jax_io.write_pfm(p, gray))
    np.testing.assert_array_equal(image_io.load_image(path), np.repeat(gray[..., None], 3, -1))
    img = _hdr(h=5, w=7)
    big = tmp_path / "big.pfm"
    big.write_bytes(b"PF\n7 5\n2.0\n" + np.ascontiguousarray(img[::-1]).astype(">f4").tobytes())
    np.testing.assert_array_equal(image_io.read_pfm(str(big)), img * 2.0)
    np.testing.assert_array_equal(image_io.read_pfm(str(big)), jax_io.read_pfm(str(big)))


def test_hdr_roundtrip(tmp_path):
    img = np.asarray(np.random.default_rng(2).random((12, 20, 3)) * 100.0, np.float32)
    path = _same_file(tmp_path, "t.hdr", lambda p: image_io.write_hdr(p, img),
                      lambda p: jax_io.write_hdr(p, img))
    back = image_io.read_hdr(path)
    # shared-exponent format: absolute precision ~ pixel_max/128 per channel
    tol = img.max(axis=-1, keepdims=True) / 64 + 1e-4
    assert (np.abs(back - img) <= tol).all()


def test_png_through_image_io(tmp_path):
    """PNG goes through the port's zlib codec: the pixels JAX's reader
    sees, quantized as the reference's savePNG does."""
    img = np.random.default_rng(3).random((9, 13, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    image_io.save_image(path, img)
    back = image_io.load_image(path)
    np.testing.assert_array_equal(back, jax_io.load_image(path))
    np.testing.assert_array_equal(back, (np.clip(img, 0, 1) * 255).astype(np.uint8) / np.float32(255))


def test_unsupported_format(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        image_io.load_image(str(tmp_path / "x.tiff"))
    with pytest.raises(ValueError, match="unsupported"):
        image_io.save_image(str(tmp_path / "x.jpg"), np.zeros((2, 2, 3), np.float32))


def test_compare_images_matches_jax():
    a = _hdr(seed=7)
    b = a * (1 + np.random.default_rng(8).normal(0, 1e-4, a.shape)).astype(np.float32)
    for threshold in (1e-5, 1e-4, 1e-2):
        assert image_io.compare_images(a, b, threshold) == jax_io.compare_images(a, b, threshold)
