"""Textures and the mesh tables of the port against Pillow and the JAX package.

- The PNG decoder (utils/png.py, zlib only) equals Pillow on the scene
  textures and on PNGs written here in every colour type and filter type.
- The texture atlases, their tables, the plane-form faces and the winner
  tables equal the JAX package's bit for bit (both precompute in float64).
- The oct winner-table decode of the port's mesh query equals JAX's rows
  tier's on the same table, and the texel fetches equal JAX's exactly.
"""

import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.ops import trace as jax_trace
from mygpuraytracer_tpu.ops.vec3 import Vec3 as JaxVec3
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene
from mygpuraytracer_tpu_torch.utils import png

REPO = pathlib.Path(__file__).resolve().parent.parent
TEXTURES = sorted((REPO / "scenes/textures").glob("*.png"))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---- the PNG decoder ----------------------------------------------------------

def _filter_row(kind: int, line: bytes, prior: bytes, bpp: int) -> bytes:
    """Encode one scanline with PNG filter ``kind`` (the inverse of the
    decoder's reconstruction)."""
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 0xFF
    return bytes([kind]) + bytes(out)


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def write_test_png(path, data: np.ndarray, ctype: int, filters, palette=None, depth=8,
                   interlace=0):
    """A PNG of ``data`` (h, w, channels uint8) with the given per-row
    filter types (cycled)."""
    h, w = data.shape[:2]
    bpp = data.shape[2] if data.ndim == 3 else 1
    rows, prior = [], bytes(w * bpp)
    for y in range(h):
        line = data[y].tobytes()
        rows.append(_filter_row(filters[y % len(filters)], line, prior, bpp))
        prior = line
    body = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                                  0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    body += _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b"")
    pathlib.Path(path).write_bytes(body)


@pytest.mark.parametrize("path", TEXTURES, ids=[p.name for p in TEXTURES])
def test_decoder_matches_pillow_on_scene_textures(path):
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(png.load_texture(str(path), flip_vertical=False), want)
    np.testing.assert_array_equal(png.load_texture(str(path)), want[::-1])
    np.testing.assert_array_equal(png.read_png(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


COLOUR_TYPES = {"gray": (0, 1), "rgb": (2, 3), "palette": (3, 1), "gray_alpha": (4, 2),
                "rgba": (6, 4)}


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", list(COLOUR_TYPES))
def test_decoder_matches_pillow_per_colour_type_and_filter(kind, filt, tmp_path):
    ctype, ch = COLOUR_TYPES[kind]
    rng = np.random.default_rng(10 * ctype + filt)
    # smooth gradients plus noise, so every predictor sees real neighbours
    yy, xx = np.mgrid[0:13, 0:17]
    data = ((xx[..., None] * 11 + yy[..., None] * 7 + np.arange(ch) * 40
             + rng.integers(0, 30, (13, 17, ch))) % 256).astype(np.uint8)
    palette = None
    if kind == "palette":
        palette = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        data = (data % 40).astype(np.uint8)
    path = tmp_path / f"{kind}_{filt}.png"
    write_test_png(path, data, ctype, [filt], palette)
    im = Image.open(path)
    want = np.asarray(im.convert("RGB") if kind == "palette" else im)
    got = png.load_texture(str(path), flip_vertical=False)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(png.read_png(str(path)), np.asarray(im.convert("RGB")))


def test_decoder_mixed_filters_and_pillow_written_files(tmp_path):
    data = np.random.default_rng(4).integers(0, 256, (31, 29, 3)).astype(np.uint8)
    write_test_png(tmp_path / "mixed.png", data, 2, [4, 3, 0, 1, 2])
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "mixed.png")), data)
    for mode, arr in (("RGB", data), ("RGBA", np.dstack([data, data[..., :1]])),
                      ("L", data[..., 0])):
        Image.fromarray(arr, mode).save(tmp_path / f"{mode}.png", optimize=True)
        got = png.load_texture(str(tmp_path / f"{mode}.png"), flip_vertical=False)
        np.testing.assert_array_equal(got.reshape(arr.shape), arr)
    png.write_png(str(tmp_path / "out.png"), data)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out.png")), data)


def test_decoder_refuses_other_depths_and_interlace(tmp_path):
    data = np.zeros((4, 4, 1), np.uint8)
    write_test_png(tmp_path / "d16.png", np.zeros((4, 8, 1), np.uint8), 0, [0], depth=16)
    write_test_png(tmp_path / "inter.png", data, 0, [0], interlace=1)
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    for name, match in (("d16.png", "bit depth 16"), ("inter.png", "interlaced"),
                        ("not.png", "not a PNG")):
        with pytest.raises(ValueError, match=match):
            png.read_png(str(tmp_path / name))


# ---- atlases, plane form and winner tables ---------------------------------------

@pytest.fixture(scope="module")
def ship_tex():
    scene = "scenes/shipTexOnly.txt"
    return jax_build(jax_load_scene(scene), 128), build_device_scene(load_scene(scene), 128,
                                                                     device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def test_texture_atlases_and_tables_match_jax(ship_tex):
    (jdev, jmeta), (dev, meta) = ship_tex
    assert meta.has_textures and meta.tex_pack_table
    for name in ("tex_atlas_w", "tex_atlas16_w"):
        np.testing.assert_array_equal(_bits(getattr(dev, name).numpy()),
                                      np.asarray(getattr(jdev, name)), err_msg=name)
    assert meta.tex_table == jmeta.tex_table
    assert meta.tex_pack_table == jmeta.tex_pack_table
    assert meta.mesh_clusters == jmeta.mesh_clusters


@pytest.mark.parametrize("scene", ["shipTexOnly", "cornellShip"])
def test_plane_form_and_winner_tables_match_jax(scene, ship_tex):
    if scene == "shipTexOnly":
        (jdev, _), (dev, _) = ship_tex
    else:
        path = f"scenes/{scene}.txt"
        jdev, _ = jax_build(jax_load_scene(path), 128)
        dev, _ = build_device_scene(load_scene(path), 128, device="cpu")
    for name in ("face_plane", "face_ex_t", "face_ex_o"):
        np.testing.assert_array_equal(_bits(getattr(dev, name).numpy()),
                                      _bits(getattr(jdev, name)), err_msg=name)
    # face_ex_t holds the used rows of JAX's plane extension, per face
    used = np.asarray(jdev.face_plane_ex)[list(range(6)) + list(range(8, 14))].T
    np.testing.assert_array_equal(_bits(dev.face_ex_t.numpy()), _bits(used))
    tb = np.stack([np.asarray(c) for c in jdev.face_tb_cols], axis=1)
    np.testing.assert_array_equal(_bits(dev.face_tb.numpy()), _bits(tb))


def _ship_rays(n=900, seed=21):
    """Origins on a shell around the ship (its AABB spans about
    (-1.3, 1.9, 0.3)-(4.4, 3.8, 5.8)), aimed near its middle."""
    rng = np.random.default_rng(seed)
    center = np.float32([1.5, 2.8, 3.0])
    o = rng.normal(size=(n, 3))
    o = (center + 8.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = (center + rng.normal(size=(n, 3)) * 1.0 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("table", ["oct"])
def test_winner_table_decode_matches_jax(table, ship_tex):
    """The same query through JAX's rows tier and the port's, each with its
    ``table`` decode. t within 1e-5 relative; hit and the texture slots equal on
    every lane; uv within 5e-5 (measured 1.3e-5: XLA may contract the
    jitted JAX side, so t and the barycentrics differ by a few ulps, and
    u = o.U + t d.U - cu cancels); the bump-mapped normals within 1e-4 on
    > 99% of mesh lanes (a uv shift can move the nearest bump texel)."""
    (jdev, jmeta), (dev, meta) = ship_tex
    o, d = _ship_rays()
    jfn = jax.jit(lambda dv, o_, d_: jax_trace.intersect_soa(
        jmeta, dv, o_, d_, 128, mesh_pallas=True, mesh_tier="rows", winner_table=table))
    jh = jfn(jdev, JaxVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
             JaxVec3(*(jnp.asarray(d[:, i]) for i in range(3))))
    th = trace.intersect_soa(meta, dev, Vec3(*(torch.from_numpy(o[:, i].copy()) for i in range(3))),
                             Vec3(*(torch.from_numpy(d[:, i].copy()) for i in range(3))),
                             128, mesh_pallas=True, winner_table=table)
    mesh = th.is_obj.numpy()
    assert mesh.sum() > 300
    for name in ("hit", "is_obj", "kd", "ks", "ke", "bump"):
        np.testing.assert_array_equal(getattr(th, name).numpy(), np.asarray(getattr(jh, name)))
    np.testing.assert_allclose(th.t.numpy()[mesh], np.asarray(jh.t)[mesh], rtol=1e-5, atol=0)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(th, name).numpy(), np.asarray(getattr(jh, name)),
                                   rtol=0, atol=5e-5)
    for a, b in zip(th.normal, jh.normal):
        assert np.isclose(a.numpy()[mesh], np.asarray(b)[mesh], rtol=0, atol=1e-4).mean() > 0.99


def test_texel_fetches_match_jax(ship_tex):
    (jdev, jmeta), (dev, meta) = ship_tex
    rng = np.random.default_rng(12)
    n = 600
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    kd_t, ks_t, ke_t, bp_t = meta.tex_pack_table[0][:4]
    on = rng.integers(0, 2, n).astype(np.int32)
    ids = {k: on * t for k, t in (("kd", kd_t), ("ks", ks_t), ("ke", ke_t), ("bump", bp_t))}
    tid = {k: torch.from_numpy(a) for k, a in ids.items()}
    jid = {k: jnp.asarray(a) for k, a in ids.items()}
    tu, tv, ju, jv = torch.from_numpy(u), torch.from_numpy(v), jnp.asarray(u), jnp.asarray(v)
    got = trace.fetch_texels_packed(dev, meta, tid["kd"], tid["ks"], tid["ke"], tid["bump"], tu, tv)
    want = jax_trace.fetch_texels_packed(jdev, jmeta, jid["kd"], jid["ks"], jid["ke"], jid["bump"],
                                         ju, jv)
    for g, w in zip(got, want):
        g = g if isinstance(g, Vec3) else (g,)
        w = w if isinstance(w, JaxVec3) else (w,)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("kd", "ks", "ke", "bump"):
        (gt, gp), (wt, wp) = (trace.fetch_texel_soa(dev, meta, tid[k], tu, tv),
                              jax_trace.fetch_texel_soa(jdev, jmeta, jid[k], ju, jv))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        for a, b in zip(gt, wt):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
