"""The port's raytrace app end to end on the CPU at a tiny size."""

import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.apps import raytrace
from mygpuraytracer_tpu_torch.utils.png import read_png

SUFFIXES = ("samp.png", "albedo.png", "input.png", "output.png")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run(tmp_path, *extra):
    rc = raytrace.main(["cornell", "--resolution", "32", "32", "--iterations", "4",
                        "--megakernel", "off", "--device", "cpu", "--quiet",
                        "--out-dir", str(tmp_path), *extra])
    assert rc == 0
    return sorted(p.name for p in pathlib.Path(tmp_path).iterdir())


def test_app_writes_four_pngs(tmp_path):
    names = _run(tmp_path)
    assert len(names) == 4
    for suffix in SUFFIXES:
        (match,) = [n for n in names if n.endswith(suffix)]
        assert match.startswith("cornell.") and ".4" in match
        img = read_png(str(tmp_path / match))
        assert img.shape == (32, 32, 3)
    out = read_png(str(tmp_path / [n for n in names if n.endswith("output.png")][0]))
    assert out.mean() > 0


def test_app_no_denoise_and_batches(tmp_path):
    names = _run(tmp_path, "--no-denoise", "--batch", "3")
    assert sorted(n.split(".")[-2][1:] for n in names) == ["albedo", "input", "samp"]


def test_app_renders_textured_ship(tmp_path):
    """The mesh path's app line on the textured, bump-mapped ship at 16x16:
    four PNGs. On the CPU the mesh query is the chunked stream unless the
    tiers are asked for; the flags parse and reach the options."""
    args = raytrace.parse_args(["scenes/shipTexOnly.txt", "--mesh-tier", "lists",
                                "--mesh-sort", "need", "--winner-table", "f16"])
    assert (args.mesh_tier, args.mesh_sort, args.winner_table) == ("lists", "need", "f16")
    rc = raytrace.main(["scenes/shipTexOnly.txt", "--resolution", "16", "16", "--iterations", "1",
                        "--device", "cpu", "--quiet", "--mesh-tier", "rows",
                        "--out-dir", str(tmp_path)])
    assert rc == 0
    names = sorted(p.name for p in pathlib.Path(tmp_path).iterdir())
    assert len(names) == 4 and all(n.startswith("shipTexOnly.") for n in names)
    for suffix in SUFFIXES:
        (match,) = [n for n in names if n.endswith(suffix)]
        assert read_png(str(tmp_path / match)).shape == (16, 16, 3)
    albedo = read_png(str(tmp_path / [n for n in names if n.endswith("albedo.png")][0]))
    assert albedo.mean() > 0  # the ship's kd texels reach the albedo AOV


def test_mirror_x():
    img = np.arange(12, dtype=np.float32).reshape(1, 4, 3)
    np.testing.assert_array_equal(raytrace.mirror_x(img)[0, 0], img[0, 3])


def test_unknown_scene_raises():
    with pytest.raises(FileNotFoundError):
        raytrace.load_any_scene("no_such_scene")


# ----------------------------------------------------------------------------
# The raytrace app denoises through the Filter API


def test_app_denoises_through_filter(tmp_path, monkeypatch, capsys):
    """output.png is the port's Filter("RT") on the app's beauty and albedo
    (color + albedo, LDR), mirrored as saveImage does, and that Filter's
    output equals the JAX Filter's on the same images; the app prints the
    JAX app's Denoise timings line."""
    from mygpuraytracer_tpu.denoise import Device as JaxDevice
    from mygpuraytracer_tpu_torch.denoise import Device
    from mygpuraytracer_tpu_torch.utils.png import to_uint8

    seen = {}
    original = raytrace.denoise_beauty

    def spy(beauty, albedo, device="cuda"):
        output, timings = original(beauty, albedo, device)
        seen.update(beauty=beauty, albedo=albedo, output=output, timings=timings, device=device)
        return output, timings

    monkeypatch.setattr(raytrace, "denoise_beauty", spy)
    rc = raytrace.main(["cornell", "--resolution", "32", "24", "--iterations", "4",
                        "--megakernel", "off", "--device", "cpu", "--out-dir", str(tmp_path)])
    assert rc == 0
    assert str(seen["device"]) == "cpu"
    assert set(seen["timings"]) == {"device_init_ms", "filter_init_ms", "denoise_ms",
                                    "random_weights"}
    assert seen["timings"]["random_weights"] is False
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Denoise:")]
    assert len(line) == 1 and "device=" in line[0] and "filter=" in line[0] and "exec=" in line[0]

    outs = []
    for dev in (Device("cpu"), JaxDevice()):
        dev.commit()
        f = dev.new_filter("RT")
        f.set_image("color", seen["beauty"].astype(np.float32))
        f.set_image("albedo", seen["albedo"].astype(np.float32))
        out = np.zeros((24, 32, 3), np.float32)
        f.set_image("output", out)
        f.commit()
        f.execute()
        outs.append(out)
    np.testing.assert_array_equal(seen["output"], outs[0])
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-4)
    (png,) = [p for p in pathlib.Path(tmp_path).iterdir() if p.name.endswith("output.png")]
    np.testing.assert_array_equal(read_png(str(png)), raytrace.mirror_x(to_uint8(outs[0])))


# ----------------------------------------------------------------------------
# The oidnDenoise app against the JAX app


def _aux_inputs(d: pathlib.Path, h=32, w=40):
    from mygpuraytracer_tpu_torch.utils.image_io import write_pfm

    gen = np.random.default_rng(9)
    files = {"c": gen.random((h, w, 3)) * 1.5, "a": gen.random((h, w, 3)),
             "n": gen.random((h, w, 3)) * 2 - 1}
    for name, img in files.items():
        write_pfm(str(d / f"{name}.pfm"), img.astype(np.float32))
    return {k: str(d / f"{k}.pfm") for k in files}


@pytest.mark.parametrize("case", [
    ["--ldr", "{c}", "--alb", "{a}"],
    ["--hdr", "{c}", "--alb", "{a}", "--nrm", "{n}"],
    ["--ldr", "{c}", "--alb", "{a}", "--nrm", "{n}", "--prefilter_aux"],
    ["--ldr", "{c}", "--alb", "{a}", "--inplace", "--maxmem", "0"],
    ["--hdr", "{c}", "--half", "--is", "0.5"],
    ["-f", "RTLightmap", "--hdr", "{c}"],
], ids=["ldr-alb", "hdr-alb-nrm", "prefilter-aux", "inplace-maxmem0", "half", "lightmap"])
def test_denoise_cli_matches_jax(tmp_path, case):
    """`python -m mygpuraytracer_tpu_torch.apps.denoise ... -o out.pfm` on
    the CPU writes what the JAX app writes, within the port's U-Net bar
    (--half: one float16 rounding apart)."""
    from mygpuraytracer_tpu.apps import denoise as jax_app
    from mygpuraytracer_tpu_torch.apps import denoise as port_app
    from mygpuraytracer_tpu_torch.utils.image_io import load_image

    files = _aux_inputs(tmp_path, h=300 if "--inplace" in case else 32)
    args = [a.format(**files) for a in case]
    assert jax_app.main(args + ["-o", str(tmp_path / "jax.pfm")]) == 0
    assert port_app.main(args + ["-o", str(tmp_path / "port.pfm"), "--device", "cpu"]) == 0
    got, want = load_image(str(tmp_path / "port.pfm")), load_image(str(tmp_path / "jax.pfm"))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=2 ** -10 if "--half" in case else 1e-4)


def test_denoise_cli_ref_compare(tmp_path, capsys):
    """-r REF: exit 0 on the same output, exit 2 when pixels differ (and a
    .debug.pfm beside -o); --bench times N executes; Device() flags parse."""
    from mygpuraytracer_tpu_torch.apps import denoise as port_app
    from mygpuraytracer_tpu_torch.utils.image_io import load_image, write_pfm

    files = _aux_inputs(tmp_path)
    common = ["--ldr", files["c"], "--alb", files["a"], "--device", "cpu"]
    assert port_app.main(common + ["-o", str(tmp_path / "out.pfm"), "--threads", "2",
                                   "--affinity", "0", "-v", "1", "--bench", "1"]) == 0
    assert "bench:" in capsys.readouterr().out
    assert port_app.main(common + ["-r", str(tmp_path / "out.pfm")]) == 0
    write_pfm(str(tmp_path / "off.pfm"), load_image(str(tmp_path / "out.pfm")) + 0.1)
    assert port_app.main(common + ["-r", str(tmp_path / "off.pfm"), "-o",
                                   str(tmp_path / "o2.pfm")]) == 2
    assert (tmp_path / "o2.pfm.debug.pfm").exists()
    assert port_app.parse_args(["--ldr", "x.pfm"]).device == "cuda"
