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
