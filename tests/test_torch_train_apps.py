"""The trainer's apps against the JAX package's, on the CPU.

- ``preprocess`` on tiny EXR sample groups written with the port's
  ``utils/exr.py``: every ``.npy`` within one float16 ulp of the JAX app's
  (the transfer's float32 pow/log round differently in XLA and torch, and
  a value next to a half-way point may round to the neighbouring half);
  ``samples.json`` and ``config.json`` equal.
- ``compare_image``: exit codes 0/1/2 and the printed lines equal.
- ``visualize``: the text and the SVG equal.
- ``train_denoiser``: two epochs on the CPU write a ``.tza`` that
  ``Filter("RT")`` loads through ``set_data("weights", ...)``; the
  ``TrainConfig`` it builds is the script's, run here with fewer steps,
  a smaller batch and smaller tiles (the card runs it as it is).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu.apps import compare_image as jax_compare
from mygpuraytracer_tpu.apps import preprocess as jax_preprocess
from mygpuraytracer_tpu.apps import visualize as jax_visualize

import mygpuraytracer_tpu_torch.train.train  # noqa: F401  (the module, shadowed by train())
from mygpuraytracer_tpu_torch.apps import compare_image, preprocess, train_denoiser, visualize
from mygpuraytracer_tpu_torch.denoise import Device
from mygpuraytracer_tpu_torch.utils.exr import write_exr
from mygpuraytracer_tpu_torch.utils.image_io import save_image

train_mod = sys.modules["mygpuraytracer_tpu_torch.train.train"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sample_group(root, features, hdr_scale=1.0):
    g = np.random.default_rng(0)
    root.mkdir(parents=True)
    for name in ("cornell_0004spp", "cornell_0016spp", "cornell_ref", "box_8", "box_gt"):
        for f in features:
            img = g.random((20, 24, 3), np.float32)
            if f == "hdr":
                img *= hdr_scale
            if f == "nrm":
                img = img * 2 - 1
            write_exr(str(root / f"{name}.{f}.exr"), img)


CASES = {
    "hdr_alb_nrm": (["hdr", "alb", "nrm"], []),
    "ldr_albedo_clean_aux": (["ldr", "albedo"], ["--clean_aux"]),
    "lightmap_log": (["hdr"], ["-f", "RTLightmap"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches_jax(tmp_path, case, capsys):
    features, flags = CASES[case]
    files = [f if f != "albedo" else "alb" for f in features]
    _sample_group(tmp_path / "data" / "train", files, hdr_scale=6.0)
    common = [*features, "-D", str(tmp_path / "data"), "-t", "train", "-v", "missing", *flags]
    assert preprocess.main([*common, "-P", str(tmp_path / "port"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jax_preprocess.main([*common, "-P", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    assert port_out.replace("port", "jax") == jax_out
    port_dir, jax_dir = tmp_path / "port" / "train", tmp_path / "jax" / "train"
    names = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names and len(names) == 8
    for name in names:
        if name.endswith(".json"):
            assert json.loads((port_dir / name).read_text()) == json.loads((jax_dir / name).read_text())
            continue
        got, want = np.load(port_dir / name), np.load(jax_dir / name)
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        ulps = np.abs(got.view(np.int16).astype(np.int32) - want.view(np.int16).astype(np.int32))
        assert ulps.max() <= 1, (name, ulps.max())


def test_preprocess_device_defaults_to_cuda():
    assert preprocess.parse_args(["hdr"]).device == "cuda"


@pytest.fixture
def images(tmp_path):
    g = np.random.default_rng(4)
    a = g.random((16, 20, 3)).astype(np.float32)
    paths = {}
    for name, img in (("a", a), ("b", np.clip(a + 0.05 * g.standard_normal(a.shape), 0, 1)),
                      ("small", a[:8])):
        paths[name] = str(tmp_path / f"{name}.pfm")
        save_image(paths[name], img.astype(np.float32))
    return paths


@pytest.mark.parametrize("args, rc", [
    (["a", "b"], 0), (["a", "b", "--metric", "mse", "rmse", "psnr", "ssim"], 0),
    (["a", "b", "--threshold", "psnr", "10"], 0), (["a", "b", "--threshold", "psnr", "60"], 2),
    (["a", "b", "--metric", "rmse", "--threshold", "rmse", "0.001"], 2), (["a", "small"], 1),
    (["a", "a", "--metric", "rmse", "mse"], 0)],
    ids=["default", "all", "pass", "fail_psnr", "fail_rmse", "shape", "identical"])
def test_compare_image_matches_jax(images, args, rc, capsys):
    argv = [images.get(a, a) for a in args]
    assert compare_image.main([*argv, "--device", "cpu"]) == rc
    got = capsys.readouterr()
    assert jax_compare.main(argv) == rc
    want = capsys.readouterr()
    assert got.err == want.err
    assert got.out == want.out  # ssim prints 6 digits; the packages agree to ~1e-7


@pytest.fixture
def result_dir(tmp_path):
    recs = [{"epoch": i + 1, "step": 4 * (i + 1), "loss": 1.0 / (i + 1), "lr": 1e-4 * (i % 3)}
            for i in range(12)]
    (tmp_path / "log.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(tmp_path)


@pytest.mark.parametrize("key", ["loss", "lr"])
def test_visualize_matches_jax(result_dir, key, tmp_path, capsys):
    assert visualize.main([result_dir, "--key", key]) == 0
    got = capsys.readouterr().out
    assert jax_visualize.main([result_dir, "--key", key]) == 0
    assert got == capsys.readouterr().out
    assert visualize.main([result_dir, "--key", key, "--svg", str(tmp_path / "p.svg")]) == 0
    jax_visualize.main([result_dir, "--key", key, "--svg", str(tmp_path / "j.svg")])
    capsys.readouterr()
    assert (tmp_path / "p.svg").read_text() == (tmp_path / "j.svg").read_text()


def test_slot_transfer_table():
    assert train_denoiser.slot_transfer("rtlightmap_hdr") == ("log", True, False)
    assert train_denoiser.slot_transfer("rt_nrm") == ("linear", False, True)
    assert train_denoiser.slot_transfer("rt_alb") == ("srgb", False, False)
    assert train_denoiser.slot_transfer("rt_hdr_alb") == ("pu", True, False)
    assert train_denoiser.slot_transfer("rt_ldr_alb") == ("srgb", False, False)
    args = train_denoiser.parse_args([])
    assert (args.name, args.data_dir, args.epochs, args.max_lr, args.loss, args.device,
            args.out, args.result_dir) == ("rt_ldr_alb", "data/denoise", 200, 2e-4, "l1_msssim",
                                           "cuda", None, None)


def test_train_denoiser_cli_writes_weights_the_filter_loads(tmp_path, monkeypatch, capsys):
    seen = []

    class SmallConfig(train_mod.TrainConfig):
        def __init__(self, **kw):
            seen.append(dict(kw))
            super().__init__(**{**kw, "steps_per_epoch": 1, "batch_size": 1, "tile_size": 32})

    monkeypatch.setattr(train_mod, "TrainConfig", SmallConfig)
    out = tmp_path / "w" / "rt_ldr_alb.tza"
    rc = train_denoiser.main(["rt_ldr_alb", str(pathlib.Path(__file__).resolve().parent.parent
                                                / "data" / "denoise"), "2", "--device", "cpu",
                              "--out", str(out), "--result-dir", str(tmp_path / "r")])
    assert rc == 0 and out.is_file()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("epoch 1: loss ") and lines[-1] == f"exported {out}"
    assert seen[0] | {"data_dir": None, "result_dir": None} == dict(
        data_dir=None, result_dir=None, in_channels=6, loss="l1_msssim", num_epochs=2,
        steps_per_epoch=16, batch_size=8, tile_size=128, max_lr=2e-4, precision="float32",
        save_epochs=25, transfer="srgb", hdr=False, snorm=False)
    assert (tmp_path / "r" / "checkpoint_2.pkl").is_file()

    dev = Device("cpu")
    dev.commit()
    f = dev.new_filter("RT")
    g = np.random.default_rng(0)
    color, albedo = g.random((24, 40, 3), np.float32), g.random((24, 40, 3), np.float32)
    output = np.zeros_like(color)
    f.set_image("color", color)
    f.set_image("albedo", albedo)
    f.set_image("output", output)
    f.set_data("weights", out.read_bytes())
    f.commit()
    f.execute()
    assert np.isfinite(output).all() and output.std() > 0
