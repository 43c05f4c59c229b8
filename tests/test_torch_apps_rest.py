"""The port's last apps and utils against the JAX package's, on the CPU:
``apps/convert_image.py``, ``apps/split_exr.py``, ``scene/writer.py``,
the raytrace app's ``--multichip``, ``apps/preview.py``,
``utils/profiling.py``, ``utils/platform.py`` and the port's ``bench``.

Mirrors ``tests/test_apps.py:59-75,141-183``, ``tests/test_exr.py:101`` and
``tests/test_preview.py``. Tolerances: converted images as there (NPY atol
1e-6, RGBE within pixel max / 64 + 1e-4) and, against the JAX app's files,
equal (PNG pixels, EXR bytes); the scene text equal to the JAX writer's;
``--multichip`` images against the sequential app atol 1.5/255 (the JAX
test's bar); the preview's orbit camera atol 1e-5; the phase timer's
report in the JAX timer's format.
"""

import argparse
import ast
import http.client
import json
import math
import os
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu.apps.convert_image import main as jax_convert
from mygpuraytracer_tpu.apps.preview import OrbitCamera as JaxOrbitCamera
from mygpuraytracer_tpu.apps.split_exr import split_exr as jax_split_exr
from mygpuraytracer_tpu.scene.builtin import cornell_box as jax_cornell_box
from mygpuraytracer_tpu.scene.writer import scene_to_text as jax_scene_to_text
from mygpuraytracer_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer

from mygpuraytracer_tpu_torch.apps import raytrace as rt
from mygpuraytracer_tpu_torch.apps.convert_image import main as convert
from mygpuraytracer_tpu_torch.apps.preview import (OrbitCamera, PreviewSession, encode_png,
                                                   make_server)
from mygpuraytracer_tpu_torch.apps.split_exr import split_exr
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.parallel import make_mesh
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box
from mygpuraytracer_tpu_torch.scene.writer import save_scene, scene_to_text
from mygpuraytracer_tpu_torch.utils.exr import read_exr, write_exr
from mygpuraytracer_tpu_torch.utils.image_io import load_image, write_pfm
from mygpuraytracer_tpu_torch.utils.platform import add_device_flag, resolve_device
from mygpuraytracer_tpu_torch.utils.png import decode_png, read_png
from mygpuraytracer_tpu_torch.utils.profiling import PhaseTimer, named_scope, trace

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---- convert_image ---------------------------------------------------------------------


def test_convert_image_cli(tmp_path):
    img = np.random.default_rng(1).random((16, 16, 3)).astype(np.float32)
    write_pfm(str(tmp_path / "x.pfm"), img)
    assert convert([str(tmp_path / "x.pfm"), str(tmp_path / "x.npy")]) == 0
    np.testing.assert_allclose(load_image(str(tmp_path / "x.npy")), img, atol=1e-6)
    assert convert([str(tmp_path / "x.pfm"), str(tmp_path / "x.hdr")]) == 0
    hdr = load_image(str(tmp_path / "x.hdr"))
    tol = img.max(axis=-1, keepdims=True) / 64 + 1e-4  # RGBE: ~pixel max / 128
    assert (np.abs(hdr - img) <= tol).all()


@pytest.mark.parametrize("flags", [[], ["--srgb"], ["--srgb", "--exposure", "2.5"]])
def test_convert_image_png_matches_jax(flags, tmp_path):
    """The LDR output (with --srgb, the encode through denoise/color.py)
    equals the JAX app's pixel for pixel."""
    img = (np.random.default_rng(2).random((12, 20, 3)) * 1.4 - 0.1).astype(np.float32)
    img[0, 0] = np.nan  # sanitized
    write_pfm(str(tmp_path / "x.pfm"), img)
    assert convert([str(tmp_path / "x.pfm"), str(tmp_path / "port.png"), *flags]) == 0
    assert jax_convert([str(tmp_path / "x.pfm"), str(tmp_path / "jax.png"), *flags]) == 0
    assert np.array_equal(read_png(str(tmp_path / "port.png")),
                          read_png(str(tmp_path / "jax.png")))


# ---- split_exr ----------------------------------------------------------------------


def _hdr(seed, h=12, w=10):
    return (np.random.default_rng(seed).random((h, w, 3)) * 8).astype(np.float32)


def test_split_exr_features(tmp_path):
    """hdr/alb/nrm feature images by alias, byte for byte the JAX app's."""
    hdr, alb, nrm = _hdr(4), _hdr(5), _hdr(6)
    names = ["R", "G", "B", "albedo.R", "albedo.G", "albedo.B", "N.R", "N.G", "N.B"]
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        write_exr(str(tmp_path / d / "frame.exr"), np.concatenate([hdr, alb, nrm], axis=-1),
                  half=False, channel_names=names)
    outs = split_exr(str(tmp_path / "port" / "frame.exr"))
    assert sorted(os.path.basename(o) for o in outs) == [
        "frame.alb.exr", "frame.hdr.exr", "frame.nrm.exr"]
    np.testing.assert_array_equal(read_exr(str(tmp_path / "port" / "frame.alb.exr")), alb)
    np.testing.assert_array_equal(read_exr(str(tmp_path / "port" / "frame.nrm.exr")), nrm)
    jax_outs = jax_split_exr(str(tmp_path / "jax" / "frame.exr"))
    for o, j in zip(sorted(outs), sorted(jax_outs)):
        assert pathlib.Path(o).read_bytes() == pathlib.Path(j).read_bytes()
    with pytest.raises(ValueError, match="EXR"):
        split_exr(str(tmp_path / "frame.png"))


def test_split_exr_layer(tmp_path):
    img = _hdr(7)
    p = str(tmp_path / "l.exr")
    write_exr(p, img, half=False,
              channel_names=["view.albedo.R", "view.albedo.G", "view.albedo.B"])
    outs = split_exr(p, layer="view")
    assert [os.path.basename(o) for o in outs] == ["l.alb.exr"]
    np.testing.assert_array_equal(read_exr(outs[0]), img)


# ---- scene writer --------------------------------------------------------------------


def test_scene_writer_roundtrip(tmp_path):
    s = cornell_box()
    assert scene_to_text(s) == jax_scene_to_text(jax_cornell_box())
    path = str(tmp_path / "cornell.txt")
    save_scene(s, path)
    back = load_scene(path)
    assert len(back.geoms) == len(s.geoms)
    assert len(back.materials) == len(s.materials)
    np.testing.assert_allclose(back.geoms[0].transform, s.geoms[0].transform, atol=1e-5)
    np.testing.assert_allclose(back.state.camera.pixel_length, s.state.camera.pixel_length,
                               rtol=1e-6)


# ---- the raytrace app's --multichip ---------------------------------------------------


@pytest.fixture
def cpu_mesh(monkeypatch):
    mesh = make_mesh(devices=("cpu",) * 8)
    monkeypatch.setattr(rt, "make_mesh", lambda *a, **k: mesh)
    return mesh


@pytest.mark.parametrize("mode", ["sample", "pixels"])
def test_raytrace_app_multichip_on_a_cpu_mesh(mode, cpu_mesh, tmp_path, capsys):
    """--multichip renders over the mesh and matches the sequential app."""
    common = ["cornell", "--resolution", "32", "32", "--iterations", "8", "--batch", "4",
              "--no-denoise", "--device", "cpu"]
    assert rt.main(common + ["--quiet", "--out-dir", str(tmp_path / "seq")]) == 0
    assert rt.main(common + ["--out-dir", str(tmp_path / mode), "--multichip", mode]) == 0
    out = capsys.readouterr().out
    assert ("sample-parallel: 8 iterations over 8 devices" if mode == "sample"
            else "pixel-sharded: 8 iterations, 128 lanes/device over 8 devices") in out

    def samp(d):
        fn = [f for f in os.listdir(tmp_path / d) if f.endswith("samp.png")][0]
        return read_png(str(tmp_path / d / fn)).astype(np.float32) / 255

    np.testing.assert_allclose(samp("seq"), samp(mode), atol=1.5 / 255)


def test_raytrace_app_multichip_gets_resolved_options(tmp_path, monkeypatch):
    """The app hands _render_multichip the Renderer's resolved options."""
    seen = {}

    def fake_multichip(r, options, iterations, mode, log):
        seen["options"] = options
        return iterations

    monkeypatch.setattr(rt, "_render_multichip", fake_multichip)
    assert rt.main(["cornell", "--resolution", "16", "16", "--iterations", "4", "--no-denoise",
                    "--quiet", "--multichip", "sample", "--device", "cpu",
                    "--out-dir", str(tmp_path)]) == 0
    assert seen["options"].winner_table != "auto"
    assert seen["options"].mesh_sort is not None


def test_raytrace_app_multichip_single_device_is_sequential(tmp_path, capsys):
    """One device visible: the JAX app's rule, the sequential path."""
    assert rt.main(["cornell", "--resolution", "16", "16", "--iterations", "2", "--no-denoise",
                    "--multichip", "pixels", "--device", "cpu",
                    "--out-dir", str(tmp_path)]) == 0
    assert "multichip: single device visible; using the sequential path" in \
        capsys.readouterr().out


def test_raytrace_app_multichip_remainder_runs_sequentially(cpu_mesh, tmp_path, capsys):
    """10 iterations over 8 devices: 8 split, 2 sequential; 15x15 pixels do
    not divide 8 devices and render sequentially."""
    assert rt.main(["cornell", "--resolution", "16", "16", "--iterations", "10", "--no-denoise",
                    "--multichip", "sample", "--device", "cpu",
                    "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "sample-parallel: 8 iterations" in out and "Iteration 10/10" in out
    assert rt.main(["cornell", "--resolution", "15", "15", "--iterations", "2", "--no-denoise",
                    "--multichip", "pixels", "--device", "cpu",
                    "--out-dir", str(tmp_path)]) == 0
    assert "does not divide 8 devices" in capsys.readouterr().out


# ---- preview --------------------------------------------------------------------------


def test_orbit_camera_matches_jax():
    cam = cornell_box(resolution=(16, 16)).state.camera
    orbit = OrbitCamera(cam)
    jorbit = JaxOrbitCamera(jax_cornell_box(resolution=(16, 16)).state.camera)
    np.testing.assert_allclose(orbit.position(), cam.position, atol=1e-5)
    for o in (orbit, jorbit):
        o.orbit(7.0, -3.0, 16, 16)
        o.zoom_by(2.0, 16)
        o.pan(30.0, -12.0)
    np.testing.assert_allclose(orbit.position(), jorbit.position(), atol=1e-5)
    np.testing.assert_allclose(orbit.look_at, jorbit.look_at, atol=1e-5)


def test_orbit_camera_verbs():
    s = cornell_box(resolution=(16, 16))
    orbit = OrbitCamera(s.state.camera)
    orbit.orbit(0.0, -1e6, 16, 16)
    assert abs(orbit.theta - math.pi) < 1e-6  # theta clamps to [0.001, pi]
    orbit.zoom_by(-1e6, 16)
    assert orbit.zoom == pytest.approx(0.1)  # zoom clamps at 0.1
    orbit = OrbitCamera(s.state.camera)
    before = orbit.look_at.copy()
    orbit.pan(30.0, -12.0)
    assert not np.allclose(orbit.look_at, before)
    assert orbit.look_at[1] == pytest.approx(before[1])
    orbit.recenter()
    np.testing.assert_allclose(orbit.look_at, orbit.og_look_at)


def test_encode_png_round_trips():
    img = np.random.default_rng(3).random((5, 7, 3)).astype(np.float32)
    back = decode_png(encode_png(img))
    assert np.array_equal(back, (np.clip(img, 0, 1) * 255).astype(np.uint8))


@pytest.fixture
def preview():
    session = PreviewSession(cornell_box(resolution=(32, 32)), RenderOptions(), iterations=64,
                             batch=2, device="cpu")
    server = make_server(session, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    session.start()
    conn = http.client.HTTPConnection(*server.server_address, timeout=30)
    yield session, conn
    conn.close()
    server.shutdown()
    server.server_close()
    session.stop()


def _get(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.read()


def _post(conn, path, body):
    conn.request("POST", path, json.dumps(body))
    r = conn.getresponse()
    return r.status, r.read()


def _state(conn):
    return json.loads(_get(conn, "/state")[1])


def _wait_for_iteration(conn, minimum, timeout=60):
    t0 = time.time()
    while time.time() - t0 < timeout:
        state = _state(conn)
        if state["iteration"] >= minimum:
            return state
        time.sleep(0.05)
    raise TimeoutError(f"iteration never reached {minimum}")


def test_preview_progressive_and_camera_reset(preview, tmp_path):
    session, conn = preview
    session.out_dir = str(tmp_path)
    state = _wait_for_iteration(conn, 4)
    assert state["iterations"] == 64 and state["fps"] >= 0
    status, png = _get(conn, "/frame.png")
    assert status == 200 and decode_png(png).shape == (32, 32, 3)
    status, page = _get(conn, "/")
    assert status == 200 and b"Path Tracer" in page
    assert _get(conn, "/nothing")[0] == 404
    resets0 = _state(conn)["resets"]
    _post(conn, "/camera", {})  # no verb: no reset
    _post(conn, "/camera", {"orbit": [5, 3]})
    t0 = time.time()
    while _state(conn)["resets"] == resets0:
        assert time.time() - t0 < 30, "a camera change must zero the accumulator"
        time.sleep(0.01)
    assert _state(conn)["resets"] == resets0 + 1
    _wait_for_iteration(conn, 2)
    status, body = _post(conn, "/save", {"denoise": True})
    saved = json.loads(body)["saved"]
    assert status == 200 and len(saved) == 3
    for suffix in ("samp.png", "albedo.png", "output.png"):
        assert sum(p.endswith(suffix) for p in saved) == 1
    conn.request("POST", "/camera", "{not json")
    resp = conn.getresponse()
    resp.read()
    assert resp.status == 400


def test_preview_session_moves_the_renderer_camera():
    """A camera verb reaches Renderer.move_camera: the accumulation restarts
    from the orbit's position."""
    session = PreviewSession(cornell_box(resolution=(16, 16)), RenderOptions(), iterations=4,
                             batch=4, device="cpu")
    session.start()
    try:
        t0 = time.time()
        while session.state()["iteration"] < 4 and time.time() - t0 < 30:
            time.sleep(0.02)
        session.apply_camera({"zoom": 4.0})
        t0 = time.time()
        while session.state()["resets"] < 1 and time.time() - t0 < 30:
            time.sleep(0.02)
        assert session.state()["resets"] == 1
        np.testing.assert_allclose(session.scene.state.camera.position,
                                   session.orbit.position(), atol=1e-5)
    finally:
        session.stop()


# ---- profiling, platform, bench ------------------------------------------------------------


def test_phase_timer_reports_like_jax():
    timer, jtimer = PhaseTimer(), JaxPhaseTimer()
    for t in (timer, jtimer):
        for _ in range(2):
            with t.phase("denoise"):
                pass
        with t.phase("init"):
            pass
    with timer.phase("sync", sync=torch.zeros(3)):
        pass
    assert timer.counts == {"denoise": 2, "init": 1, "sync": 1}
    pattern = lambda line: (line.split(":")[0], line.split("(")[-1])
    lines, jlines = timer.report().splitlines(), jtimer.report().splitlines()
    assert [pattern(x) for x in lines[:2]] == [pattern(x) for x in jlines]
    assert lines[0].startswith("denoise: ") and lines[0].endswith("ms/call (2x)")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as d:
        assert torch.autograd._profiler_enabled()  # so the gated span opens
        with named_scope("my_region"):
            torch.ones(64).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((pathlib.Path(d) / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
    p = argparse.ArgumentParser()
    add_device_flag(p)
    assert p.parse_args([]).device == "cuda"
    assert p.parse_args(["--device", "cpu"]).device == "cpu"


def _result_keys(path):
    for node in ast.walk(ast.parse(pathlib.Path(path).read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == "result" for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no result = {{...}} in {path}")


def test_bench_keys_are_bench_pys():
    assert _result_keys(REPO / "mygpuraytracer_tpu_torch/bench.py") == _result_keys(
        REPO / "bench.py")


def test_bench_refuses_cuda_without_a_card():
    from mygpuraytracer_tpu_torch import bench

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
