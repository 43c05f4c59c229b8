"""The Renderer's auto options against the JAX package's, case by case
(the model: tests/test_mesh_sort_auto.py).

``mesh_reach_fraction`` is a numpy estimate on the host and must equal
JAX's exactly. Where JAX asks whether its backend is a TPU, the port asks
whether the Renderer's device is CUDA; the resolution itself runs on the
host, so the CUDA cases are checked here without a card.
"""

import pathlib

import pytest
import torch

from mygpuraytracer_tpu.config import RenderOptions as JaxOptions
from mygpuraytracer_tpu.render import renderer as jax_renderer
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.render import Renderer
from mygpuraytracer_tpu_torch.render import renderer
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENES = ["cornellShipTex", "cornellShip", "shipOnly", "shipTexOnly", "builtin_cornell"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _both(name):
    path = str(REPO / f"scenes/{name}.txt")
    js, ts = jax_load_scene(path), load_scene(path)
    return (js, jax_build(js, 64)[1]), (ts, build_device_scene(ts, 64, device="cpu")[1])


@pytest.mark.parametrize("name", SCENES)
def test_mesh_reach_fraction_matches_jax(name):
    (js, jmeta), (ts, meta) = _both(name)
    assert renderer.mesh_reach_fraction(ts, meta) == jax_renderer.mesh_reach_fraction(js, jmeta)


def test_embedded_mesh_enables_need_on_cuda():
    (js, jmeta), (ts, meta) = _both("cornellShipTex")
    assert renderer.mesh_reach_fraction(ts, meta) < 0.30
    # JAX with mesh_pallas forced on (its TPU case) and the port on CUDA
    want = jax_renderer._resolve_auto_options(JaxOptions(mesh_pallas=True), js, jmeta)
    assert want.mesh_sort == "need"
    for opts, device in ((RenderOptions(), "cuda"), (RenderOptions(mesh_pallas=True), "cpu")):
        assert renderer._resolve_auto_options(opts, ts, meta, device).mesh_sort == "need"


def test_mesh_only_scene_stays_unsorted():
    (js, jmeta), (ts, meta) = _both("shipOnly")
    want = jax_renderer._resolve_auto_options(JaxOptions(mesh_pallas=True), js, jmeta)
    got = renderer._resolve_auto_options(RenderOptions(), ts, meta, "cuda")
    assert want.mesh_sort is False and got.mesh_sort is False


def test_explicit_values_pass_through():
    (js, jmeta), (ts, meta) = _both("cornellShipTex")
    for v in (False, True, "need", "coherence"):
        want = jax_renderer._resolve_auto_options(JaxOptions(mesh_pallas=True, mesh_sort=v),
                                                  js, jmeta)
        got = renderer._resolve_auto_options(RenderOptions(mesh_sort=v), ts, meta, "cuda")
        assert want.mesh_sort == got.mesh_sort == v


def test_cpu_resolves_false_and_no_mesh_stays_false():
    (js, jmeta), (ts, meta) = _both("cornellShipTex")
    # JAX on its CPU backend: mesh_pallas=None resolves to the chunked stream
    assert jax_renderer._resolve_auto_options(JaxOptions(), js, jmeta).mesh_sort is False
    assert renderer._resolve_auto_options(RenderOptions(), ts, meta, "cpu").mesh_sort is False
    assert renderer._resolve_auto_options(
        RenderOptions(mesh_pallas=False), ts, meta, "cuda").mesh_sort is False
    (_, _), (ts, meta) = _both("builtin_cornell")
    assert renderer._resolve_auto_options(RenderOptions(), ts, meta, "cuda").mesh_sort is False


def test_winner_table_resolution():
    assert jax_renderer._resolve_winner_table(JaxOptions()).winner_table == "f32"  # JAX on CPU
    assert renderer._resolve_winner_table(RenderOptions(), "cpu").winner_table == "f32"
    assert renderer._resolve_winner_table(RenderOptions(), "cuda").winner_table == "oct"
    for v in ("f32", "f16", "oct"):
        assert renderer._resolve_winner_table(RenderOptions(winner_table=v), "cuda").winner_table == v


def test_renderer_resolves_at_construction_and_renders_textures():
    scene = load_scene(str(REPO / "scenes/shipTexOnly.txt"))
    scene.set_resolution(8, 8)
    r = Renderer(scene, RenderOptions(), device="cpu")
    assert r.options.mesh_sort is False and r.options.winner_table == "f32"
    assert not r.use_megakernel
    img = r.render(iterations=1)
    assert img.shape == (8, 8, 3) and img.max() > 0
