"""The wavefront's primitive kernel (csrc/prims_hit.cu) on the card against
its plain version.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prims_cuda.py
Without a CUDA device every case skips: the kernel has no CPU mode (its
source is held against the plain version on the host by
tests/test_torch_prims_host.py).

- Every output field of the kernel equals ``intersect_primitives_soa``'s
  bit for bit on the same CUDA tensors: on cornellShipTex's camera rays and
  the rays of each of its 8 bounces, on cornell's and a sphere-only scene's
  rays, and on hand-made rays (origins inside a box, directions with zero
  components and origins on a slab's plane, grazing rays, ties between two
  identical cubes, a zero direction), and on a scene without cubes or
  spheres (an empty table: the miss state).
- The launches: ``depth`` an eager wavefront iteration on the host and on
  the device, and ``depth`` on the device for each graph replay (none on
  the host).
- A whole Renderer iteration's accumulator on the card equals the one
  computed with the plain function in the kernel's place, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prims_hit as ph
from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.render import Renderer, graphs
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.structs import GeomType
from test_torch_prims_host import (REPO, SCENES, assert_running_equal, device_scene, hand_rays,
                                   random_rays, recorded_queries, vec)

DEPTH = 8


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the primitive kernel has no CPU mode")


def _check(meta, dev, o, d):
    before = ph.LAUNCHES
    kernel = trace._Running.from_rows(*ph.prims_hit(dev.prim_table, o, d))
    torch.cuda.synchronize()
    assert ph.LAUNCHES == before + 1
    plain = trace.intersect_primitives_soa(meta, o, d)
    assert_running_equal(kernel, plain)
    return plain


@pytest.mark.requires_cuda
def test_kernel_equals_plain_on_every_bounce():
    _need_cuda()
    dev, meta = device_scene("cornellShipTex", device="cuda")
    queries = recorded_queries("cornellShipTex", 200, device="cuda",
                               options=RenderOptions(megakernel=True))
    assert len(queries) == DEPTH
    for o, d in queries:
        assert int(torch.isfinite(_check(meta, dev, o, d).t).sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["cornell", "sphere"])
def test_kernel_equals_plain_on_scenes(name):
    _need_cuda()
    dev, meta = device_scene(name, device="cuda")
    for o, d in [recorded_queries(name, 64, device="cuda")[0],
                 [vec(a, "cuda") for a in random_rays(5000, 11)]]:
        assert int(torch.isfinite(_check(meta, dev, o, d).t).sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["inside", "axis", "grazing", "zero_dir"])
def test_kernel_equals_plain_on_hand_made_rays(kind, tmp_path):
    _need_cuda()
    dev, meta = device_scene("hand", tmp_path, device="cuda")
    plain = _check(meta, dev, *(vec(a, "cuda") for a in hand_rays(kind, n=2048)))
    if kind == "inside":
        assert bool(torch.isfinite(plain.t).all()) and bool((plain.mat_id == 1).all())


@pytest.mark.requires_cuda
def test_kernel_without_primitives_writes_the_miss_state():
    """A scene with no cube or sphere: an empty table, whose rows the
    kernel never reads."""
    _need_cuda()
    dev, meta = device_scene("shipTexOnly", device="cuda")
    meta = dataclasses.replace(meta, geoms=tuple(g for g in meta.geoms
                                                 if g.type == GeomType.OBJ))
    dev = dev._replace(prim_table=dev.prim_table[:0])
    plain = _check(meta, dev, *(vec(a, "cuda") for a in random_rays(3000, 12)))
    assert bool(torch.isinf(plain.t).all())


@pytest.mark.requires_cuda
def test_launches_depth_per_iteration_and_per_replay():
    _need_cuda()
    scene = load_scene(str(REPO / SCENES["cornellShipTex"]))
    scene.set_resolution(64, 64)
    r = Renderer(scene, RenderOptions(megakernel=True), seed=1, device="cuda")
    assert r.graph_route == "wavefront"
    _build.zero_launches_on_device()
    before = ph.LAUNCHES
    with graphs.disabled():
        r.step()
    assert ph.LAUNCHES == before + DEPTH
    assert _build.launches_on_device("prims_hit") == DEPTH
    r.step_many(2)  # the later iteration's graph captured and replayed
    _build.zero_launches_on_device()
    before = ph.LAUNCHES
    r.step_many(5)
    assert ph.LAUNCHES == before
    assert _build.launches_on_device("prims_hit") == 5 * DEPTH


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["cornellShipTex", "cornell"])
def test_renderer_accumulator_equals_the_plain_functions(name, monkeypatch):
    _need_cuda()

    def accumulator():
        scene = load_scene(str(REPO / SCENES[name]))
        scene.set_resolution(96, 96)
        r = Renderer(scene, RenderOptions(megakernel=name != "cornell"), seed=2, device="cuda")
        assert r.graph_route == "wavefront"
        r.step_many(3)
        return np.ascontiguousarray(r.raw_accumulator())

    before = ph.LAUNCHES
    kernel = accumulator()
    assert ph.LAUNCHES > before
    monkeypatch.setattr(trace, "nearest_primitives",
                        lambda meta, dev, o, d: trace.intersect_primitives_soa(meta, o, d))
    before = ph.LAUNCHES
    plain = accumulator()
    assert ph.LAUNCHES == before
    np.testing.assert_array_equal(kernel.view(np.int32), plain.view(np.int32))
    assert np.abs(plain).sum() > 0
