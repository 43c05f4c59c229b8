"""The Renderer's CUDA graphs on the card: replays change the order of the
host's work, never the image.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_cuda.py
Without a CUDA device every case skips: a CUDA graph, K5 and K6 have no CPU
mode.

At 64x64: the graph route against the eager route (``graphs.disabled()``),
bitwise on the accumulators (``torch.equal``), on the Cornell box's
wavefront, cornellShipTex under the app's options, each sort form, the
first-bounce cache, the dir AOV and cornellShip through K5; no host sync
after iteration 1; the kernels' launches counted on the card equal on
both routes (the replays' included) and equal the eager route's host
launches; K6 and K5 deriving their words from the iteration in device
memory equal their by-value launches bit for bit; a moved Renderer equal to
a fresh one at the new camera; three moves with ``step_many(3)`` between
equal to the eager route, the wavefront's graph of iteration 1 kept across
them; a moved step with no host sync and no host launch of a kernel, its
launches counted on the card; a replaced buffer recapturing both graphs.
"""

import contextlib
import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import prng, rng
from mygpuraytracer_tpu_torch.render import Renderer, graphs, megakernel, pathtrace
from mygpuraytracer_tpu_torch.render.camera import generate_camera_rays
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 64
APP = dict(megakernel=True, mesh_sort=None, winner_table="auto")
K5 = dict(megakernel=True, bounce_megakernel=True, rng="auto")
CASES = {
    "cornell_dof_sort": ("cornell", dict(depth_of_field=True, antialiasing=False,
                                         sort_by_material=True), "wavefront", 4),
    "cornell_cache": ("cornell", dict(antialiasing=False), "wavefront", 4),
    "cornell_dir_aov": ("cornell", dict(dir_aov=True), "wavefront", 4),
    "cornellShipTex": ("cornellShipTex", APP, "wavefront", 4),
    "cornellShipTex_sort_perm": ("cornellShipTex", dict(APP, sort_by_material=True,
                                                        sort_impl="perm"), "wavefront", 3),
    "cornellShipTex_cache": ("cornellShipTex", dict(APP, antialiasing=False), "wavefront", 3),
    "cornellShip_k5": ("cornellShip", K5, "k5", 16),
    "cornellShip_k5_threefry": ("cornellShip", dict(K5, rng="threefry"), "k5", 3),
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs, K5 and K6 have no CPU mode")


def _scene(name):
    if name == "cornell":
        return cornell_box(resolution=(RES, RES))
    scene = load_scene(str(REPO / "scenes" / f"{name}.txt"))
    scene.set_resolution(RES, RES)
    return scene


def _render(name, opts, iters, eager):
    """The Renderer after ``iters`` iterations (in two calls), the kernels'
    launches from the host, and those counted on the card."""
    r = Renderer(_scene(name), RenderOptions(**opts), seed=1, device="cuda")
    mh.LAUNCHES = megakernel.BOUNCE_LAUNCHES = prng.LAUNCHES = 0
    _build.zero_launches_on_device()
    with graphs.disabled() if eager else contextlib.nullcontext():
        r.step_many(iters - 1)
        r.step()
    torch.cuda.synchronize()
    ran = tuple(_build.launches_on_device(k) for k in ("mesh_hit", "k5", "k6"))
    return r, (mh.LAUNCHES, megakernel.BOUNCE_LAUNCHES, prng.LAUNCHES), ran


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graph_route_bitwise_eager(case):
    _need_cuda()
    name, opts, route, iters = CASES[case]
    g, g_host, g_ran = _render(name, opts, iters, eager=False)
    e, e_host, e_ran = _render(name, opts, iters, eager=True)
    assert g.graph_route == route and g.graph is not None and e.graph is None
    assert torch.equal(g.acc, e.acc) and torch.equal(g.dir_acc, e.dir_acc)
    # On the card both routes launch the same kernels; from the host the
    # graph route launches iteration 1's and records the captures': on the
    # wavefront iteration 1's graph and the later iteration's, on K5 the
    # later iteration's alone.
    assert g_ran == e_ran == e_host, (g_ran, e_ran, e_host)
    first = tuple(x // iters for x in e_host) if "cache" not in case else None
    if first is not None:
        times = 3 if route == "wavefront" else 2
        assert g_host == tuple(times * x for x in first), (g_host, e_host)
    assert (sum(g_ran) > 0) == (name != "cornell")  # the Cornell box runs no kernel
    assert float(g.acc[0:3].sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["cornellShipTex", "cornellShip_k5"])
def test_no_host_sync_after_iteration_1(case):
    _need_cuda()
    name, opts, _, _ = CASES[case]
    r = Renderer(_scene(name), RenderOptions(**opts), seed=1, device="cuda")
    r.step_many(2)  # iteration 1 and the captures
    r.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.step_many(18)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert r.iteration == 18 and bool(torch.isfinite(r.acc).all())


@pytest.mark.requires_cuda
def test_device_words_equal_by_value_launches():
    """K6 and K5 deriving their words from the base key and the iteration in
    device memory equal their by-value launches bit for bit."""
    _need_cuda()
    r = Renderer(_scene("cornellShip"), RenderOptions(**K5), seed=3, device="cuda")
    n = RES * RES
    for it in (1, 2, 3, 2**31 - 1):
        counted = torch.tensor(it, dtype=torch.int64, device="cuda")
        ikey = rng.iteration_key(r.base_key, it)
        assert torch.equal(prng.pallas_uniforms((r.base_key, counted), 28, n, "cuda"),
                           prng.pallas_uniforms(rng.randint(ikey), 28, n, "cuda"))
        U = prng.iteration_uniforms(r.options, ikey, it, 4, n, "cuda")
        o, d = generate_camera_rays(r.dev.camera, r.meta.resolution, r.options, U)
        rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])
        a, b = torch.zeros((9, n), device="cuda"), torch.zeros((9, n), device="cuda")
        megakernel.bounce_launch(r.dev, r.meta, r.options, a, rays, it, ikey, r.record)
        megakernel.bounce_launch(r.dev, r.meta, r.options, b, rays, counted, None, r.record,
                                 base_key=r.base_key)
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["cornellShipTex_cache", "cornellShip_k5"])
def test_move_camera_replays_equal_fresh(case):
    _need_cuda()
    name, opts, _, _ = CASES[case]
    position = [0.0, 5.0, 9.0]
    r = Renderer(_scene(name), RenderOptions(**opts), seed=2, device="cuda")
    r.step_many(3)
    captured = r.graph
    r.move_camera(position=position)
    r.step_many(3)
    assert r.graph is captured  # the same graph, replayed at the new camera
    scene = _scene(name)
    scene.state.camera.position = np.asarray(position, np.float32)
    scene.state.camera.rebuild()
    fresh = Renderer(scene, RenderOptions(**opts), seed=2, device="cuda")
    fresh.step_many(3)
    assert torch.equal(r.acc, fresh.acc)



MOVES = ([0.0, 5.0, 9.0], [1.0, 5.5, 9.5], [-1.0, 4.5, 10.0])


def _drag(name, opts, eager, replace_acc=False):
    """``step_many(3)``, then three moves each followed by ``step_many(3)``
    (with ``replace_acc``, ``acc`` replaced by a copy before the first
    move). Returns the Renderer, its graphs (of iteration 1, of a later one)
    before the moves, and its graph of iteration 1 after each move."""
    r = Renderer(_scene(name), RenderOptions(**opts), seed=1, device="cuda")
    firsts = []
    with graphs.disabled() if eager else contextlib.nullcontext():
        r.step_many(3)
        before = (r.graph_first, r.graph)
        if replace_acc:
            r.acc = r.acc.clone()
        for position in MOVES:
            r.move_camera(position=position)
            r.step_many(3)
            firsts.append(r.graph_first)
    torch.cuda.synchronize()
    return r, before, firsts


def _equal_accumulators(g, e):
    assert torch.equal(g.acc, e.acc) and torch.equal(g.dir_acc, e.dir_acc)
    if g.cache is not None:
        assert all(torch.equal(a, b) for a, b in zip(pathtrace.cache_tensors(g.cache),
                                                     pathtrace.cache_tensors(e.cache)))
    assert bool(g.acc[3:6].any()) and float(g.acc[0:3].sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["cornellShipTex", "cornellShipTex_cache", "cornell_dof_sort",
                                  "cornell_dir_aov"])
def test_moved_renderer_replays_first_graph_bitwise_eager(case):
    _need_cuda()
    name, opts, _, _ = CASES[case]
    g, before, firsts = _drag(name, opts, eager=False)
    e, _, _ = _drag(name, opts, eager=True)
    assert before[0] is not None and all(f is before[0] for f in firsts)
    assert e.graph_first is None and e.graph is None
    _equal_accumulators(g, e)


@pytest.mark.requires_cuda
def test_moved_step_launches_nothing_from_the_host():
    """After a move, ``step_many(1)`` replays the graph of iteration 1: no
    host sync, the wrappers' host counters unchanged, the card's counts up
    by one iteration's launches (those of the same iteration run eagerly),
    and the same accumulators."""
    _need_cuda()
    name, opts, _, _ = CASES["cornellShipTex"]
    r = Renderer(_scene(name), RenderOptions(**opts), seed=1, device="cuda")
    r.step_many(2)  # the eager iteration 1 and both captures
    r.move_camera(position=MOVES[0])
    torch.cuda.synchronize()
    host = (mh.LAUNCHES, prng.LAUNCHES)
    _build.zero_launches_on_device()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.step_many(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (mh.LAUNCHES, prng.LAUNCHES) == host
    ran = tuple(_build.launches_on_device(k) for k in ("mesh_hit", "k6"))
    acc = r.acc.clone()
    r.reset()
    mh.LAUNCHES = prng.LAUNCHES = 0
    with graphs.disabled():
        r.step_many(1)
    torch.cuda.synchronize()
    assert ran == (mh.LAUNCHES, prng.LAUNCHES) and ran[0] > 0, (ran, mh.LAUNCHES)
    assert torch.equal(r.acc, acc)


@pytest.mark.requires_cuda
def test_replaced_buffer_recaptures_both_graphs():
    """``acc`` replaced after both captures: the next iteration 1 runs
    eagerly and both graphs are captured anew, the new graph of iteration
    1 then kept across the moves; bitwise the eager route."""
    _need_cuda()
    name, opts, _, _ = CASES["cornellShipTex_cache"]
    g, before, firsts = _drag(name, opts, eager=False, replace_acc=True)
    e, _, _ = _drag(name, opts, eager=True, replace_acc=True)
    assert None not in before
    assert firsts[0] not in (None, before[0]) and all(f is firsts[0] for f in firsts)
    assert g.graph not in (None, before[1])
    _equal_accumulators(g, e)
