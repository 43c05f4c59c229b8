"""The Renderer's compiled step (render/graphs.py) on the CPU: the iteration
that the card captures into a CUDA graph, run eagerly, against the eager
path and against the JAX package.

Tolerances, each stated where it is checked:

- the device-counted iteration key, uniforms, bounce keys, ``randint`` and
  K6's plain stream against their int forms: bit for bit (integer
  arithmetic on the same words);
- the capture route's iteration (``graphs.wavefront_step``, the iteration
  a 0-dim int64 counter) against ``render_sample`` + ``accumulate_sample``
  at the iteration's int: bitwise on every accumulator (``torch.equal``),
  on the Cornell box, cornellShipTex (textured, bump-mapped, the mesh tiers
  as the card runs them), the open-sky shipTexOnly, each sort form, the
  first-bounce cache and the dir AOV;
- the same iteration against JAX's ``render_sample``: the color rmse <
  1e-3 on the Cornell box (tests/test_torch_render.py's bar, measured 0) and
  bit for bit on the open-sky ship, whose every path ends before the last
  bounce: there JAX skips the bounces with no live lane
  (``lax.cond(any_alive, ...)``) and the port runs them masked;
- the K5 route's iterations from a device-counted start (its plain
  version here): bitwise against the int start;
- ``reset`` and ``move_camera`` keep the storage that a graph holds; a moved
  Renderer equals a fresh one at the new camera bit for bit;
- the launch counts kept on the device add and zero in place.
"""

import contextlib
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.config import RenderOptions as JaxOptions
from mygpuraytracer_tpu.render.pathtrace import make_empty_cache as jax_empty_cache
from mygpuraytracer_tpu.render.pathtrace import render_sample as jax_render_sample
from mygpuraytracer_tpu.scene import builtin as jax_builtin
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prng, rng
from mygpuraytracer_tpu_torch.render import Renderer, graphs, megakernel, pathtrace
from mygpuraytracer_tpu_torch.ops.trace import uses_mesh_tiers
from mygpuraytracer_tpu_torch.scene import builtin, load_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
SEEDS = (0, 7, 2**31 - 1)
RMSE_TOL = 1e-3  # the port against JAX on the color (tests/test_torch_render.py)
# The mesh tiers as the card resolves the app's options (plain versions here).
CARD_MESH = dict(mesh_pallas=True, mesh_sort="need", winner_table="oct", megakernel=True)

_jit_render_sample = jax.jit(jax_render_sample, static_argnums=(1, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(name, res):
    if name in builtin.BUILTIN_SCENES:
        return builtin.BUILTIN_SCENES[name](resolution=(res, res))
    scene = load_scene(str(REPO / f"scenes/{name}.txt"))
    scene.set_resolution(res, res)
    return scene


def _counter(it: int) -> torch.Tensor:
    return torch.tensor(it, dtype=torch.int64)


# ---- the iteration's words on the device ----------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_device_iteration_key_and_draws_bit_exact(seed):
    """Iterations 1-64 as one int64 tensor and each as a 0-dim one: the key
    words, the [k, n] uniforms, a column slice, the bounce keys and
    uniforms, randint and K6's plain stream equal the int forms."""
    base = rng.make_key(seed)
    its = torch.arange(1, 65, dtype=torch.int64)
    k0, k1 = rng.iteration_key(base, its)
    seeds = rng.randint((k0, k1))
    assert seeds.shape == (64,) and seeds.dtype == torch.int64
    for i, it in enumerate(range(1, 65)):
        want = rng.iteration_key(base, it)
        assert (int(k0[i]), int(k1[i])) == want
        assert int(seeds[i]) == rng.randint(want)
        got = rng.iteration_key(base, _counter(it))
        assert got[0].dim() == 0 and (int(got[0]), int(got[1])) == want
        assert int(rng.randint(got)) == rng.randint(want)
        if it % 8 == 1:  # the draws, at a few iterations
            assert torch.equal(rng.uniform(got, (7, 33)), rng.uniform(want, (7, 33)))
            assert torch.equal(rng.uniform_columns(got, 7, 33, 5, 20),
                               rng.uniform_columns(want, 7, 33, 5, 20))
            assert tuple(map(int, rng.bounce_key(got, 3))) == rng.bounce_key(want, 3)
            assert torch.equal(rng.bounce_uniforms(got, 3, 9, 4),
                               rng.bounce_uniforms(want, 3, 9, 4))
            s = rng.randint(want)
            assert torch.equal(prng.uniforms_reference(torch.tensor(s), 7, 2100, col0=40),
                               prng.uniforms_reference(s, 7, 2100, col0=40))
            opts = RenderOptions()
            assert torch.equal(prng.iteration_uniforms(opts, got, None, 28, 50, "cpu"),
                               prng.iteration_uniforms(opts, want, it, 28, 50, "cpu"))


@pytest.mark.parametrize("mode", ["threefry", "pallas"])
def test_sample_uniforms_of_a_counted_iteration(mode, monkeypatch):
    """The raygen and bounce uniforms of an iteration counted on the device
    (what K6 derives under "pallas" from the base key and the iteration in
    device memory; its plain version here) equal the int iteration's, and
    a column range equals its slice of the whole block."""
    monkeypatch.setattr(prng, "uniforms_mode", lambda options, device: mode)
    base, opts = rng.make_key(9), RenderOptions()
    for it in (2, 5, 1000):
        want = prng.iteration_uniforms(opts, rng.iteration_key(base, it), it, 7, 2100, "cpu")
        assert torch.equal(prng.sample_uniforms(opts, base, _counter(it), 7, 2100, "cpu"), want)
        assert torch.equal(prng.sample_uniforms(opts, base, it, 7, 2100, "cpu"), want)
        assert torch.equal(prng.sample_uniforms(opts, base, _counter(it), 7, 2100, "cpu",
                                                pixels=(40, 2000)), want[:, 40:2040])
        if mode == "pallas":
            seed = rng.randint(rng.iteration_key(base, it))
            assert torch.equal(prng.uniforms_reference((base, _counter(it)), 7, 2100),
                               prng.uniforms_reference(seed, 7, 2100))


# ---- the capture route's iteration ------------------------------------------------------

CASES = {
    "cornell": ("cornell", 16, RenderOptions()),
    "cornellShipTex": ("cornellShipTex", 32, RenderOptions(**CARD_MESH)),
    # at 8x8 every path of iteration 2 ends by bounce 2: 5 bounces with no live lane
    "shipTexOnly_open_sky": ("shipTexOnly", 8, RenderOptions(**CARD_MESH)),
    "sort_fused": ("cornell", 16, RenderOptions(sort_by_material=True, sort_impl="fused")),
    "sort_perm": ("cornell", 16, RenderOptions(sort_by_material=True, sort_impl="perm")),
    "sort_argsort": ("cornell", 16, RenderOptions(sort_by_material=True, sort_impl="argsort")),
    "cache_sort_ship": ("cornellShipTex", 32,
                        RenderOptions(antialiasing=False, sort_by_material=True, **CARD_MESH)),
    "dir_aov_dof": ("cornell", 16, RenderOptions(dir_aov=True, depth_of_field=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_capture_route_iteration_is_bitwise_render_sample(case, monkeypatch):
    """Iteration 1 eagerly, then iterations 2-3 twice: through
    ``render_sample`` + ``accumulate_sample`` at the int, and through
    ``graphs.wavefront_step`` from a counter; every accumulator and the
    cache bitwise equal, the counter at 4."""
    dead = _DeadBounces()
    monkeypatch.setattr(pathtrace, "shade_soa", dead.wrap(pathtrace.shade_soa))
    name, res, opts = CASES[case]
    r = Renderer(_scene(name, res), opts, seed=5, device="cpu")
    assert r.graph_route is None  # the CPU runs eagerly
    r.step()
    if opts.first_bounce_cache_active:
        assert torch.isfinite(r.cache.t).any()
    acc, dir_acc = r.acc.clone(), r.dir_acc.clone()
    cache = [t.clone() for t in pathtrace.cache_tensors(r.cache)] if r.cache else []
    for it in (2, 3):
        out = pathtrace.render_sample(r.dev, r.meta, r.options, it, r.base_key, r.cache)
        pathtrace.accumulate_sample(acc, out, it, dir_acc)
    counter = _counter(2)
    for _ in range(2):
        graphs.wavefront_step(r.dev, r.meta, r.options, r.base_key, counter, r.acc, r.dir_acc,
                              r.cache)
    assert int(counter) == 4
    assert torch.equal(r.acc, acc) and torch.equal(r.dir_acc, dir_acc)
    if r.cache:
        assert all(torch.equal(a, b) for a, b in zip(pathtrace.cache_tensors(r.cache), cache))
    assert float(acc[0:3].sum()) > 0
    if opts.dir_aov:
        assert float(dir_acc[3].sum()) > 0
    assert (dead.count > 0) == case.endswith("open_sky")


class _DeadBounces:
    """Counts the shades that run with no live lane."""

    def __init__(self):
        self.count = 0

    def wrap(self, shade):
        def counting(meta, dev, state, hit, *u):
            self.count += not bool((state.remaining > 0).any())
            return shade(meta, dev, state, hit, *u)
        return counting


@pytest.mark.parametrize("name,res,iterations", [("cornell", 16, (2, 3)),
                                                  ("shipTexOnly", 8, (2, 3))])
def test_capture_route_iteration_matches_jax(name, res, iterations, monkeypatch):
    """The counted iteration's color against JAX's ``render_sample`` at the
    same int, the CPU defaults on both sides: within RMSE_TOL on the Cornell
    box, bit for bit on the open-sky ship, where bounces run with every
    path ended (counted) that JAX's guard skips."""
    dead = _DeadBounces()
    monkeypatch.setattr(pathtrace, "shade_soa", dead.wrap(pathtrace.shade_soa))
    if name == "cornell":
        js = jax_builtin.cornell_box(resolution=(res, res))
    else:
        js = jax_load_scene(str(REPO / f"scenes/{name}.txt"))
        js.set_resolution(res, res)
    jdev, jmeta = jax_build(js)
    r = Renderer(_scene(name, res), RenderOptions(), seed=5, device="cpu")
    n = res * res
    for it in iterations:
        acc = torch.zeros((9, n))
        graphs.wavefront_step(r.dev, r.meta, r.options, r.base_key, _counter(it), acc,
                              torch.zeros((4, n)), None)
        jout = _jit_render_sample(jdev, jmeta, JaxOptions(megakernel=False), jnp.int32(it),
                                  jax.random.key(5), jax_empty_cache(n))
        want = np.stack([np.asarray(c) for c in jout.color])
        got = acc[0:3].numpy()
        if name == "cornell":
            assert float(np.sqrt(np.mean((got - want) ** 2))) < RMSE_TOL
        else:
            np.testing.assert_array_equal(got, want)
        assert not acc[3:9].any()  # a counted iteration is never the first
    if name == "shipTexOnly":
        assert dead.count > 0


def test_k5_batch_from_a_device_counter_is_bitwise():
    """K5's route from a counted start (its plain version on the CPU): two
    steps, iterations 2-3, into an accumulator equal the int start's batch,
    bit for bit."""
    opts = RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto")
    r = Renderer(_scene("cornellShip", 12), opts, seed=4, device="cpu")
    assert r.use_megakernel and megakernel._uses_bvh(r.meta)
    r.step()
    acc = r.acc.clone()
    megakernel.bvh_bounce_accumulate(r.dev, r.meta, opts, acc, 2, 2, r.base_key)
    counter = _counter(2)
    for _ in range(2):
        graphs.bounce_step(r.dev, r.meta, opts, r.base_key, counter, r.acc, r.record)
    assert int(counter) == 4 and torch.equal(r.acc, acc)


# ---- the buffers a graph holds ---------------------------------------------------------

def _held(r):
    cache = pathtrace.cache_tensors(r.cache) if r.cache is not None else []
    record = [r.record] if r.record is not None else []
    return [t.data_ptr() for t in (r.acc, r.dir_acc, *r.dev.camera, *cache, *record)]


def test_reset_keeps_storage_and_zeroes():
    r = Renderer(_scene("cornell", 8), RenderOptions(antialiasing=False, dir_aov=True), seed=1,
                 device="cpu")
    assert r.options.first_bounce_cache_active
    r.render(iterations=3)
    held = _held(r)
    assert float(r.acc.abs().sum()) > 0 and float(r.dir_acc.abs().sum()) > 0
    assert torch.isfinite(r.cache.t).any()
    r.reset()
    assert _held(r) == held and r.iteration == 0
    assert not r.acc.any() and not r.dir_acc.any()
    assert not torch.isfinite(r.cache.t).any()
    assert not any(t.any() for t in pathtrace.cache_tensors(r.cache)[1:])


@pytest.mark.parametrize("route", ["wavefront_cache", "k5"])
def test_move_camera_in_place_equals_fresh(route):
    """The moved Renderer's camera tensors, cache and K5 record keep their
    storage; 2 iterations after the move equal a fresh Renderer's at the
    new camera, bitwise."""
    name, res, opts = (("cornell", 12, RenderOptions(antialiasing=False)) if route != "k5" else
                       ("cornellShip", 12, RenderOptions(megakernel=True, bounce_megakernel=True,
                                                         rng="auto")))
    position, look_at = [0.0, 5.0, 12.0], [0.0, 4.0, 0.0]
    r = Renderer(_scene(name, res), opts, seed=2, device="cpu")
    r.render(iterations=2)
    held = _held(r)
    r.move_camera(position=position, look_at=look_at)
    assert _held(r) == held
    r.render(iterations=2)
    scene = _scene(name, res)
    scene.state.camera.position = np.asarray(position, np.float32)
    scene.state.camera.look_at = np.asarray(look_at, np.float32)
    scene.state.camera.rebuild()
    fresh = Renderer(scene, opts, seed=2, device="cpu")
    fresh.render(iterations=2)
    for a, b in zip(r.dev.camera, fresh.dev.camera):
        assert torch.equal(a, b)
    assert torch.equal(r.acc, fresh.acc)
    if r.record is not None:
        assert torch.equal(r.record, fresh.record)


# ---- the route, chosen up front ---------------------------------------------------------

ROUTES = {
    "cornell_wavefront": ("cornell", RenderOptions(), "wavefront"),
    "cornell_k1": ("cornell", RenderOptions(megakernel=True), None),
    "cornell_dir_aov_megakernel": ("cornell", RenderOptions(megakernel=True, dir_aov=True),
                                   "wavefront"),
    "ship_tiers": ("cornellShipTex", RenderOptions(megakernel=True), "wavefront"),
    "ship_chunked": ("cornellShipTex", RenderOptions(mesh_pallas=False), None),
    "ship_k5": ("cornellShip", RenderOptions(megakernel=True, bounce_megakernel=True), "k5"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_graph_route_from_the_options(case):
    """What a Renderer on CUDA would capture, from its options alone (the
    route as ``_graph_route`` decides it for a CUDA device)."""
    name, opts, want = ROUTES[case]
    r = Renderer(_scene(name, 8), opts, device="cpu")
    r.device = torch.device("cuda")
    r.use_megakernel = bool(opts.megakernel and not opts.dir_aov
                            and megakernel.supports_megakernel(r.meta, opts))
    assert r._graph_route() == want
    if name != "cornell":
        tiers = uses_mesh_tiers(r.meta, opts.mesh_pallas, "cuda")
        assert tiers == (opts.mesh_pallas is not False)


def test_a_small_mesh_runs_eagerly(tmp_path):
    """A mesh of 256 faces or fewer on the wavefront takes the chunked
    stream, whose live-lane compaction has data-dependent shapes."""
    from test_torch_render import write_cube_scene

    r = Renderer(load_scene(write_cube_scene(tmp_path)), RenderOptions(), device="cpu")
    assert r.meta.has_obj and not uses_mesh_tiers(r.meta, r.options.mesh_pallas, "cuda")
    r.device = torch.device("cuda")
    assert r._graph_route() is None


# ---- the launch counts kept on the device ------------------------------------------------

def test_launches_counted_on_device_add_and_zero():
    """``_build.count_on_device`` keeps one int64 per (kernel, device) and
    adds one per call on the device (here the CPU stands in); zeroing keeps
    the tensor (a graph holds its address)."""
    from mygpuraytracer_tpu_torch import _build

    _build.zero_launches_on_device()
    for _ in range(3):
        _build.count_on_device("test_kernel", "cpu")
    _build.count_on_device("test_other", "cpu")
    held = _build._on_device[("test_kernel", torch.device("cpu"))]
    assert _build.launches_on_device("test_kernel") == 3
    assert _build.launches_on_device("test_other") == 1
    assert _build.launches_on_device("test_none") == 0
    _build.zero_launches_on_device()
    assert _build.launches_on_device("test_kernel") == 0
    assert _build._on_device[("test_kernel", torch.device("cpu"))] is held


def test_disabled_nests():
    assert graphs.enabled()
    with graphs.disabled():
        assert not graphs.enabled()
        with graphs.disabled():
            assert not graphs.enabled()
        assert not graphs.enabled()
    assert graphs.enabled()


def test_steps_are_eager_on_the_cpu():
    """The CPU Renderer and one inside ``disabled()`` give the same
    accumulators (both eager), and neither captures."""
    accs = []
    for ctx in (contextlib.nullcontext(), graphs.disabled()):
        r = Renderer(_scene("cornell", 8), RenderOptions(), seed=1, device="cpu")
        with ctx:
            r.step_many(3)
        assert r.iteration == 3 and r.graph is None
        accs.append(r.acc)
    assert torch.equal(*accs)
