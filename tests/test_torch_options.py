"""The wavefront's options and the rest of the Renderer surface, port against
JAX and port against itself, on the CPU at small sizes.

Tolerances, each stated where it is checked:

- the material sort: every ``_sort_wavefront`` output field and the pixel
  map bitwise equal to JAX's ``argsort`` form on the same inputs, for each
  of the port's three forms; a sorted render bitwise equal to the unsorted
  one (``torch.equal`` on the accumulators);
- the first-bounce cache: on and off bitwise, one bounce-0 scene query per
  reset with it;
- the port against the JAX package's renders: rtol 1e-5 / atol 1e-6 on the
  color (JAX's own bar between its sorted and unsorted images), 1e-4 on the
  first-hit normal (XLA and torch may round a normalization differently);
  the dir AOV atol 1e-5;
- ``intersect_scene`` against JAX's: hits agree, t rtol 1e-5, uv atol 1e-5,
  normals within 1e-4 on 99.9% of the hits. The byte atlas is decoded as
  ``byte / 255`` in float32 on both sides (JAX's f32 atlas holds
  ``u8.astype(float32) / 255``), so the texels are the same floats; what
  remains is the rounding of the matrix products and norms;
- the port's ``intersect_soa`` against its ``intersect_scene``: the bars of
  tests/test_fastpath.py and tests/test_bump.py (t rtol 2e-4, normals
  within 1e-3 on 99.9% of hits, 2e-3 on the bump-mapped ship).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.config import RenderOptions as JaxOptions
from mygpuraytracer_tpu.ops import rng as jax_rng
from mygpuraytracer_tpu.ops import vec3 as jax_vec3
from mygpuraytracer_tpu.ops.intersect import intersect_scene as jax_intersect_scene
from mygpuraytracer_tpu.ops.trace import HitSoA as JaxHit
from mygpuraytracer_tpu.render import Renderer as JaxRenderer
from mygpuraytracer_tpu.render.pathtrace import _sort_wavefront as jax_sort_wavefront
from mygpuraytracer_tpu.render.shade import PathStateSoA as JaxState
from mygpuraytracer_tpu.scene import builtin as jax_builtin
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch import ops as port_ops
from mygpuraytracer_tpu_torch.apps import benchmark, raytrace
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import rng, vec3
from mygpuraytracer_tpu_torch.ops.intersect import intersect_scene
from mygpuraytracer_tpu_torch.ops.trace import HitSoA, intersect_soa
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import Renderer, megakernel, pathtrace
from mygpuraytracer_tpu_torch.render.camera import generate_camera_rays
from mygpuraytracer_tpu_torch.render.shade import PathStateSoA, shade_soa
from mygpuraytracer_tpu_torch.scene import builtin, load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene
from mygpuraytracer_tpu_torch.scene.structs import GeomType
from mygpuraytracer_tpu_torch.utils.png import read_png
from mygpuraytracer_tpu_torch.utils.timer import PerformanceTimer, timed_ms

REPO = pathlib.Path(__file__).resolve().parent.parent
SHIP_TEX = str(REPO / "scenes/cornellShipTex.txt")
IMPLS = ("fused", "perm", "argsort")
RTOL, ATOL = 1e-5, 1e-6  # color, port against JAX
NORMAL_TOL = 1e-4
DIR_ATOL = 1e-5
EDGE_TIE_SHARE = 0.01  # pixels whose first hit is an exact tie between two walls (AA off)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cornell(res=16):
    return builtin.cornell_box(resolution=(res, res))


def _ship(res=24, path=SHIP_TEX):
    scene = load_scene(path)
    scene.set_resolution(res, res)
    return scene


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for a in x for leaf in _leaves(a)]
    return [x]


# ---- the material sort ---------------------------------------------------------------

def _to_jax(x):
    """A port state/hit (nested NamedTuples of tensors) as the JAX types."""
    kinds = {PathStateSoA: JaxState, HitSoA: JaxHit, Vec3: jax_vec3.Vec3}
    if isinstance(x, tuple):
        jt = kinds[type(x)]
        assert jt._fields == type(x)._fields
        return jt(*(_to_jax(a) for a in x))
    return jnp.asarray(x.numpy())


def _wavefront_inputs(scene, seed=7):
    """(meta, [(state, hit)]) at bounce 0 (camera rays) and bounce 1 (after
    one shade, dead lanes masked out of the query), from the port."""
    options = RenderOptions()
    dev, meta = build_device_scene(scene, options.face_chunk, device="cpu")
    n = meta.resolution[0] * meta.resolution[1]
    U = rng.uniform(rng.iteration_key(rng.make_key(seed), 1),
                    (pathtrace.num_rng_streams(meta.trace_depth), n))
    o, d = generate_camera_rays(dev.camera, meta.resolution, options, U)
    ones = torch.ones(n)
    state = PathStateSoA(o, d, Vec3(ones, ones, ones),
                         torch.full((n,), meta.trace_depth, dtype=torch.int32))
    hit = intersect_soa(meta, dev, o, d, options.face_chunk)
    state1 = shade_soa(meta, dev, state, hit, U[4], U[5], U[6])
    active = state1.remaining > 0
    hit1 = intersect_soa(meta, dev, state1.origin, state1.direction, options.face_chunk,
                         active=active)
    return dev, meta, [(state, hit), (state1, hit1)]


SORT_SCENES = {"cornell": lambda: _cornell(16), "cornellShipTex": lambda: _ship(24)}


@pytest.mark.parametrize("scene", list(SORT_SCENES))
def test_sort_wavefront_matches_jax_argsort(scene):
    """Each form's every output field and the pixel map, bitwise against
    JAX's argsort form on the same inputs (both bounces)."""
    dev, meta, inputs = _wavefront_inputs(SORT_SCENES[scene]())
    assert meta.has_textures == (scene == "cornellShipTex")
    num_materials = int(dev.mat_color.shape[0])
    for state, hit in inputs:
        n = state.remaining.shape[0]
        pixel = torch.arange(n, dtype=torch.int32)
        want = jax_sort_wavefront(None, _to_jax(state), _to_jax(hit), jnp.asarray(pixel.numpy()),
                                  num_materials, "argsort")
        for impl in IMPLS:
            got = pathtrace._sort_wavefront(meta, state, hit, pixel, num_materials, impl)
            got_l, want_l = _leaves(got), _leaves(tuple(want))
            assert len(got_l) == len(want_l) == 10 + 24 + 1  # state, hit, pixel
            for i, (g, w) in enumerate(zip(got_l, want_l)):
                w = np.asarray(w)
                assert g.dtype == torch.from_numpy(w).dtype, (impl, i)
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{impl} leaf {i}")
        mats = hit.material_id.numpy()
        assert len(np.unique(mats)) > 2  # the sort has work to do


def test_sort_wavefront_rejects_unknown_impl():
    dev, meta, ((state, hit), _) = _wavefront_inputs(_cornell(8))
    with pytest.raises(ValueError, match="unknown sort_impl"):
        pathtrace._sort_wavefront(meta, state, hit, torch.arange(64, dtype=torch.int32), 8, "x")
    with pytest.raises(ValueError, match="unknown sort_impl 'bitonic'"):
        RenderOptions(sort_impl="bitonic")


RENDER_SORT_CASES = {
    "cornell_dof": (lambda: _cornell(24), dict(depth_of_field=True, antialiasing=False)),
    # The card's route: the mesh tier with the "need" reorder (its plain
    # version on the CPU).
    "cornellShipTex": (lambda: _ship(24), dict(mesh_pallas=True, mesh_sort="need",
                                              winner_table="f32")),
}


@pytest.mark.parametrize("case", list(RENDER_SORT_CASES))
def test_sorted_render_is_bitwise_unsorted(case):
    """Each sort form renders the unsorted accumulators bit for bit
    (2 iterations), and the sort really runs."""
    make, opts = RENDER_SORT_CASES[case]
    base = Renderer(make(), RenderOptions(**opts), seed=3, device="cpu")
    base.render(iterations=2)
    calls = []
    orig = pathtrace._sort_wavefront

    def spy(*args, **kwargs):
        calls.append(args[-1])
        return orig(*args, **kwargs)

    for impl in IMPLS:
        calls.clear()
        pathtrace._sort_wavefront = spy
        try:
            r = Renderer(make(), RenderOptions(sort_by_material=True, sort_impl=impl, **opts),
                         seed=3, device="cpu")
            r.render(iterations=2)
        finally:
            pathtrace._sort_wavefront = orig
        assert calls and set(calls) == {impl}
        assert torch.equal(r.acc, base.acc), impl
    assert float(base.acc[0:3].sum()) > 0


def test_sorted_render_matches_jax():
    """The sorted Cornell box with DoF (BASELINE config #3's options) at
    16x16 against the JAX package's sorted render, 2 iterations."""
    opts = dict(depth_of_field=True, cache_first_bounce=True, sort_by_material=True,
                antialiasing=False, megakernel=False)
    jr = JaxRenderer(jax_builtin.cornell_box(resolution=(16, 16)), JaxOptions(**opts), seed=4)
    jr.step_many(2)
    tr = Renderer(_cornell(16), RenderOptions(**opts), seed=4, device="cpu")
    tr.step_many(2)
    np.testing.assert_allclose(tr.raw_accumulator(), jr.raw_accumulator(), rtol=RTOL, atol=ATOL)
    assert tr.raw_accumulator().mean() > 0


def test_sort_off_for_single_geom_and_dir_aov(monkeypatch):
    """As in JAX: no sort with one geom, or under dir_aov."""
    monkeypatch.setattr(pathtrace, "_sort_wavefront", _refuse)
    r = Renderer(builtin.emissive_sphere(resolution=(8, 8)),
                 RenderOptions(sort_by_material=True), seed=0, device="cpu")
    r.render(iterations=1)
    r = Renderer(_cornell(8), RenderOptions(sort_by_material=True, dir_aov=True), seed=0,
                 device="cpu")
    r.render(iterations=1)


def _refuse(*args, **kwargs):
    raise AssertionError("the sort ran")


# ---- the first-bounce cache ---------------------------------------------------------

def _count_bounce0(monkeypatch):
    count = [0]
    orig = pathtrace.intersect_soa

    def counting(meta, dev, o, d, *args, active=None, **kwargs):
        count[0] += active is None
        return orig(meta, dev, o, d, *args, active=active, **kwargs)

    monkeypatch.setattr(pathtrace, "intersect_soa", counting)
    return count


@pytest.mark.parametrize("sort", [False, True])
def test_first_bounce_cache_is_bitwise_and_queries_once(monkeypatch, sort):
    """AA and DoF off: with the cache one bounce-0 query per reset, without
    it one per iteration; the accumulators bitwise the same. The cache
    holds the unsorted (pixel-order) first hit and owns its tensors: later
    iterations leave it as stored."""
    count = _count_bounce0(monkeypatch)
    accs = {}
    for cache in (True, False):
        count[0] = 0
        opts = RenderOptions(antialiasing=False, cache_first_bounce=cache, sort_by_material=sort)
        assert opts.first_bounce_cache_active == cache
        r = Renderer(_cornell(16), opts, seed=2, device="cpu")
        r.step()
        if cache:
            snapshot = [x.clone() for x in _leaves(r.cache)]
            o, d = generate_camera_rays(r.dev.camera, r.meta.resolution, opts,
                                        torch.zeros(4, 16 * 16))
            primary = intersect_soa(r.meta, r.dev, o, d)
            assert torch.equal(primary.t, r.cache.t)
            assert torch.equal(primary.material_id, r.cache.material_id)
        r.step_many(3)
        assert count[0] == (1 if cache else 4)
        accs[cache] = r.acc.clone()
        if cache:
            assert all(torch.equal(a, b) for a, b in zip(snapshot, _leaves(r.cache)))
            r.reset()  # drops the cache: the next render queries bounce 0 once more
            assert not torch.isfinite(r.cache.t).any()
            r.render(iterations=4, batch=3)
            assert count[0] == 2 and torch.equal(r.acc, accs[True])
        else:
            assert r.cache is None
    assert torch.equal(accs[True], accs[False])


def test_first_bounce_cache_matches_jax():
    """The cached render at 16x16, AA off, 3 iterations, against JAX's."""
    jr = JaxRenderer(jax_builtin.cornell_box(resolution=(16, 16)),
                     JaxOptions(antialiasing=False), seed=6)
    jr.step_many(3)
    tr = Renderer(_cornell(16), RenderOptions(antialiasing=False), seed=6, device="cpu")
    tr.step_many(3)
    assert tr.options.first_bounce_cache_active
    np.testing.assert_allclose(tr.raw_accumulator(), jr.raw_accumulator(), rtol=RTOL, atol=ATOL)
    # With AA off some pixel centres aim exactly at an edge of the box, where
    # two walls meet at the same t and a rounding picks the first hit's
    # wall: the normal AOV agrees on all but those (2 of 256 pixels here).
    off = (np.abs(tr.normal_image() - jr.normal_image()) > NORMAL_TOL).any(-1)
    assert off.mean() <= EDGE_TIE_SHARE, off.sum()


def test_cache_off_with_aa_or_dof():
    for opts in (RenderOptions(), RenderOptions(antialiasing=False, depth_of_field=True)):
        assert not opts.first_bounce_cache_active
        assert Renderer(_cornell(8), opts, device="cpu").cache is None


# ---- the dir AOV ----------------------------------------------------------------------

def test_dir_image_matches_jax():
    """Cornell 16x16, seed 5, 4 iterations: atol 1e-5."""
    jr = JaxRenderer(jax_builtin.cornell_box(resolution=(16, 16)), JaxOptions(dir_aov=True),
                     seed=5)
    jr.step_many(4)
    tr = Renderer(_cornell(16), RenderOptions(dir_aov=True), seed=5, device="cpu")
    tr.step_many(4)
    np.testing.assert_allclose(tr.dir_image(), jr.dir_image(), atol=DIR_ATOL)
    np.testing.assert_allclose(tr.raw_accumulator(), jr.raw_accumulator(), rtol=RTOL, atol=ATOL)
    assert np.abs(tr.dir_image()).sum() > 0


def test_dir_aov_bounded_with_coverage():
    """tests/test_dir_aov.py's first property: finite, in [-1, 1], norms
    <= 1 + 1e-5, and a direction on > 30% of the pixels at 16 spp."""
    r = Renderer(_cornell(24), RenderOptions(dir_aov=True), seed=3, device="cpu")
    r.step_many(16)
    img = r.dir_image()
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert img.min() >= -1.0 and img.max() <= 1.0
    assert (np.abs(img).sum(-1) > 1e-6).mean() > 0.3
    norms = np.linalg.norm(img, axis=-1)
    assert norms.max() <= 1.0 + 1e-5 and norms.max() > 0.1


def test_dir_aov_independent_of_batching():
    """The second: step_many(4) and four step() calls accumulate the same
    (bitwise here: the same ops in the same order)."""
    a = Renderer(_cornell(16), RenderOptions(dir_aov=True), seed=5, device="cpu")
    b = Renderer(_cornell(16), RenderOptions(dir_aov=True), seed=5, device="cpu")
    a.step_many(4)
    for _ in range(4):
        b.step()
    assert torch.equal(a.dir_acc, b.dir_acc)
    np.testing.assert_array_equal(a.dir_image(), b.dir_image())


def test_dir_aov_zero_on_emitter_alone():
    """The third: a lone emissive sphere never scatters a first bounce."""
    r = Renderer(builtin.emissive_sphere(resolution=(16, 16)), RenderOptions(dir_aov=True),
                 seed=1, device="cpu")
    r.step_many(2)
    assert np.abs(r.dir_image()).sum() == 0.0
    assert r.raw_accumulator().sum() > 0


def test_dir_aov_skips_the_megakernel(monkeypatch):
    monkeypatch.setattr(megakernel, "accumulate", _refuse)
    r = Renderer(_cornell(8), RenderOptions(dir_aov=True, megakernel=True), device="cpu")
    assert not r.use_megakernel
    r.render(iterations=2)
    out = pathtrace.render_sample(r.dev, r.meta, r.options, 1, r.base_key)
    assert out.dirmap is not None and out.dirlum is not None


# ---- the Renderer surface ------------------------------------------------------------

def test_renderer_surface_and_move_camera_match_jax():
    """raw_accumulator, normal_image and albedo against JAX's at 16x16 (AA
    on), then move_camera on both and the same again."""
    jr = JaxRenderer(jax_builtin.cornell_box(resolution=(16, 16)), JaxOptions(), seed=0)
    tr = Renderer(_cornell(16), RenderOptions(), seed=0, device="cpu")
    for step in range(2):
        jr.render(iterations=2)
        tr.render(iterations=2)
        assert tr.iteration == jr.iteration == 2
        np.testing.assert_allclose(tr.raw_accumulator(), jr.raw_accumulator(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tr.beauty(), jr.beauty(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tr.normal_image(), jr.normal_image(), atol=NORMAL_TOL)
        np.testing.assert_allclose(tr.albedo_image(), jr.albedo_image(), atol=NORMAL_TOL)
        if step == 0:
            lens = np.linalg.norm(tr.normal_image().reshape(-1, 3), axis=1)
            assert (lens > 0.5).mean() > 0.8  # most primary rays hit the box
            jr.move_camera(position=[0.0, 5.0, 12.0])
            tr.move_camera(position=[0.0, 5.0, 12.0])
            assert tr.iteration == 0 and float(tr.acc.abs().sum()) == 0.0
            np.testing.assert_array_equal(tr.dev.camera.position.numpy(), [0.0, 5.0, 12.0])


def test_move_camera_equals_fresh_renderer():
    """K1's route (its plain version here): render, move, render again
    equals a fresh Renderer built at the new camera, bitwise, record too."""
    r = Renderer(_cornell(16), RenderOptions(megakernel=True), seed=0, device="cpu")
    assert r.use_megakernel
    r.render(iterations=3)
    r.move_camera(position=[0.0, 5.0, 12.0], look_at=[0.0, 4.0, 0.0])
    r.render(iterations=3)
    scene = _cornell(16)
    scene.state.camera.position = np.asarray([0.0, 5.0, 12.0], np.float32)
    scene.state.camera.look_at = np.asarray([0.0, 4.0, 0.0], np.float32)
    scene.state.camera.rebuild()
    fresh = Renderer(scene, RenderOptions(megakernel=True), seed=0, device="cpu")
    fresh.render(iterations=3)
    assert torch.equal(r.record, fresh.record)
    assert torch.equal(r.acc, fresh.acc)


def test_render_progress_cancels_after_first_batch():
    """render(iterations, progress, batch): the JAX signature; a progress
    callback that returns False stops the render after its batch."""
    r = Renderer(_cornell(8), RenderOptions(), seed=0, device="cpu")
    seen = []
    img = r.render(8, lambda f: seen.append(f) or False, batch=2)
    assert r.iteration == 2 and seen == [0.25]
    assert img.shape == (8, 8, 3)
    assert r.timer.count == 1 and r.timer.last_ms > 0
    r.reset()
    seen.clear()
    r.render(8, lambda f: seen.append(f) or True, 4)
    assert r.iteration == 8 and seen == [0.5, 1.0]
    assert r.timer.count == 2 and r.timer.total_ms >= r.timer.last_ms


def test_performance_timer_surface():
    """start/end/last_ms/total_ms/count, timed() and timed_ms, as in the JAX
    module; end() waits for the tensors it is given (CPU ones need none)."""
    t = PerformanceTimer()
    with pytest.raises(RuntimeError, match="not started"):
        t.end()
    t.start()
    with pytest.raises(RuntimeError, match="already started"):
        t.start()
    ms = t.end(sync=(torch.ones(3), [torch.zeros(2)]))
    assert ms >= 0 and t.last_ms == ms and t.count == 1
    with t.timed() as out:
        out["sync"] = torch.ones(2)
    assert t.count == 2 and t.total_ms >= t.last_ms
    results = {}
    with timed_ms(results, "block"):
        sum(range(1000))
    assert results["block"] >= 0


# ---- small ops ------------------------------------------------------------------------

@pytest.mark.parametrize("seed,iteration,depth", [(0, 1, 0), (5, 3, 7), (123, 40, 2)])
def test_bounce_key_and_uniforms_bit_exact(seed, iteration, depth):
    jkey = jax_rng.bounce_key(jax_rng.iteration_key(jax.random.key(seed), iteration), depth)
    key = rng.bounce_key(rng.iteration_key(rng.make_key(seed), iteration), depth)
    assert tuple(int(w) for w in np.asarray(jax.random.key_data(jkey))) == key
    ju = jax_rng.bounce_uniforms(jax_rng.iteration_key(jax.random.key(seed), iteration), depth,
                                 300, 3)
    tu = rng.bounce_uniforms(rng.iteration_key(rng.make_key(seed), iteration), depth, 300, 3)
    assert tu.shape == (300, 3) and tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert port_ops.bounce_uniforms is rng.bounce_uniforms


def test_vec3_helpers_match_jax():
    a = np.random.default_rng(3).random((5, 3)).astype(np.float32)
    v = vec3.from_array(torch.from_numpy(a))
    jv = jax_vec3.from_array(jnp.asarray(a))
    for x, y in zip(v, jv):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(vec3.to_array(v).numpy(), np.asarray(jax_vec3.to_array(jv)))
    s = vec3.splat((0.1, 2.0, -3.5))
    js = jax_vec3.splat((0.1, 2.0, -3.5))
    for x, y in zip(s, js):
        assert x.dtype == torch.float32 and x.dim() == 0 and float(x) == float(y)
    assert vec3.splat((1, 2, 3), like=v.x).x.device == v.x.device


# ---- intersect_scene, the oracle --------------------------------------------------------

def _random_rays(seed, n, lo=(-4.0, 1.0, -4.0), hi=(4.0, 9.0, 10.0), target=None):
    rng_ = np.random.default_rng(seed)
    o = (rng_.random((n, 3)) * (np.asarray(hi) - lo) + lo).astype(np.float32)
    if target is None:
        d = rng_.normal(size=(n, 3))
    else:
        center, extent = target
        d = center + (rng_.random((n, 3)) - 0.5) * extent - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _ship_target(meta):
    (g,) = [g for g in meta.geoms if g.type == int(GeomType.OBJ)]
    lo, hi = np.asarray(g.aabb_min), np.asarray(g.aabb_max)
    return (lo + hi) / 2, hi - lo


INTERSECT_SCENES = {
    "cornell": (lambda: builtin.cornell_box(resolution=(8, 8)),
                lambda: jax_builtin.cornell_box(resolution=(8, 8))),
    "cornellShipTex": (lambda: load_scene(SHIP_TEX), lambda: jax_load_scene(SHIP_TEX)),
}


@pytest.mark.parametrize("name", list(INTERSECT_SCENES))
def test_intersect_scene_matches_jax(name):
    make, make_jax = INTERSECT_SCENES[name]
    dev, meta = build_device_scene(make(), device="cpu")
    jdev, _ = jax_build(make_jax())
    target = _ship_target(meta) if meta.has_obj else None
    o, d = _random_rays(11, 512, target=target)
    got = intersect_scene(dev, torch.from_numpy(o), torch.from_numpy(d), meta=meta)
    want = jax.jit(jax_intersect_scene)(jdev, jnp.asarray(o), jnp.asarray(d))
    hit = np.asarray(want.t) > 0
    np.testing.assert_array_equal(got.t.numpy() > 0, hit)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5)
    np.testing.assert_array_equal(got.geom_id.numpy(), np.asarray(want.geom_id))
    np.testing.assert_array_equal(got.material_id.numpy(), np.asarray(want.material_id))
    np.testing.assert_array_equal(got.outside.numpy(), np.asarray(want.outside))
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), atol=1e-5)
    # Both oracles normalize a zero bump texel into NaN on the same lanes.
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal), atol=NORMAL_TOL)
    if meta.has_obj:
        on_mesh = got.geom_id.numpy() == [i for i, g in enumerate(meta.geoms)
                                          if g.type == int(GeomType.OBJ)][0]
        assert on_mesh.sum() > 100  # the bump map and the uv have work to do


@pytest.mark.parametrize("name", list(INTERSECT_SCENES))
def test_intersect_soa_matches_port_oracle(name):
    """The fast path against the reference-shaped oracle, as
    tests/test_fastpath.py and tests/test_bump.py hold JAX's."""
    make, _ = INTERSECT_SCENES[name]
    dev, meta = build_device_scene(make(), device="cpu")
    target = _ship_target(meta) if meta.has_obj else None
    o, d = _random_rays(42, 512, target=target)
    ref = intersect_scene(dev, torch.from_numpy(o), torch.from_numpy(d), meta=meta)
    fast = intersect_soa(meta, dev, vec3.from_array(torch.from_numpy(o)),
                         vec3.from_array(torch.from_numpy(d)))
    ref_hit = ref.t.numpy() > 0
    np.testing.assert_array_equal(ref_hit, fast.hit.numpy())
    np.testing.assert_allclose(fast.t.numpy()[ref_hit], ref.t.numpy()[ref_hit], rtol=2e-4,
                               atol=2e-4)
    # The oracle normalizes a zero bump texel into NaN (as JAX's does); the
    # fast path's normalize clamps. Those lanes are left out, and counted.
    finite = ref_hit & np.isfinite(ref.normal.numpy()).all(1)
    assert np.isfinite(vec3.to_array(fast.normal).numpy()[ref_hit]).all()
    fn = vec3.to_array(fast.normal).numpy()[finite]
    agree = (np.abs(ref.normal.numpy()[finite] - fn) < (2e-3 if meta.has_obj else 1e-3)).all(1)
    assert agree.mean() > 0.999, agree.mean()
    assert (ref.material_id.numpy()[ref_hit] == fast.material_id.numpy()[ref_hit]).mean() > 0.999
    if meta.has_textures:
        mesh = fast.is_obj.numpy()
        np.testing.assert_allclose(fast.u.numpy()[mesh], ref.uv.numpy()[mesh, 0], atol=1e-5)
        np.testing.assert_allclose(fast.v.numpy()[mesh], ref.uv.numpy()[mesh, 1], atol=1e-5)


def test_intersect_scene_needs_meta_for_bump_maps():
    dev, meta = build_device_scene(load_scene(SHIP_TEX), device="cpu")
    o, d = _random_rays(0, 4)
    with pytest.raises(ValueError, match="SceneMeta"):
        intersect_scene(dev, torch.from_numpy(o), torch.from_numpy(d))


# ---- the apps ---------------------------------------------------------------------------

def _app(tmp_path, *extra):
    out = tmp_path / ("sorted" if "--sort-by-material" in extra else "plain")
    rc = raytrace.main(["cornell", "--resolution", "16", "16", "--iterations", "2",
                        "--device", "cpu", "--quiet", "--no-denoise", "--no-antialias",
                        "--out-dir", str(out), *extra])
    assert rc == 0
    return out, sorted(p.name for p in out.iterdir())


def test_raytrace_app_new_flags(tmp_path):
    """--save-normal and --preview-every write their PNGs; the sorted run's
    beauty equals the unsorted one's."""
    out, names = _app(tmp_path, "--sort-by-material", "--sort-impl", "perm", "--save-normal",
                      "--preview-every", "1", "--depth-of-field", "--batch", "1")
    assert "cornell.preview.png" in names
    (normal,) = [n for n in names if n.endswith("normal.png")]
    assert read_png(str(out / normal)).shape == (16, 16, 3)
    assert len(names) == 5  # samp, albedo, input, normal, preview
    plain, plain_names = _app(tmp_path, "--depth-of-field", "--batch", "1")
    (a,) = [n for n in names if n.endswith("samp.png")]
    (b,) = [n for n in plain_names if n.endswith("samp.png")]
    np.testing.assert_array_equal(read_png(str(out / a)), read_png(str(plain / b)))
    args = raytrace.parse_args(["cornell"])
    assert (args.no_antialias, args.depth_of_field, args.preview_every, args.save_normal,
            args.sort_by_material, args.sort_impl) == (False, False, 0, False, False, "fused")


def test_raytrace_app_warns_sort_with_megakernel_on(tmp_path, capsys):
    _app(tmp_path, "--sort-by-material", "--megakernel", "on")
    assert "--sort-by-material has no effect" in capsys.readouterr().err


def test_benchmark_render_json(monkeypatch, capsys, tmp_path):
    """main --mode render --json --device cpu on a matrix made small: four
    entries (cornellObj has no builtin and is skipped)."""
    monkeypatch.setattr(benchmark, "RENDER_CONFIGS",
                        [(n, s, 2, o) for n, s, _, o in benchmark.RENDER_CONFIGS])
    monkeypatch.setattr(benchmark, "MAX_BATCHES", 2)
    for name, make in list(builtin.BUILTIN_SCENES.items()):
        monkeypatch.setitem(builtin.BUILTIN_SCENES, name,
                            lambda make=make: make(resolution=(8, 8)))
    assert benchmark.main(["--mode", "render", "--json", "--device", "cpu",
                           "--scene-dir", str(tmp_path)]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["bench"] for r in results] == ["cornell_16spp", "cornellGlass_16spp",
                                            "sphere_16spp", "cornell_dof_cache_sort"]
    assert all(r["iters_per_sec"] > 0 and r["msamples_per_sec"] >= 0 for r in results)


def test_benchmark_denoise_json(monkeypatch, capsys):
    monkeypatch.setattr(benchmark, "DENOISE_MATRIX",
                        [("RT.hdr_alb_nrm", "RT", dict(hdr=True), (32, 24)),
                         ("RTLightmap.hdr", "RTLightmap", dict(), (16, 16))])
    assert benchmark.main(["--mode", "denoise", "--json", "--runs", "1", "--device", "cpu"]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["bench"] for r in results] == ["RT.hdr_alb_nrm.32x24", "RTLightmap.hdr.16x16"]
    assert all(r["msec_per_image"] > 0 for r in results)
