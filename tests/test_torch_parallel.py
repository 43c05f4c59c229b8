"""The port's multi-device rendering (``parallel/``) against the JAX
package, on the CPU (the Filter's mesh: ``test_torch_parallel_filter.py``).

Mirrors ``tests/test_parallel.py``. The port's mesh is one process driving
``("cpu",) * 8`` (the JAX tests' 8 virtual CPU devices). The JAX
multi-device render tests are in the slow tier, so the port's sample and
pixel modes are held against JAX's sequential ``Renderer`` at the same size
and seed (JAX's own tests hold the two equal), and the pixel mode also
against JAX's ``sharded_render_step`` on its 8 devices at 32x16.

Tolerances: the render modes against JAX rtol 1e-4 and atol 1e-4 (JAX's
tests' bar); the pixel mode against the port's sequential render bit for
bit (each pixel computes what it computes in a whole-image render, K1's and
K5's plain versions and the wavefront alike); a column slice of the
threefry block bit for bit against ``jax.random.uniform``'s; the Filter's
mesh bit for bit against the port's single device, and within the Filter
tests' bar (atol 1e-5, rtol 1e-4) of JAX's mesh Filter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mygpuraytracer_tpu.config import RenderOptions as JaxRenderOptions
from mygpuraytracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mygpuraytracer_tpu.parallel.sharded import sharded_render_step as jax_sharded_render_step
from mygpuraytracer_tpu.render import Renderer as JaxRenderer
from mygpuraytracer_tpu.scene.builtin import cornell_box as jax_cornell_box
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build_device_scene

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prng, rng
from mygpuraytracer_tpu_torch.parallel import (Mesh, make_mesh, make_mesh_2d,
                                               render_multichip_sample, sharded_render_step)
from mygpuraytracer_tpu_torch.parallel.mesh import psum, replicate
from mygpuraytracer_tpu_torch.render import Renderer, megakernel
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box, cornell_glass
from test_torch_k5_host import REPO

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=("cpu",) * 8)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(8)


def _rows(vec3):
    return np.stack([np.asarray(c) for c in vec3])


@pytest.mark.parametrize("p0,count", [(0, 7), (1000, 24), (4093, 3), (2048, 2048)])
def test_column_slice_of_the_threefry_block_matches_jax(p0, count):
    """Element (r, c) of the [k, N] block is flat element r*N + c of the
    draw, so a column slice equals those columns of jax.random.uniform's
    block bit for bit (and K6's stream keys per column already)."""
    k, n = 28, 4096
    key = rng.iteration_key(rng.make_key(5), 3)
    want = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.key(5), 3), (k, n)))[:, p0:p0 + count]
    got = rng.uniform_columns(key, k, n, p0, count)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(prng.uniforms_reference(77, k, count, col0=p0),
                       prng.uniforms_reference(77, k, n)[:, p0:p0 + count])
    with pytest.raises(ValueError):
        rng.uniform_columns(key, k, n, n - 2, count + 2)


@pytest.mark.parametrize("mega", [False, True])
def test_sample_mode_matches_jax_sequential(mega, mesh):
    """8 devices x 1 sample == JAX's 8 sequential samples (same RNG
    streams); ``mega``: the megakernel route (K1's plain version on the CPU)."""
    kw = dict(resolution=(32, 32), iterations=8, depth=4)
    r = Renderer(cornell_box(**kw), RenderOptions(megakernel=mega), seed=5, device="cpu")
    img, alb, nrm = render_multichip_sample(r.dev, r.meta, r.options, r.base_key, 8, mesh)
    jr = JaxRenderer(jax_cornell_box(**kw), JaxRenderOptions(), seed=5)
    jr.render(iterations=8)
    np.testing.assert_allclose(torch.stack(img).numpy(), _rows(jr.image), **TOL)
    np.testing.assert_allclose(torch.stack(alb).numpy(), _rows(jr.albedo), **TOL)
    np.testing.assert_allclose(torch.stack(nrm).numpy(), _rows(jr.normal), **TOL)


@pytest.mark.parametrize("mega", [False, True])
def test_pixel_mode_matches_jax_sequential(mega, mesh):
    kw = dict(resolution=(32, 16), iterations=2, depth=4)
    r = Renderer(cornell_box(**kw), RenderOptions(megakernel=mega), seed=3, device="cpu")
    step_fn, make_state = sharded_render_step(r.meta, r.options, mesh)
    image, albedo, cache = make_state()
    assert all(p.shape == (3, 64) for p in image.parts)  # N / 8 lanes a device
    devs = replicate(r.dev, mesh)
    for it in (1, 2):
        image, albedo, cache = step_fn(devs, image, albedo, cache, it, r.base_key)
    jr = JaxRenderer(jax_cornell_box(**kw), JaxRenderOptions(), seed=3)
    jr.render(iterations=2)
    np.testing.assert_allclose(image.gather().numpy(), _rows(jr.image), **TOL)
    np.testing.assert_allclose(albedo.gather().numpy(), _rows(jr.albedo), **TOL)


@pytest.mark.parametrize("mega", [False, True])
def test_pixel_mode_after_move_camera_equals_fresh(mega, mesh, monkeypatch):
    """The pixel-sharded step, given a Renderer's scene again after
    ``move_camera`` (which writes the camera in place), renders at the new
    camera: bitwise against a fresh Renderer's scene at that camera, and
    K1's launches take the records of the new camera (the CPU's plain K1
    reads the camera itself, the kernel reads the record)."""
    kw = dict(resolution=(16, 16), iterations=1, depth=3)
    position = [0.5, 4.0, 9.0]
    records = []
    accumulate = megakernel.accumulate
    monkeypatch.setattr(megakernel, "accumulate", lambda *a, record=None, **k: (
        records.append(record), accumulate(*a, record=record, **k))[1])

    def render(r, step_fn=None):
        step, make_state = sharded_render_step(r.meta, r.options, mesh)
        image, albedo, cache = make_state()
        records.clear()
        return (step_fn or step)(r.dev, image, albedo, cache, 1, r.base_key)[0].gather(), step

    r = Renderer(cornell_box(**kw), RenderOptions(megakernel=mega), seed=3, device="cpu")
    before, step_fn = render(r)
    r.move_camera(position=position)
    moved, _ = render(r, step_fn)
    moved_records = list(records)
    scene = cornell_box(**kw)
    scene.state.camera.position = np.asarray(position, np.float32)
    scene.state.camera.rebuild()
    fresh = Renderer(scene, RenderOptions(megakernel=mega), seed=3, device="cpu")
    want, _ = render(fresh)
    assert torch.equal(moved, want) and not torch.equal(moved, before)
    if mega:
        assert len(moved_records) == mesh.size
        assert all(torch.equal(rec, megakernel.scene_record(fresh.meta, fresh.dev.camera))
                   for rec in moved_records)


def test_pixel_mode_matches_jax_sharded_step(mesh, jax_mesh):
    """Against JAX's ``sharded_render_step`` on its 8 virtual devices."""
    kw = dict(resolution=(32, 16), iterations=2, depth=4)
    jopts = JaxRenderOptions()
    jdev, jmeta = jax_build_device_scene(jax_cornell_box(**kw), jopts.face_chunk)
    jstep, jmake = jax_sharded_render_step(jmeta, jopts, jax_mesh)
    jimage, jalbedo, jcache = jmake()
    jdev_r = jax.device_put(jdev, NamedSharding(jax_mesh, P()))
    for it in (1, 2):
        jimage, jalbedo, jcache = jstep(jdev_r, jimage, jalbedo, jcache, jnp.int32(it),
                                        jax.random.key(3))
    r = Renderer(cornell_box(**kw), RenderOptions(), seed=3, device="cpu")
    step_fn, make_state = sharded_render_step(r.meta, r.options, mesh)
    image, albedo, cache = make_state()
    for it in (1, 2):
        image, albedo, cache = step_fn(r.dev, image, albedo, cache, it, r.base_key)
    np.testing.assert_allclose(image.gather().numpy(), _rows(jimage), **TOL)
    np.testing.assert_allclose(albedo.gather().numpy(), _rows(jalbedo), **TOL)


def _mesh_scene(name, res):
    s = load_scene(str(REPO / f"scenes/{name}.txt"))
    s.set_resolution(res, res)
    s.state.trace_depth = 4
    return s


# name: (scene, options, iterations); 16x16 over 8 devices: 32 lanes each
PIXEL_CASES = {
    "k1_plain": (lambda: cornell_glass(resolution=(16, 16), depth=4),
                 dict(megakernel=True), 3),
    "wavefront_dof": (lambda: cornell_box(resolution=(16, 16), depth=4),
                      dict(depth_of_field=True), 2),
    "wavefront_cache_sort": (lambda: cornell_box(resolution=(16, 16), depth=4),
                             dict(antialiasing=False, sort_by_material=True), 3),
    "k5_plain": (lambda: _mesh_scene("cornellShip", 16),
                 dict(megakernel=True, bounce_megakernel=True, rng="auto"), 2),
    "textured_wavefront": (lambda: _mesh_scene("shipTexOnly", 16), {}, 1),
}


@pytest.mark.parametrize("case", list(PIXEL_CASES))
def test_pixel_mode_equals_the_port_sequential_render(case, mesh):
    """Each device's lanes compute what the same pixels do in a whole-image
    render: the gathered accumulator equals a sequential render of one
    iteration per step, bit for bit."""
    make, opts, iters = PIXEL_CASES[case]
    r = Renderer(make(), RenderOptions(**opts), seed=2, device="cpu")
    step_fn, make_state = sharded_render_step(r.meta, r.options, mesh)
    image, albedo, cache = make_state()
    devs = replicate(r.dev, mesh)
    for it in range(1, iters + 1):
        image, albedo, cache = step_fn(devs, image, albedo, cache, it, r.base_key)
        r.step()
    assert torch.equal(torch.cat(image.base, dim=1), r.acc)
    assert torch.equal(albedo.gather(), r.acc[3:6])


@pytest.mark.parametrize("as_copies", [False, True])
def test_pixel_mode_copies_the_scene_once_per_scene(as_copies, mesh, monkeypatch):
    """A step given the same scene again (a DeviceScene, as JAX's signature
    has it, or its replicate() copies) reuses its per-device copies and
    K1's records; another scene makes them anew."""
    from mygpuraytracer_tpu_torch.parallel import sharded
    from mygpuraytracer_tpu_torch.render import megakernel

    calls = {"replicate": 0, "record": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    r = Renderer(cornell_box(resolution=(16, 16), depth=2), RenderOptions(megakernel=True),
                 seed=1, device="cpu")
    monkeypatch.setattr(sharded, "replicate", counted("replicate", sharded.replicate))
    monkeypatch.setattr(megakernel, "scene_record", counted("record", megakernel.scene_record))
    step_fn, make_state = sharded_render_step(r.meta, r.options, mesh)
    state = make_state()
    scene = replicate(r.dev, mesh) if as_copies else r.dev
    for it in (1, 2, 3):
        state = step_fn(scene, *state, it, r.base_key)
    assert calls == {"replicate": 0 if as_copies else 1, "record": mesh.size}
    other = replicate(r.dev, mesh) if as_copies else r.dev._replace()
    step_fn(other, *state, 4, r.base_key)
    assert calls == {"replicate": 0 if as_copies else 2, "record": 2 * mesh.size}


def test_sample_mode_with_the_cache_fills_it_per_device(mesh):
    """AA off: each device fills its first-bounce cache at its own first
    iteration, so the sum matches the sequential render."""
    r = Renderer(cornell_box(resolution=(16, 16), depth=4),
                 RenderOptions(antialiasing=False), seed=4, device="cpu")
    assert r.options.first_bounce_cache_active
    img, _, _ = render_multichip_sample(r.dev, r.meta, r.options, r.base_key, 8, mesh)
    r.render(8)
    np.testing.assert_allclose(torch.stack(img).numpy(), r.acc[0:3].numpy(), **TOL)


def test_uneven_splits_raise(mesh):
    r = Renderer(cornell_box(resolution=(16, 16), depth=2), seed=0, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        render_multichip_sample(r.dev, r.meta, r.options, r.base_key, 9, mesh)
    r = Renderer(cornell_box(resolution=(15, 15), depth=2), seed=0, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        sharded_render_step(r.meta, r.options, mesh)


def test_mesh_construction():
    m = make_mesh(devices=("cpu",) * 4, axis="x")
    assert (m.size, m.axis_names, m.shape, m.first) == (4, ("x",), (4,), torch.device("cpu"))
    assert make_mesh(2, devices=("cpu",) * 4).size == 2
    m2 = make_mesh_2d((2, 2), devices=("cpu",) * 4)
    assert (m2.shape, m2.axis_names) == ((2, 2), ("dp", "sp"))
    with pytest.raises(ValueError):
        Mesh((torch.device("cpu"),) * 3, ("dp", "sp"), (2, 2))
    with pytest.raises(ValueError):
        make_mesh(devices=("meta",))
    if not torch.cuda.is_available():  # no fallback: CUDA asked for without a card raises
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(devices=("cuda:0", "cuda:0"))


def test_psum_adds_in_device_order():
    m = make_mesh(devices=("cpu",) * 3)
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    assert float(psum(parts, m)) == float((parts[0] + parts[1]) + parts[2])
    with pytest.raises(ValueError):
        psum(parts[:2], m)
