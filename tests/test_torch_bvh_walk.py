"""K5's plain walk helpers, its routing and the whole slice against JAX.

- ``bvh_scene_hit_nearfar`` (the plain form of K5's near-to-far cluster
  walk) against the JAX function run as an interpreted Pallas kernel on one
  8 x 128 tile of the open-sky shipOnly with every 7th lane dead (the model
  is tests/test_fastpath.py's open-sky test): hit masks equal, t within
  rtol 1e-5, normals within 1e-5, dead lanes report misses. The JAX walk
  streams ``face_shift``, the port ``face_plane``; both hold the same float
  quantities, and XLA may order a face test's operations otherwise, so t
  agrees to rounding, not bit for bit.
- ``bvh_scene_hit`` against the JAX brute-force oracle ``intersect_soa``
  (chunked Moller-Trumbore) on cornellShip: the plane form and
  Moller-Trumbore round differently, so t within rtol 2e-4 and normals
  within 1e-3, over every lane; the hit masks and materials equal.
- ``_uses_bvh`` and ``supports_megakernel`` equal JAX's under the four
  megakernel/bounce_megakernel combinations.
- The slice on the CPU: the port's Renderer with bounce_megakernel and
  rng="auto" (K5's plain version, threefry on the CPU) against the JAX
  Renderer's wavefront, at JAX's own bar of rtol 1e-5 / atol 1e-6 on the
  image and the albedo. The normal AOV within 1e-5: a mesh hit's normal is
  the normalized plane-form face normal (float64 precompute, rounded) here
  and the normalized float32 cross(e1, e2) of the JAX wavefront's
  Moller-Trumbore stream there.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mygpuraytracer_tpu.config import RenderOptions as JaxOptions
from mygpuraytracer_tpu.ops.trace import bvh_scene_hit_nearfar as jax_nearfar
from mygpuraytracer_tpu.ops.trace import intersect_soa as jax_intersect_soa
from mygpuraytracer_tpu.ops.vec3 import Vec3 as JVec3
from mygpuraytracer_tpu.render.megakernel import _uses_bvh as jax_uses_bvh
from mygpuraytracer_tpu.render.megakernel import supports_megakernel as jax_supports
from mygpuraytracer_tpu.render.renderer import Renderer as JaxRenderer
from mygpuraytracer_tpu.scene import builtin as jax_builtin
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import Renderer, megakernel
from mygpuraytracer_tpu_torch.scene import builtin, load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _both(name, res=8):
    if name == "cornell":
        js, ts = jax_builtin.cornell_box(), builtin.cornell_box()
    else:
        js, ts = (load(str(REPO / f"scenes/{name}.txt")) for load in (jax_load_scene, load_scene))
    for s in (js, ts):
        s.set_resolution(res, res)
    return js, ts


def _rays(seed, n):
    """Half the rays aimed at the ship, half random (mostly open-sky misses
    in shipOnly), as tests/test_fastpath.py makes them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 9, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = np.array([1.0, 3.0, 3.0]) - o[: n // 2] + 0.3 * rng.normal(size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _tvec(a):
    return Vec3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))


def test_nearfar_walk_matches_jax_interpreted_open_sky():
    js, ts = _both("shipOnly")
    jdev, jmeta = jax_build(js, 128)
    tdev, tmeta = build_device_scene(ts, 128, device="cpu")
    n = 8 * 128
    o_np, d_np = _rays(7, n)
    act_np = np.ones(n, bool)
    act_np[::7] = False  # dead lanes scattered through every row

    def kernel(fs_ref, ox, oy, oz, dx, dy, dz, act, t_ref, hit_ref, nx, ny, nz):
        h = jax_nearfar(jmeta, fs_ref, JVec3(ox[:, :], oy[:, :], oz[:, :]),
                        JVec3(dx[:, :], dy[:, :], dz[:, :]), act[:, :] > 0)
        t_ref[:, :] = h.t
        hit_ref[:, :] = h.hit.astype(jnp.float32)
        nx[:, :] = h.normal.x
        ny[:, :] = h.normal.y
        nz[:, :] = h.normal.z

    shape = (8, 128)
    args = [jdev.face_shift] + [jnp.asarray(a.reshape(shape)) for a in (
        o_np[:, 0], o_np[:, 1], o_np[:, 2], d_np[:, 0], d_np[:, 1], d_np[:, 2],
        act_np.astype(np.float32))]
    outs = pl.pallas_call(
        kernel, out_shape=[jax.ShapeDtypeStruct(shape, jnp.float32)] * 5,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 8,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5, interpret=True)(*args)
    t_j, hit_j, nx_j, ny_j, nz_j = (np.asarray(a).ravel() for a in outs)

    active = torch.from_numpy(act_np)
    h = trace.bvh_scene_hit_nearfar(tmeta, tdev.face_plane, _tvec(o_np), _tvec(d_np), active,
                                    tdev.cluster_bounds)
    hit_t = h.hit.numpy()
    np.testing.assert_array_equal(hit_t, hit_j > 0)
    assert not hit_t[~act_np].any() and np.isinf(h.t.numpy()[~act_np]).all()
    np.testing.assert_allclose(h.t.numpy()[hit_t], t_j[hit_t], rtol=1e-5)
    mesh = hit_t & h.is_obj.numpy()
    assert mesh.sum() > n // 8  # plenty of real mesh hits compared
    for a, b in zip(h.normal, (nx_j, ny_j, nz_j)):
        np.testing.assert_allclose(a.numpy()[hit_t], b[hit_t], atol=1e-5)


def test_bvh_scene_hit_matches_jax_oracle():
    js, ts = _both("cornellShip")
    jdev, jmeta = jax_build(js, 128)
    tdev, tmeta = build_device_scene(ts, 128, device="cpu")
    o_np, d_np = _rays(0, 2048)
    ref = jax_intersect_soa(jmeta, jdev, JVec3(*(jnp.asarray(o_np[:, i]) for i in range(3))),
                            JVec3(*(jnp.asarray(d_np[:, i]) for i in range(3))), 128)
    h = trace.bvh_scene_hit(tmeta, tdev.face_plane, _tvec(o_np), _tvec(d_np))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(h.hit.numpy(), hit)
    np.testing.assert_allclose(h.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=2e-4)
    np.testing.assert_array_equal(h.is_obj.numpy(), np.asarray(ref.is_obj))
    assert h.is_obj.numpy().sum() > 2048 // 4
    np.testing.assert_array_equal(h.material_id.numpy(), np.asarray(ref.material_id))
    for a, b in zip(h.normal, (ref.normal.x, ref.normal.y, ref.normal.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


ROUTING = [(m, b) for m in (False, True) for b in (False, True)]


@pytest.mark.parametrize("name", ["cornell", "cornellShip", "shipOnly", "cornellShipTex"])
def test_routing_matches_jax(name):
    js, ts = _both(name)
    _, jmeta = jax_build(js, 128)
    _, tmeta = build_device_scene(ts, 128, device="cpu")
    assert megakernel._uses_bvh(tmeta) == jax_uses_bvh(jmeta)
    for mega, bounce in ROUTING:
        opts = dict(megakernel=mega, bounce_megakernel=bounce)
        assert megakernel.supports_megakernel(tmeta, RenderOptions(**opts)) == bool(
            jax_supports(jmeta, JaxOptions(**opts))), (name, opts)


@pytest.mark.parametrize("name", ["cornellShip", "shipOnly"])
def test_bounce_slice_matches_jax_renderer_on_cpu(name):
    js, ts = _both(name, res=16)
    for s in (js, ts):
        s.state.trace_depth = 3
    jr = JaxRenderer(js, JaxOptions(megakernel=False), seed=0)
    jr.step_many(2)
    r = Renderer(ts, RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto"),
                 seed=0, device="cpu")
    assert r.use_megakernel and megakernel._uses_bvh(r.meta)
    before = megakernel.BOUNCE_LAUNCHES
    r.step_many(2)
    assert megakernel.BOUNCE_LAUNCHES == before  # the CPU runs the plain version
    np.testing.assert_allclose(r.beauty(), jr.beauty(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r.albedo_image(), jr.albedo_image(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r._to_hw3(r.acc[6:9]), jr.normal_image(), atol=1e-5)
    assert r.beauty().mean() > 1e-3
