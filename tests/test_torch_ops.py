"""ops/vec3.py, ops/sampling.py and the primitive tests against the JAX package.

Same numpy-seeded inputs on both sides, JAX run op by op. Tolerance: 2e-6
for vector and sampling chains, 1e-5 relative for the hit distances (a few
ulps: eager JAX rounds some of these chains differently from torch, while
the jitted wavefront in test_torch_render.py matches bit for bit); the set
of rays that hit must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mygpuraytracer_tpu.ops import sampling as jax_sampling
from mygpuraytracer_tpu.ops import trace as jax_trace
from mygpuraytracer_tpu.ops import vec3 as jax_v3
from mygpuraytracer_tpu.scene import builtin as jax_builtin
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.ops import sampling, trace
from mygpuraytracer_tpu_torch.ops import vec3 as v3
from mygpuraytracer_tpu_torch.scene import builtin
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

N = 2048
TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _vecs(seed, n=N):
    g = np.random.default_rng(seed)
    return g.normal(size=(n, 3)).astype(np.float32), g.random((n, 2), np.float32)


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("op", ["dot", "cross", "normalize", "reflect", "length"])
def test_vec3_matches_jax(op):
    a, _ = _vecs(0)
    b, _ = _vecs(1)
    ta, tb = v3.Vec3(*_t(a.T)), v3.Vec3(*_t(b.T))
    ja, jb = jax_v3.Vec3(*jnp.asarray(a.T)), jax_v3.Vec3(*jnp.asarray(b.T))
    fn, jfn = getattr(v3, op), getattr(jax_v3, op)
    args = (ta, tb) if op in ("dot", "cross", "reflect") else (ta,)
    jargs = (ja, jb) if op in ("dot", "cross", "reflect") else (ja,)
    got, want = fn(*args), jfn(*jargs)
    got = np.stack([c.numpy() for c in got]) if isinstance(got, tuple) else got.numpy()
    want = np.stack([np.asarray(c) for c in want]) if isinstance(want, tuple) else np.asarray(want)
    np.testing.assert_allclose(got, want, **TOL)


def test_cosine_hemisphere_matches_jax():
    n, u = _vecs(2)
    n = _unit(n)
    got = sampling.cosine_sample_hemisphere(_t(n), _t(u[:, 0]), _t(u[:, 1])).numpy()
    want = np.asarray(jax_sampling.cosine_sample_hemisphere(
        jnp.asarray(n), jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1])))
    np.testing.assert_allclose(got, want, **TOL)
    assert (np.einsum("ij,ij->i", got, n) >= -1e-6).all()


def test_jittered_hemisphere_matches_jax():
    n, u = _vecs(3)
    n = _unit(n)
    got = sampling.jittered_sample_hemisphere(_t(n), _t(u[:, 0]), _t(u[:, 1]), 7, 64).numpy()
    want = np.asarray(jax_sampling.jittered_sample_hemisphere(
        jnp.asarray(n), jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]), jnp.int32(7), 64))
    np.testing.assert_allclose(got, want, **TOL)


def test_concentric_disk_matches_jax():
    _, u = _vecs(4)
    u[:3] = [[0.5, 0.5], [0.5, 0.9], [0.1, 0.5]]  # origin and the axes
    got = sampling.concentric_sample_disk(_t(u)).numpy()
    want = np.asarray(jax_sampling.concentric_sample_disk(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, **TOL)


def test_reflect_refract_schlick_match_jax():
    i, u = _vecs(5)
    nrm, _ = _vecs(6)
    i, nrm = _unit(i), _unit(nrm)
    eta = (0.6 + u[:, 0]).astype(np.float32)
    np.testing.assert_allclose(sampling.reflect(_t(i), _t(nrm)).numpy(),
                               np.asarray(jax_sampling.reflect(jnp.asarray(i), jnp.asarray(nrm))), **TOL)
    np.testing.assert_allclose(
        sampling.refract(_t(i), _t(nrm), _t(eta)).numpy(),
        np.asarray(jax_sampling.refract(jnp.asarray(i), jnp.asarray(nrm), jnp.asarray(eta))), **TOL)
    c = u[:, 1]
    np.testing.assert_allclose(
        sampling.schlick_reflect_coeff(_t(c), 1.0, 1.5).numpy(),
        np.asarray(jax_sampling.schlick_reflect_coeff(jnp.asarray(c), 1.0, 1.5)), **TOL)


@pytest.mark.parametrize("kind", ["box", "sphere"])
def test_primitive_hits_match_jax(kind):
    """Rays from inside and outside the Cornell box against each geom."""
    _, jmeta = jax_build(jax_builtin.cornell_glass(resolution=(8, 8)))
    _, tmeta = build_device_scene(builtin.cornell_glass(resolution=(8, 8)), device="cpu")
    g = np.random.default_rng(7)
    o = (g.random((N, 3)) * [12, 12, 14] - [6, 1, 6]).astype(np.float32)
    d = _unit(g.normal(size=(N, 3)))
    to, td = v3.Vec3(*_t(o.T)), v3.Vec3(*_t(d.T))
    jo, jd = jax_v3.Vec3(*jnp.asarray(o.T)), jax_v3.Vec3(*jnp.asarray(d.T))
    want_type = 1 if kind == "box" else 0
    fn = trace.box_intersect_soa if kind == "box" else trace.sphere_intersect_soa
    jfn = jax_trace.box_intersect_soa if kind == "box" else jax_trace.sphere_intersect_soa
    hits = 0
    for jg, tg in zip(jmeta.geoms, tmeta.geoms):
        if tg.type != want_type:
            continue
        (tt, tn), (jt, jn) = fn(tg, to, td), jfn(jg, jo, jd)
        finite = np.isfinite(np.asarray(jt))
        np.testing.assert_array_equal(np.isfinite(tt.numpy()), finite)
        np.testing.assert_allclose(tt.numpy()[finite], np.asarray(jt)[finite], rtol=1e-5)
        hits += int(finite.sum())
        for a, b in zip(tn, jn):
            np.testing.assert_allclose(a.numpy()[finite], np.asarray(b)[finite], rtol=1e-5, atol=1e-5)
    assert hits > 0
