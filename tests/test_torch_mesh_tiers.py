"""The port's one mesh query against each of the JAX package's mesh tiers
K2/K3/K4, on the CPU.

The same rays, made with numpy from a seed, go through JAX's
``intersect_soa(..., mesh_pallas=True, mesh_tier=t)``, whose Pallas kernel
runs in interpret mode on the CPU, and through the port's
``intersect_soa(..., mesh_pallas=True)``, whose cluster query runs the plain
version of the mesh CUDA kernel (ops/mesh_hit.py) on CPU tensors.
Scene: cornellShip (23,328 faces in 183 clusters inside the Cornell walls,
so t_cap pruning against the walls is exercised); 1,101 rays, one (8, 128)
tile and a ragged tail, half of them aimed at the ship (tests/test_fastpath.py).

Tolerances, the tightest that hold (JAX's own tests allow t within 2e-3 on
> 99.5% of lanes and normals within 1e-2 on > 99%):
- hit, is_obj, material_id, u and v equal on every lane;
- t within 1e-5 relative and the normal within 1e-5 on every lane. Both
  sides compute the same plane-form arithmetic in the same order, but XLA
  fuses and may contract the jitted JAX side differently from PyTorch's one
  rounding per op: measured up to 20 ulps (1.3e-6 relative) of t.
The port-only cases (dead lanes, mesh_sort, bounding_box) are exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.ops import trace as jax_trace
from mygpuraytracer_tpu.ops.vec3 import Vec3 as JaxVec3
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

SCENE = "scenes/cornellShip.txt"
N_RAYS = 8 * 128 + 77
T_RTOL = 1e-5
NORMAL_ATOL = 1e-5
FIELDS = ("t", "hit", "is_obj", "material_id", "u", "v", "kd", "ks", "ke", "bump")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _scenes():
    js, ts = jax_load_scene(SCENE), load_scene(SCENE)
    js.set_resolution(8, 8)
    ts.set_resolution(8, 8)
    return jax_build(js, 128), build_device_scene(ts, 128, device="cpu")


def ship_rays(n=N_RAYS, seed=1):
    """Origins over the room, half the directions aimed at the ship."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 9, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = np.array([1.0, 3.0, 3.0]) - o[: n // 2]
    d[: n // 2] = aim + 0.3 * rng.normal(size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _torch3(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jax3(a):
    return JaxVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def assert_hits_match_jax(jh, th, mask_extra=None):
    """The module's bars: exact on the discrete fields and texcoords, t and
    the normal within 1e-5."""
    for name in ("hit", "is_obj", "material_id", "u", "v", "kd", "ks", "ke", "bump"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, name)), getattr(th, name).numpy(),
                                      err_msg=name)
    hit = np.asarray(jh.hit)
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=T_RTOL, atol=0)
    for a, b in zip(jh.normal, th.normal):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("tier", ["rows", "lists", "conds"])
def test_tier_matches_jax_tier(tier):
    (jdev, jmeta), (dev, meta) = _scenes()
    o, d = ship_rays()
    jfn = jax.jit(lambda dv, o_, d_: jax_trace.intersect_soa(
        jmeta, dv, o_, d_, 128, mesh_pallas=True, mesh_tier=tier))
    jh = jfn(jdev, _jax3(o), _jax3(d))
    th = trace.intersect_soa(meta, dev, _torch3(o), _torch3(d), 128, mesh_pallas=True)
    assert int(th.is_obj.sum()) > N_RAYS // 5  # plenty of mesh winners compared
    assert_hits_match_jax(jh, th)


def test_plane_tiers_close_to_moller_trumbore():
    """Plane form against the chunked Moller-Trumbore oracle: JAX's bars
    (tests/test_fastpath.py), t within 2e-3 on > 99.5% of lanes; measured
    on every lane here."""
    _, (dev, meta) = _scenes()
    o, d = _torch3(ship_rays()[0]), _torch3(ship_rays()[1])
    fast = trace.intersect_soa(meta, dev, o, d, mesh_pallas=True)
    ref = trace.intersect_soa(meta, dev, o, d, mesh_pallas=False)
    t_f = torch.where(fast.hit, fast.t, -1.0).numpy()
    t_r = torch.where(ref.hit, ref.t, -1.0).numpy()
    assert np.isclose(t_f, t_r, rtol=2e-3, atol=2e-3).all()
    assert torch.equal(fast.is_obj, ref.is_obj)


@pytest.mark.parametrize("table", ["f32", "oct"])
def test_dead_lanes_miss_and_visit_nothing(table):
    """``active``: dead lanes report no mesh winner and their t can only
    grow back to the primitives' value; live lanes are bitwise unaffected
    (the JAX model: tests/test_fastpath.py::test_intersect_active_mask_contract)."""
    _, (dev, meta) = _scenes()
    o_np, d_np = ship_rays(seed=7)
    o, d = _torch3(o_np), _torch3(d_np)
    active = torch.from_numpy(np.random.default_rng(7).random(N_RAYS) < 0.25)
    for sort in (False, "need"):
        kw = dict(mesh_pallas=True, winner_table=table, mesh_sort=sort)
        full = trace.intersect_soa(meta, dev, o, d, **kw)
        masked = trace.intersect_soa(meta, dev, o, d, active=active, **kw)
        for name in FIELDS:
            assert torch.equal(getattr(full, name)[active], getattr(masked, name)[active]), name
        assert not masked.is_obj[~active].any()
        assert (masked.t[~active] >= full.t[~active]).all()


def test_padding_rays_visit_no_cluster():
    """The kernel's visit count: padding rays (t_cap 0, far origin, +x) and
    dead lanes test no cluster; live rays test some."""
    _, (dev, meta) = _scenes()
    o_np, d_np = ship_rays(seed=3)
    n = len(o_np)
    active = np.random.default_rng(3).random(n) < 0.5
    o_np[~active], d_np[~active] = 1e7, (1.0, 0.0, 0.0)
    run = trace.intersect_primitives_soa(meta, _torch3(o_np), _torch3(d_np))
    rays = torch.stack([*_torch3(o_np), *_torch3(d_np),
                        torch.where(torch.from_numpy(active), run.t, 0.0)])
    out, visits = mh.mesh_hit(dev.face_plane, dev.cluster_bounds, rays, with_visits=True)
    assert visits.dtype == torch.int32 and visits.shape == (n,)
    assert int(visits[torch.from_numpy(~active)].abs().sum()) == 0
    assert int(visits[torch.from_numpy(active)].sum()) > n // 4
    assert (out[0][torch.from_numpy(~active)] == float("inf")).all()
    assert (out[4][torch.from_numpy(~active)] == -1.0).all()
    # with visit counting off, the same result
    assert torch.equal(mh.mesh_hit(dev.face_plane, dev.cluster_bounds, rays)[0], out)


@pytest.mark.parametrize("mode", ["need", "coherence", True])
def test_mesh_sort_scatters_back_exactly(mode):
    _, (dev, meta) = _scenes()
    o, d = _torch3(ship_rays(seed=5)[0]), _torch3(ship_rays(seed=5)[1])
    base = trace.intersect_soa(meta, dev, o, d, mesh_pallas=True)
    srt = trace.intersect_soa(meta, dev, o, d, mesh_pallas=True, mesh_sort=mode)
    for name in FIELDS:
        assert torch.equal(getattr(base, name), getattr(srt, name)), name
    for a, b in zip(base.normal, srt.normal):
        assert torch.equal(a, b)


def test_bounding_box_gives_identical_hit():
    _, (dev, meta) = _scenes()
    o, d = _torch3(ship_rays(n=600)[0]), _torch3(ship_rays(n=600)[1])
    base = trace.intersect_soa(meta, dev, o, d, mesh_pallas=False)
    boxed = trace.intersect_soa(meta, dev, o, d, mesh_pallas=False, bounding_box=True)
    for name in FIELDS:
        assert torch.equal(getattr(base, name), getattr(boxed, name)), name
    assert int(trace.mesh_aabb_mask(meta, o, d).sum()) < 600  # some rays are culled
    # no ray reaches the mesh: the face stream is skipped, the hit unchanged
    away = Vec3(*(torch.full((4,), v) for v in (0.0, 9.0, 0.0)))
    up = Vec3(torch.zeros(4), torch.ones(4), torch.zeros(4))
    a = trace.intersect_soa(meta, dev, away, up, mesh_pallas=False, bounding_box=True)
    b = trace.intersect_soa(meta, dev, away, up, mesh_pallas=False)
    assert torch.equal(a.t, b.t) and not a.is_obj.any()
