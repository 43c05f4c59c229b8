"""The port's one mesh query on a textured, bump-mapped mesh against each
of JAX's mesh tiers.

The scene of tests/test_textured_tier.py, built from the same numpy data in
both packages: a wavy 18x18 grid mesh (648 faces, so the cluster tiers run)
with 16x16 kd/ks/ke maps and, in one case, a bump map, plus a wall cube
behind it and an emissive sphere. 1,085 rays (one (8, 128) tile and a
ragged tail), half aimed at the mesh. JAX runs its Pallas tier in interpret
mode; the port runs the plain version of the mesh kernel. Both read the
f32 winner table (JAX's default here).

Tolerances, the tightest that hold (JAX's own: t within 2e-3 on > 99.5% of
lanes, uv within 2e-3 on > 99%, normals within 1e-2 on > 98%):
- hit, is_obj, material_id and the texture slots equal on every lane;
- t within 1e-5 relative, uv within 1e-5 on every lane: XLA may contract
  the jitted JAX side differently from PyTorch (a few ulps of t);
- normals within 1e-5 on every lane without bump; with bump on > 99% of
  the mesh lanes, since a few-ulp uv shift can move the nearest bump texel
  at a texel edge.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.ops import trace as jax_trace
from mygpuraytracer_tpu.ops.vec3 import Vec3 as JaxVec3
from mygpuraytracer_tpu.scene import structs as jax_structs
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.scene import structs
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

N_RAYS = 8 * 128 + 61
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def wavy_mesh_scene(S, grid=18, with_bump=True):
    """tests/test_textured_tier.py::_wavy_mesh_scene with the structs module
    ``S`` of either package."""
    rng = np.random.default_rng(5)

    def tex(blue=False):
        img = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
        if blue:
            img[..., 2] = 255
        return S.Texture(width=16, height=16, channels=3, image=img)

    xs = np.linspace(-2.5, 2.5, grid + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 0.6 * np.sin(X * 2.1) * np.cos(Z * 1.7)
    P = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    U = np.stack([(X + 2.5) / 5.0, (Z + 2.5) / 5.0], axis=-1).astype(np.float32)
    pos, uv = [], []
    for i in range(grid):
        for j in range(grid):
            a, b, c, d = P[i, j], P[i + 1, j], P[i + 1, j + 1], P[i, j + 1]
            ua, ub, uc, ud = U[i, j], U[i + 1, j], U[i + 1, j + 1], U[i, j + 1]
            pos += [[a, b, c], [a, c, d]]
            uv += [[ua, ub, uc], [ua, uc, ud]]
    faces = S.FaceArray(positions=np.asarray(pos, np.float32), uvs=np.asarray(uv, np.float32))
    g = S.Geom(type=S.GeomType.OBJ, materialid=0)
    g.finalize_transform()
    g.face_count = len(faces.positions)
    g.kd, g.ks, g.ke = tex(), tex(), tex()
    if with_bump:
        g.bump = tex(blue=True)
    wall = S.Geom(type=S.GeomType.CUBE, materialid=1)
    wall.translation = np.array([0.0, 0.0, -4.0], np.float32)
    wall.scale = np.array([10.0, 10.0, 0.2], np.float32)
    wall.finalize_transform()
    light = S.Geom(type=S.GeomType.SPHERE, materialid=2)
    light.translation = np.array([0.0, 4.0, 0.0], np.float32)
    light.finalize_transform()
    s = S.Scene()
    s.geoms = [g, wall, light]
    s.materials = [
        S.Material(color=np.array([0.6, 0.6, 0.6], np.float32)),
        S.Material(color=np.array([0.3, 0.4, 0.5], np.float32)),
        S.Material(color=np.array([1, 1, 1], np.float32), emittance=5.0),
    ]
    s.all_faces = [faces, [], []]
    s.state.camera = S.Camera(resolution=(8, 8))
    s.state.camera.derive_fov(45.0)
    s.state.trace_depth = 4
    s.state.iterations = 1
    return s


def wavy_rays(n=N_RAYS, seed=9):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    o[:, 1] += 3.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = -o[: n // 2]
    d[: n // 2] = aim + 0.25 * rng.normal(size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("tier", ["rows", "lists"])
@pytest.mark.parametrize("with_bump", [False, True])
def test_textured_tier_matches_jax_tier(tier, with_bump):
    jdev, jmeta = jax_build(wavy_mesh_scene(jax_structs, with_bump=with_bump), 128)
    dev, meta = build_device_scene(wavy_mesh_scene(structs, with_bump=with_bump), 128,
                                   device="cpu")
    assert meta.has_textures and meta.mesh_clusters and meta.num_faces > 256
    o, d = wavy_rays()
    jfn = jax.jit(lambda dv, o_, d_: jax_trace.intersect_soa(
        jmeta, dv, o_, d_, 128, mesh_pallas=True, mesh_tier=tier))
    jh = jfn(jdev, JaxVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
             JaxVec3(*(jnp.asarray(d[:, i]) for i in range(3))))
    th = trace.intersect_soa(meta, dev, Vec3(*(torch.from_numpy(o[:, i].copy()) for i in range(3))),
                             Vec3(*(torch.from_numpy(d[:, i].copy()) for i in range(3))),
                             128, mesh_pallas=True)
    for name in ("hit", "is_obj", "material_id", "kd", "ks", "ke", "bump"):
        np.testing.assert_array_equal(getattr(th, name).numpy(), np.asarray(getattr(jh, name)),
                                      err_msg=name)
    mesh = th.is_obj.numpy()
    assert mesh.sum() > 200  # plenty of textured mesh hits compared
    hit = th.hit.numpy()
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=TOL, atol=0)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(th, name).numpy(), np.asarray(getattr(jh, name)),
                                   rtol=0, atol=TOL)
    for a, b in zip(th.normal, jh.normal):
        close = np.isclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
        if with_bump:
            assert close[mesh].mean() > 0.99 and close[~mesh].all()
        else:
            assert close.all()


@pytest.mark.parametrize("table,bump_atol", [("oct", 0.02)])
@pytest.mark.parametrize("with_bump", [False, True])
def test_winner_table_close_to_f32(table, bump_atol, with_bump):
    """The port's counterpart of tests/test_textured_tier.py's
    test_winner_table_oct_matches_f32, with its bars: the table changes
    only the deferred uv/TBN fetch, so t and hit are bitwise identical; uv
    within 2e-3 (f16 rounding of the uv coefficients); texture slots equal
    on > 99%; normals within 5e-3, or within 0.02 where oct's 8-bit TBN
    bends a bump-mapped normal."""
    dev, meta = build_device_scene(wavy_mesh_scene(structs, with_bump=with_bump), 128,
                                   device="cpu")
    o, d = (Vec3(*(torch.from_numpy(a[:, i].copy()) for i in range(3))) for a in wavy_rays())
    f32 = trace.intersect_soa(meta, dev, o, d, mesh_pallas=True)
    low = trace.intersect_soa(meta, dev, o, d, mesh_pallas=True, winner_table=table)
    assert torch.equal(low.hit, f32.hit) and torch.equal(low.t, f32.t)
    m = f32.is_obj & f32.hit
    assert int(m.sum()) > 200
    for name in ("u", "v"):
        assert float((getattr(low, name) - getattr(f32, name))[m].abs().max()) <= 2e-3
    for name in ("kd", "ks", "ke"):
        assert float((getattr(low, name) == getattr(f32, name))[m].float().mean()) > 0.99
    atol = bump_atol if with_bump else 5e-3
    for a, b in zip(low.normal, f32.normal):
        assert float((a - b)[m].abs().max()) <= atol


def test_textured_tier_mesh_sort_scatters_back():
    """mesh_sort scatters texcoords and the bumped normals back exactly."""
    dev, meta = build_device_scene(wavy_mesh_scene(structs), 128, device="cpu")
    o, d = (Vec3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))
            for a in wavy_rays(n=8 * 128, seed=13))
    base = trace.intersect_soa(meta, dev, o, d, mesh_pallas=True)
    for mode in ("need", "coherence"):
        srt = trace.intersect_soa(meta, dev, o, d, mesh_pallas=True, mesh_sort=mode)
        for name in ("t", "hit", "u", "v", "kd", "bump", "material_id"):
            assert torch.equal(getattr(srt, name), getattr(base, name)), (mode, name)
        for a, b in zip(srt.normal, base.normal):
            assert torch.equal(a, b)
