"""The reference-shaped ray-scene intersector: the test oracle of ``trace.py``.

Counterpart of ``mygpuraytracer_tpu/ops/intersect.py`` (apps/src/
intersections.h over a whole [N] wavefront of [N, 3] rays). No render path
runs it; the tests hold the fast path, ``ops/trace.py::intersect_soa``,
against it, as the JAX package's tests do with its own pair.

- box/sphere: local-space tests with the direction re-normalized after the
  inverse transform, the hit point pulled back by 1e-4 along the local ray
  (getPointOnRay, intersections.h:27-29), t the world distance from the
  origin (intersections.h:48-144). Every geom is tested as a cube and as a
  sphere and its type selects, as the JAX function's vmap does.
- mesh: Moller-Trumbore in world space over the chunked face buffer; the
  first minimum wins within a chunk and the first chunk across chunks.
- texels: nearest-neighbour ``int(u * w)`` with the indices clamped. The
  JAX package reads an f32 atlas of ``u8 / 255``; the port has only the byte
  atlas, so :func:`fetch_texel` reads it through ``trace.fetch_texel_soa``,
  whose ``byte / 255`` is the same float32 division, and needs the scene's
  ``meta`` for the slot table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.structs import GeomType
from .trace import fetch_texel_soa

HIT_EPS = 1e-4  # getPointOnRay pull-back (intersections.h:28)


class Intersection(NamedTuple):
    """SoA ShadeableIntersection (sceneStructs.h:115-121)."""

    t: torch.Tensor  # f32[N], -1 for miss
    normal: torch.Tensor  # f32[N,3]
    uv: torch.Tensor  # f32[N,2]
    geom_id: torch.Tensor  # i32[N], -1 for miss
    material_id: torch.Tensor  # i32[N]
    outside: torch.Tensor  # bool[N]


def _xform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(m @ [p, 1])[:3] for m [4,4], p [...,3]."""
    return p @ m[:3, :3].T + m[:3, 3]


def _xform_dir(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(m @ [d, 0])[:3]."""
    return d @ m[:3, :3].T


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def box_intersect(transform, inverse_transform, inv_transpose, origins, directions):
    """Unit cube [-0.5, 0.5]^3 slab test (intersections.h:48-90).

    Returns (t, normal, outside): t = -1 on miss, else world distance.
    """
    qo = _xform_point(inverse_transform, origins)
    qd = _normalize(_xform_dir(inverse_transform, directions))

    t1 = (-0.5 - qo) / qd  # unguarded, as in the reference
    t2 = (0.5 - qo) / qd
    ta = torch.minimum(t1, t2)
    tb = torch.maximum(t1, t2)
    n_sign = torch.where(t2 < t1, 1.0, -1.0)

    ta_masked = torch.where(ta > 0, ta, -1e38)
    tmin, axis_min = ta_masked.max(dim=-1)  # first maximum, as jnp.argmax
    tmax, axis_max = tb.min(dim=-1)

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_local = torch.where(inside, tmax, tmin)
    axis = torch.where(inside, axis_max, axis_min)
    outside = hit & ~inside

    eye = torch.eye(3, dtype=origins.dtype, device=origins.device)
    local_n = eye[axis] * n_sign.gather(-1, axis[:, None])
    p_local = qo + (t_local[:, None] - HIT_EPS) * qd
    p_world = _xform_point(transform, p_local)
    normal = _normalize(_xform_dir(inv_transpose, local_n))
    t = torch.linalg.vector_norm(origins - p_world, dim=-1)
    return torch.where(hit, t, -1.0), normal, outside


def sphere_intersect(transform, inverse_transform, inv_transpose, origins, directions):
    """Unit-diameter sphere (radius .5) quadratic test (intersections.h:102-144)."""
    qo = _xform_point(inverse_transform, origins)
    qd = _normalize(_xform_dir(inverse_transform, directions))

    v_dot_d = (qo * qd).sum(dim=-1)
    radicand = v_dot_d * v_dot_d - ((qo * qo).sum(dim=-1) - 0.25)
    has_root = radicand >= 0
    root = torch.sqrt(torch.clamp_min(radicand, 0.0))
    t1 = -v_dot_d + root
    t2 = -v_dot_d - root

    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_local = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    outside = both_pos
    hit = has_root & ~both_neg

    p_local = qo + (t_local[:, None] - HIT_EPS) * qd
    p_world = _xform_point(transform, p_local)
    normal = _normalize(_xform_dir(inv_transpose, p_local))
    normal = torch.where(outside[:, None], normal, -normal)
    t = torch.linalg.vector_norm(origins - p_world, dim=-1)
    return torch.where(hit, t, -1.0), normal, outside & hit


def aabb_intersect(aabb_min, aabb_max, origins, directions):
    """World-space AABB slab pre-test (cf. intersections.h:146-175)."""
    inv_d = 1.0 / directions
    t1 = (aabb_min - origins) * inv_d
    t2 = (aabb_max - origins) * inv_d
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return (tmax >= tmin) & (tmax > 0)


def mesh_intersect(dev, origins, directions, face_chunk: int = 64):
    """Nearest triangle over the world-space face buffer, ``face_chunk``
    faces at a time. Returns (t [N], inf for miss; face index i32 [N])."""
    F = dev.face_v0.shape[0]
    n = origins.shape[0]
    if F % face_chunk:
        raise ValueError(f"face buffer of {F} faces is not padded to chunks of {face_chunk}")
    best_t = torch.full((n,), float("inf"), dtype=origins.dtype, device=origins.device)
    best_f = torch.zeros(n, dtype=torch.int32, device=origins.device)
    d = directions[:, None, :]
    for start in range(0, F, face_chunk):
        v0 = dev.face_v0[start:start + face_chunk]  # [C,3]
        e1 = dev.face_e1[start:start + face_chunk]
        e2 = dev.face_e2[start:start + face_chunk]
        pvec = _cross(d, e2[None])  # [N,C,3]
        det = (e1[None] * pvec).sum(dim=-1)  # [N,C]
        inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
        tvec = origins[:, None, :] - v0[None]
        u = (tvec * pvec).sum(dim=-1) * inv_det
        qvec = _cross(tvec, e1[None])
        v = (d * qvec).sum(dim=-1) * inv_det
        t = (e2[None] * qvec).sum(dim=-1) * inv_det
        hit = (det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
        t = torch.where(hit, t, float("inf"))
        tc, jc = t.min(dim=-1)  # first minimum
        better = tc < best_t
        best_t = torch.where(better, tc, best_t)
        best_f = torch.where(better, jc.to(torch.int32) + start, best_f)
    return best_t, best_f


def fetch_texel(dev, tex_id, uv, meta):
    """Nearest-neighbour texel of slot ``tex_id`` [N] (0 = none) at ``uv``
    [N, 2] from the byte atlas. Returns (rgb [N, 3] in [0, 1], zeros where
    absent; present bool[N])."""
    rgb, present = fetch_texel_soa(dev, meta, tex_id, uv[:, 0], uv[:, 1])
    return torch.stack(rgb, dim=-1), present


def _mesh_normal_uv(dev, face_idx, directions):
    """The winner's geometric normal normalize(cross(e1, e2)) in world
    space (intersections.h:237-242), with its e1 and e2."""
    e1 = dev.face_e1[face_idx]
    e2 = dev.face_e2[face_idx]
    return _normalize(_cross(e1, e2)), e1, e2


def _apply_bump(dev, face_idx, gid, uv, normal, e1, e2, meta):
    """TBN bump-map normal perturbation (intersections.h:245-279)."""
    uv0 = dev.face_uv0[face_idx]
    duv1 = dev.face_uv1[face_idx] - uv0
    duv2 = dev.face_uv2[face_idx] - uv0
    denom = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    f = 1.0 / torch.where(denom.abs() < 1e-20, 1e-20, denom)
    tangent = _normalize(f[:, None] * (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2))
    bitangent = _normalize(f[:, None] * (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2))
    bump_id = dev.geom_bump[gid]
    texel, present = fetch_texel(dev, bump_id, uv, meta)
    tsn = _normalize(_normalize(texel) * 2.0 - 1.0)
    bumped = _normalize(tsn[:, 0:1] * tangent + tsn[:, 1:2] * bitangent + tsn[:, 2:3] * normal)
    return torch.where(present[:, None], bumped, normal)


def _barycentric_uv(dev, face_idx, origins, directions):
    """Interpolated texcoord of the winning face (intersections.h:221-226)."""
    v0 = dev.face_v0[face_idx]
    e1 = dev.face_e1[face_idx]
    e2 = dev.face_e2[face_idx]
    pvec = _cross(directions, e2)
    det = (e1 * pvec).sum(dim=-1)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tvec = origins - v0
    u = (tvec * pvec).sum(dim=-1) * inv_det
    qvec = _cross(tvec, e1)
    v = (directions * qvec).sum(dim=-1) * inv_det
    w = 1.0 - u - v
    return (w[:, None] * dev.face_uv0[face_idx] + u[:, None] * dev.face_uv1[face_idx]
            + v[:, None] * dev.face_uv2[face_idx])


def intersect_scene(dev, origins, directions, face_chunk: int = 64, meta=None) -> Intersection:
    """Nearest hit over all geoms (computeIntersections, pathtrace.cu:303-386):
    every geom tested, the first geom winning ties; the mesh stream's
    winner takes the hit where it is nearer. TRIANGLE geoms never hit, as
    in the reference. ``meta`` (the scene's ``SceneMeta``) gives the
    texture slots and is needed only when a geom has a bump map."""
    n = origins.shape[0]
    has_bump = bool((dev.geom_bump > 0).any())
    if has_bump and meta is None:
        raise ValueError("a bump-mapped scene needs its SceneMeta (meta=...) for the texel fetch")

    t_g, n_g, o_g = [], [], []
    for gtype, tf, itf, itt in zip(dev.geom_type.tolist(), dev.transform,
                                   dev.inverse_transform, dev.inv_transpose):
        tb, nb, ob = box_intersect(tf, itf, itt, origins, directions)
        ts, ns, os_ = sphere_intersect(tf, itf, itt, origins, directions)
        is_cube, is_sph = gtype == int(GeomType.CUBE), gtype == int(GeomType.SPHERE)
        t_g.append(tb if is_cube else ts if is_sph else torch.full_like(ts, -1.0))
        n_g.append(nb if is_cube else ns)
        o_g.append(ob if is_cube else os_)
    t_g, n_g, o_g = torch.stack(t_g), torch.stack(n_g), torch.stack(o_g)  # [G,N], [G,N,3], [G,N]

    t_pos = torch.where(t_g > 0, t_g, float("inf"))
    t_prim, gi = t_pos.min(dim=0)  # first geom wins ties
    lane = torch.arange(n, device=origins.device)
    n_prim = n_g[gi, lane]
    o_prim = o_g[gi, lane]

    t_mesh, face_idx = mesh_intersect(dev, origins, directions, face_chunk)
    face_idx = face_idx.to(torch.int64)
    mesh_gid = dev.face_geom[face_idx].to(torch.int64)

    mesh_wins = t_mesh < t_prim
    t_best = torch.where(mesh_wins, t_mesh, t_prim)
    hit = torch.isfinite(t_best)

    bary_uv = _barycentric_uv(dev, face_idx, origins, directions)
    m_nrm, e1, e2 = _mesh_normal_uv(dev, face_idx, directions)
    m_out = (m_nrm * directions).sum(dim=-1) < 0
    if meta is not None:
        m_nrm = _apply_bump(dev, face_idx, mesh_gid, bary_uv, m_nrm, e1, e2, meta)

    geom_id = torch.where(mesh_wins, mesh_gid, gi)
    normal = torch.where(mesh_wins[:, None], m_nrm, n_prim)
    uv = torch.where(mesh_wins[:, None], bary_uv, 0.0)
    outside = torch.where(mesh_wins, m_out, o_prim)
    material_id = dev.geom_material[geom_id]
    return Intersection(
        t=torch.where(hit, t_best, -1.0),
        normal=normal,
        uv=uv,
        geom_id=torch.where(hit, geom_id, -1).to(torch.int32),
        material_id=torch.where(hit, material_id, 0).to(torch.int32),
        outside=outside,
    )
