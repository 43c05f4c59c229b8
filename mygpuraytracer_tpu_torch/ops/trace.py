"""SoA trace core: unrolled primitive tests and small-mesh intersection.

Counterpart of ``mygpuraytracer_tpu/ops/trace.py`` for scenes of cubes, spheres
and untextured meshes:

- geometry dispatch is a Python loop over the scene's static geom list
  (``SceneMeta.geoms``) whose transforms and materials are Python floats,
  and the nearest hit is carried through running selects, so the first geom
  wins ties (the strict ``t_min > t`` scan of pathtrace.cu:360);
- ``intersect_soa`` streams mesh faces in chunks through Moller-Trumbore
  (the JAX wavefront's mesh path on the CPU); the lowest face index wins a
  tie, as the JAX first-match one-hot does;
- ``primitives_hit`` tests the literal face list ``SceneMeta.mega_faces``
  instead: it is the plain form of what the K1 CUDA kernel computes.

The cluster-BVH mesh tiers (K2-K4) and textures belong to later slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.structs import GeomType
from . import vec3 as v3
from .vec3 import Vec3

HIT_EPS = 1e-4
INF = float("inf")


class HitSoA(NamedTuple):
    """Nearest-hit record with materials already resolved."""

    t: torch.Tensor  # f32[N], +inf for miss
    hit: torch.Tensor  # bool[N]
    normal: Vec3
    is_obj: torch.Tensor  # bool[N] — hit geom is OBJ-typed
    color: Vec3
    spec_color: Vec3
    spec_ex: torch.Tensor
    refl: torch.Tensor
    refr: torch.Tensor
    ior: torch.Tensor
    emit: torch.Tensor
    material_id: torch.Tensor  # i32[N]


def box_intersect_soa(g, o: Vec3, d: Vec3):
    """Reference slab test (intersections.h:48-90) on literal matrices.

    Returns (t_world [N] with +inf miss, normal Vec3).
    """
    qo = v3.xform_point(g.inverse_transform, o)
    qd = v3.normalize(v3.xform_dir(g.inverse_transform, d))

    def axis(qo_a, qd_a):
        t1 = (-0.5 - qo_a) / qd_a
        t2 = (0.5 - qo_a) / qd_a
        ta = torch.minimum(t1, t2)
        tb = torch.maximum(t1, t2)
        sign = torch.where(t2 < t1, 1.0, -1.0)
        return torch.where(ta > 0, ta, -1e38), tb, sign

    tax, tbx, sx = axis(qo.x, qd.x)
    tay, tby, sy = axis(qo.y, qd.y)
    taz, tbz, sz = axis(qo.z, qd.z)

    tmin = torch.maximum(torch.maximum(tax, tay), taz)
    tmax = torch.minimum(torch.minimum(tbx, tby), tbz)
    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_loc = torch.where(inside, tmax, tmin)

    # axis that set t_loc, priority x > y > z
    ux = (inside & (tbx == tmax)) | (~inside & (tax == tmin))
    uy = ~ux & ((inside & (tby == tmax)) | (~inside & (tay == tmin)))
    uz = ~ux & ~uy
    ln = Vec3(torch.where(ux, sx, 0.0), torch.where(uy, sy, 0.0), torch.where(uz, sz, 0.0))

    p_loc = Vec3(
        qo.x + (t_loc - HIT_EPS) * qd.x,
        qo.y + (t_loc - HIT_EPS) * qd.y,
        qo.z + (t_loc - HIT_EPS) * qd.z,
    )
    p_w = v3.xform_point(g.transform, p_loc)
    normal = v3.normalize(v3.xform_dir(g.inv_transpose, ln))
    t = v3.length(o - p_w)
    return torch.where(hit, t, INF), normal


def sphere_intersect_soa(g, o: Vec3, d: Vec3):
    """Reference quadratic test (intersections.h:102-144), radius 0.5."""
    qo = v3.xform_point(g.inverse_transform, o)
    qd = v3.normalize(v3.xform_dir(g.inverse_transform, d))

    vd = v3.dot(qo, qd)
    radicand = vd * vd - (v3.dot(qo, qo) - 0.25)
    root = torch.sqrt(torch.clamp_min(radicand, 0.0))
    t1 = -vd + root
    t2 = -vd - root
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_loc = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    hit = (radicand >= 0) & ~both_neg

    p_loc = Vec3(
        qo.x + (t_loc - HIT_EPS) * qd.x,
        qo.y + (t_loc - HIT_EPS) * qd.y,
        qo.z + (t_loc - HIT_EPS) * qd.z,
    )
    p_w = v3.xform_point(g.transform, p_loc)
    n = v3.normalize(v3.xform_dir(g.inv_transpose, p_loc))
    n = v3.where(both_pos, n, -n)
    t = v3.length(o - p_w)
    return torch.where(hit, t, INF), n


def mesh_intersect_soa(dev, o: Vec3, d: Vec3, chunk: int = 64):
    """Nearest world-space triangle via chunked Moller-Trumbore.

    Returns (t [N] with +inf miss, unnormalized face normal cross(e1, e2),
    owning geom id i64[N]).
    """
    F = dev.face_v0.shape[0]
    n = o.x.shape[0]
    bt = torch.full((n,), INF, dtype=torch.float32, device=o.x.device)
    zeros = torch.zeros_like(bt)
    bn = Vec3(zeros, zeros, zeros)
    bgid = torch.zeros(n, dtype=torch.int64, device=o.x.device)
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
    for s in range(0, F, chunk):
        v0x, v0y, v0z = dev.face_v0[s:s + chunk].unbind(1)
        e1x, e1y, e1z = dev.face_e1[s:s + chunk].unbind(1)
        e2x, e2y, e2z = dev.face_e2[s:s + chunk].unbind(1)
        # pvec = cross(d, e2): [N, C]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        # qvec = cross(tvec, e1)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (det.abs() > 1e-12) & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (t > HIT_EPS)
        t = torch.where(ok, t, INF)
        tc, idx = t.min(dim=1)  # first index among equal minima
        # face normal = cross(e1, e2) in world space
        fn = Vec3(e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z, e1x * e2y - e1y * e2x)
        better = tc < bt
        bt = torch.where(better, tc, bt)
        bn = v3.where(better, Vec3(fn.x[idx], fn.y[idx], fn.z[idx]), bn)
        bgid = torch.where(better, dev.face_geom[s:s + chunk][idx].long(), bgid)
    return bt, bn, bgid


class _Running:
    """Running nearest-hit state; ``take`` selects a geom's hit and material
    where ``better`` (the reference's select chain, ops/trace.py set_mat)."""

    def __init__(self, like: torch.Tensor):
        z = torch.zeros_like(like)
        self.t = torch.full_like(like, INF)
        self.normal = Vec3(z, z, z)
        self.is_obj = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
        self.color = Vec3(z, z, z)
        self.spec = Vec3(z, z, z)
        self.spec_ex = self.refl = self.refr = self.ior = self.emit = z
        self.mat_id = torch.zeros(like.shape, dtype=torch.int32, device=like.device)

    def take(self, better, g, t, normal: Vec3, is_obj: bool):
        w = lambda val, old: torch.where(better, val, old)
        self.t = w(t, self.t)
        self.normal = v3.where(better, normal, self.normal)
        self.is_obj = (self.is_obj | better) if is_obj else (self.is_obj & ~better)
        self.color = Vec3(*(w(c, a) for c, a in zip(g.color, self.color)))
        self.spec = Vec3(*(w(c, a) for c, a in zip(g.spec_color, self.spec)))
        self.spec_ex = w(g.spec_exponent, self.spec_ex)
        self.refl = w(g.has_reflective, self.refl)
        self.refr = w(g.has_refractive, self.refr)
        self.ior = w(g.ior, self.ior)
        self.emit = w(g.emittance, self.emit)
        self.mat_id = w(g.material_id, self.mat_id)

    def hit_soa(self) -> HitSoA:
        return HitSoA(
            t=self.t, hit=torch.isfinite(self.t), normal=self.normal,
            is_obj=self.is_obj, color=self.color, spec_color=self.spec,
            spec_ex=self.spec_ex, refl=self.refl, refr=self.refr, ior=self.ior,
            emit=self.emit, material_id=self.mat_id,
        )


def intersect_primitives_soa(meta, o: Vec3, d: Vec3) -> _Running:
    """Unrolled cube/sphere intersection with material resolution (first
    geom wins ties). Returns the running state the mesh merge continues."""
    run = _Running(o.x)
    for g in meta.geoms:
        if g.type == int(GeomType.CUBE):
            t, nrm = box_intersect_soa(g, o, d)
        elif g.type == int(GeomType.SPHERE):
            t, nrm = sphere_intersect_soa(g, o, d)
        else:
            continue  # TRIANGLE has no dispatch case; OBJ handled separately
        run.take(t < run.t, g, t, nrm, is_obj=False)
    return run


def primitives_hit(meta, o: Vec3, d: Vec3) -> HitSoA:
    """HitSoA from primitives + the literal face list ``meta.mega_faces``:
    the intersection the K1 kernel computes (csrc/megakernel.cu)."""
    run = intersect_primitives_soa(meta, o, d)
    for gi, v0c, e1c, e2c, nrmc in meta.mega_faces:
        pvec = Vec3(d.y * e2c[2] - d.z * e2c[1],
                    d.z * e2c[0] - d.x * e2c[2],
                    d.x * e2c[1] - d.y * e2c[0])
        det = e1c[0] * pvec.x + e1c[1] * pvec.y + e1c[2] * pvec.z
        inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
        tvec = Vec3(o.x - v0c[0], o.y - v0c[1], o.z - v0c[2])
        u = v3.dot(tvec, pvec) * inv_det
        qvec = Vec3(tvec.y * e1c[2] - tvec.z * e1c[1],
                    tvec.z * e1c[0] - tvec.x * e1c[2],
                    tvec.x * e1c[1] - tvec.y * e1c[0])
        vv = v3.dot(d, qvec) * inv_det
        t = (e2c[0] * qvec.x + e2c[1] * qvec.y + e2c[2] * qvec.z) * inv_det
        ok = (det.abs() > 1e-12) & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (t > HIT_EPS)
        z = torch.zeros_like(t)
        nrm = Vec3(z + nrmc[0], z + nrmc[1], z + nrmc[2])
        run.take(ok & (t < run.t), meta.geoms[gi], t, nrm, is_obj=True)
    return run.hit_soa()


def intersect_soa(meta, dev, o: Vec3, d: Vec3, face_chunk: int = 64) -> HitSoA:
    """Nearest hit over the whole scene with materials resolved in-loop
    (the JAX wavefront's ``intersect_soa`` for untextured scenes)."""
    if meta.has_textures:
        raise NotImplementedError("textured meshes are not ported yet")
    run = intersect_primitives_soa(meta, o, d)
    if meta.has_obj:
        mt, mn, mgid = mesh_intersect_soa(dev, o, d, face_chunk)
        better = mt < run.t
        mesh_nrm = v3.normalize(mn)
        for gi, g in enumerate(meta.geoms):
            if g.type == int(GeomType.OBJ):
                sel = better & (mgid == gi)
                run.take(sel, g, mt, mesh_nrm, is_obj=True)
    return run.hit_soa()
