"""SoA trace core: primitive tests, the mesh paths and texel fetches.

Counterpart of ``mygpuraytracer_tpu/ops/trace.py``:

- geometry dispatch is a Python loop over the scene's static geom list
  (``SceneMeta.geoms``) whose transforms and materials are Python floats,
  and the nearest hit is carried through running selects, so the first geom
  wins ties (the strict ``t_min > t`` scan of pathtrace.cu:360);
- ``primitives_hit`` tests the literal face list ``SceneMeta.mega_faces``:
  the plain form of what the K1 CUDA kernel computes;
- ``intersect_soa`` takes the primitives' hit from ``nearest_primitives``
  (on CUDA tensors one launch of ``ops/prims_hit.py``'s kernel, on CPU
  tensors ``intersect_primitives_soa``, which it equals bit for bit) and
  merges a mesh query into it. Meshes of more than 256 faces go through the
  cluster query ``mesh_rows_hit`` when ``mesh_pallas`` is on (the default
  on CUDA tensors): one nearest-face query, ``ops/mesh_hit.py``, which
  launches the CUDA kernel on CUDA tensors and runs its plain version on
  CPU tensors, then the winner's texcoords and TBN frame from one row of a
  winner table. It is the counterpart of all three of the JAX package's
  mesh tiers (K2 rows, K3 lists, K4 conds), which are TPU schedules of that
  one query. Otherwise the faces stream in chunks through Moller-Trumbore
  (the CPU default and the oracle of the goldens), where the lowest face
  index wins a tie;
- ``bvh_scene_hit``, ``mesh_nearfar_hit`` and ``bvh_scene_hit_nearfar`` are
  the plain versions of the whole-scene query that K5 (``csrc/bounce.cu``)
  computes for untextured meshes: the primitives, then the nearest face
  under their t by ``mesh_hit_reference``;
- ``fetch_texel_soa`` and ``fetch_texels_packed`` read texels from the
  byte-packed atlases for textured and bump-mapped meshes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.structs import GeomType
from . import vec3 as v3
from .mesh_hit import mesh_hit, mesh_hit_reference
from .prims_hit import prims_hit
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
    u: torch.Tensor  # f32[N] texcoord of a mesh hit (0 elsewhere)
    v: torch.Tensor
    kd: torch.Tensor  # i32[N] texture slots of the hit geom (0 = none)
    ks: torch.Tensor
    ke: torch.Tensor
    bump: torch.Tensor


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


def mesh_intersect_soa(dev, o: Vec3, d: Vec3, chunk: int = 64, with_bump: bool = False):
    """Nearest world-space triangle via chunked Moller-Trumbore.

    Returns (t [N] with +inf miss, unnormalized face normal cross(e1, e2),
    texcoord u, v, owning geom id i64[N], bump extras): the winner's unit
    tangent and bitangent (6 tensors) when ``with_bump``, else (). A chunk
    holds at least ``chunk`` faces and grows to keep a panel near 2^20
    (ray, face) pairs for small ray counts; the result does not depend on
    it (the first minimum wins within and across chunks).
    """
    F = dev.face_v0.shape[0]
    n = o.x.shape[0]
    chunk = max(chunk, (1 << 20) // max(n, 1))
    device = o.x.device
    bt = torch.full((n,), INF, dtype=torch.float32, device=device)
    zeros = torch.zeros_like(bt)
    bn = Vec3(zeros, zeros, zeros)
    bu, bv = zeros, zeros
    bgid = torch.zeros(n, dtype=torch.int64, device=device)
    bex = (zeros,) * 6 if with_bump else ()
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
        fi = s + idx
        # face normal = cross(e1, e2) in world space
        fn = Vec3(e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z, e1x * e2y - e1y * e2x)
        # texcoord at the winner (intersections.h:226): w*uv0 + u*uv1 + v*uv2
        uw = u.gather(1, idx[:, None]).squeeze(1)
        vw = vv.gather(1, idx[:, None]).squeeze(1)
        ww = 1.0 - uw - vw
        uv0, uv1, uv2 = dev.face_uv0[fi], dev.face_uv1[fi], dev.face_uv2[fi]
        cu = ww * uv0[:, 0] + uw * uv1[:, 0] + vw * uv2[:, 0]
        cv = ww * uv0[:, 1] + uw * uv1[:, 1] + vw * uv2[:, 1]
        better = tc < bt
        bt = torch.where(better, tc, bt)
        bn = v3.where(better, Vec3(fn.x[idx], fn.y[idx], fn.z[idx]), bn)
        bu = torch.where(better, cu, bu)
        bv = torch.where(better, cv, bv)
        bgid = torch.where(better, dev.face_geom[fi].long(), bgid)
        if with_bump:
            tb = dev.face_tb[fi]
            bex = tuple(torch.where(better, tb[:, k], b) for k, b in enumerate(bex))
    return bt, bn, bu, bv, bgid, bex


class _Running:
    """Running nearest-hit state; ``take`` selects a geom's hit and
    ``set_material`` its material where ``better`` (the reference's select
    chain, ops/trace.py set_mat)."""

    def __init__(self, like: torch.Tensor):
        z = torch.zeros_like(like)
        zi = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
        self.t = torch.full_like(like, INF)
        self.normal = Vec3(z, z, z)
        self.is_obj = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
        self.color = Vec3(z, z, z)
        self.spec = Vec3(z, z, z)
        self.spec_ex = self.refl = self.refr = self.ior = self.emit = z
        self.u = self.v = z
        self.mat_id = self.kd = self.ks = self.ke = self.bump = zi

    @classmethod
    def from_rows(cls, rows_f: torch.Tensor, rows_i: torch.Tensor, zero: torch.Tensor):
        """The state from ``ops/prims_hit.py``'s rows, as views: the zero
        word [1] expanded into the texcoords and, as its first byte,
        ``is_obj``."""
        run = cls.__new__(cls)
        (run.t, nx, ny, nz, cr, cg, cb, sr, sg, sb, run.spec_ex, run.refl, run.refr, run.ior,
         run.emit) = rows_f
        run.normal, run.color, run.spec = Vec3(nx, ny, nz), Vec3(cr, cg, cb), Vec3(sr, sg, sb)
        run.mat_id, run.kd, run.ks, run.ke, run.bump = rows_i
        n = rows_f.shape[1]
        run.u = run.v = zero.expand(n)
        run.is_obj = zero.view(torch.uint8)[:1].view(torch.bool).expand(n)
        return run

    def set_material(self, better, g):
        w = lambda val, old: torch.where(better, val, old)
        self.color = Vec3(*(w(c, a) for c, a in zip(g.color, self.color)))
        self.spec = Vec3(*(w(c, a) for c, a in zip(g.spec_color, self.spec)))
        self.spec_ex = w(g.spec_exponent, self.spec_ex)
        self.refl = w(g.has_reflective, self.refl)
        self.refr = w(g.has_refractive, self.refr)
        self.ior = w(g.ior, self.ior)
        self.emit = w(g.emittance, self.emit)
        self.mat_id = w(g.material_id, self.mat_id)
        self.kd = w(g.kd, self.kd)
        self.ks = w(g.ks, self.ks)
        self.ke = w(g.ke, self.ke)
        self.bump = w(g.bump, self.bump)

    def take(self, better, g, t, normal: Vec3, is_obj: bool):
        self.t = torch.where(better, t, self.t)
        self.normal = v3.where(better, normal, self.normal)
        self.is_obj = (self.is_obj | better) if is_obj else (self.is_obj & ~better)
        self.set_material(better, g)

    def hit_soa(self) -> HitSoA:
        return HitSoA(
            t=self.t, hit=torch.isfinite(self.t), normal=self.normal,
            is_obj=self.is_obj, color=self.color, spec_color=self.spec,
            spec_ex=self.spec_ex, refl=self.refl, refr=self.refr, ior=self.ior,
            emit=self.emit, material_id=self.mat_id, u=self.u, v=self.v,
            kd=self.kd, ks=self.ks, ke=self.ke, bump=self.bump,
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


def nearest_primitives(meta, dev, o: Vec3, d: Vec3) -> _Running:
    """:func:`intersect_primitives_soa`'s running state: for CUDA tensors
    one launch of the primitive kernel over ``dev.prim_table``
    (``ops/prims_hit.py``), which equals it bit for bit; for CPU tensors
    the plain function itself."""
    if o.x.device.type == "cpu":
        return intersect_primitives_soa(meta, o, d)
    return _Running.from_rows(*prims_hit(dev.prim_table, o, d))


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


def aabb_hit_soa(bmin: tuple, bmax: tuple, o: Vec3, d: Vec3) -> torch.Tensor:
    """World axis-aligned slab test vs a literal box (intersections.h:146-175):
    the ray enters the box at some t > 0, or starts inside it."""
    def axis(bmn, bmx, oa, da):
        inv = 1.0 / torch.where(da.abs() < 1e-20, 1e-20, da)
        t1 = (bmn - oa) * inv
        t2 = (bmx - oa) * inv
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    ax, bx = axis(bmin[0], bmax[0], o.x, d.x)
    ay, by = axis(bmin[1], bmax[1], o.y, d.y)
    az, bz = axis(bmin[2], bmax[2], o.z, d.z)
    tmin = torch.maximum(torch.maximum(ax, ay), az)
    tmax = torch.minimum(torch.minimum(bx, by), bz)
    return (tmax >= tmin) & (tmax > 0)


def mesh_aabb_mask(meta, o: Vec3, d: Vec3) -> torch.Tensor:
    """Per-ray OR of the OBJ geoms' world-AABB tests: the BOUNDING_BOX
    pre-test (pathtrace.cu:348-353) and the ``mesh_sort="need"`` key."""
    mask = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    for g in meta.geoms:
        if g.type == int(GeomType.OBJ) and g.face_count > 0:
            mask = mask | aabb_hit_soa(g.aabb_min, g.aabb_max, o, d)
    return mask


def _mesh_sort_key(meta, o: Vec3, d: Vec3) -> torch.Tensor:
    """Coherence key for ``mesh_sort="coherence"``: a 4x4x4 origin cell over
    the clusters' bounds, the direction octant and two 3-bit anisotropy
    bins. 15 bits: [cell:6][oct:3][ax:3][ay:3]."""
    lo = [min(b[0][i] for b in meta.mesh_clusters) for i in range(3)]
    hi = [max(b[1][i] for b in meta.mesh_clusters) for i in range(3)]

    def q(x, a, b, n):
        t = (x - a) / max(b - a, 1e-6)
        return torch.clamp((t * n).to(torch.int32), 0, n - 1)

    cell = (q(o.x, lo[0], hi[0], 4) << 4) | (q(o.y, lo[1], hi[1], 4) << 2) | q(o.z, lo[2], hi[2], 4)
    oct_ = (((d.x > 0).int() << 2) | ((d.y > 0).int() << 1) | (d.z > 0).int())
    s = d.x.abs() + d.y.abs() + d.z.abs() + 1e-12
    ax = torch.clamp((d.x.abs() / s * 8).to(torch.int32), 0, 7)
    ay = torch.clamp((d.y.abs() / s * 8).to(torch.int32), 0, 7)
    return (cell << 9) | (oct_ << 6) | (ax << 3) | ay


def _winner_ex(dev, winner_table: str) -> torch.Tensor:
    """The mesh query's winner table for a resolved ``winner_table`` (the
    Renderer resolves "auto")."""
    if winner_table == "oct":
        return dev.face_ex_o
    if winner_table == "f32":
        return dev.face_ex_t
    raise ValueError(f"winner_table must be resolved to f32/oct here, got {winner_table!r} "
                     "(resolve 'auto' via Renderer before intersect_soa)")


def _cluster_bounds(meta, device) -> torch.Tensor:
    return torch.tensor([[c[k][i] for c in meta.mesh_clusters] for k in (0, 1) for i in range(3)],
                        dtype=torch.float32, device=device).reshape(6, -1)


def _nearest_face(meta, fp, o: Vec3, d: Vec3, t_cap, bounds, face_gather, tree) -> torch.Tensor:
    """The nearest-face query (ops/mesh_hit.py): [8, N] t, fn xyz, geom id,
    barycentric u, v, face id."""
    if bounds is None:
        bounds = _cluster_bounds(meta, o.x.device)
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z, t_cap]).to(torch.float32)
    return mesh_hit(fp, bounds, rays, face_gather=face_gather, tree=tree)[0]


def _unpack_f16_pairs(words: torch.Tensor) -> torch.Tensor:
    """u32-as-i32 words [N, k] -> float32 [N, 2k]: word j holds columns
    (2j, 2j+1) as IEEE halves, the even column in the low half."""
    half = lambda w: (w & 0xFFFF).to(torch.int16).view(torch.float16).to(torch.float32)
    return torch.stack([half(words), half(words >> 16)], dim=-1).reshape(words.shape[0], -1)


def _oct8_decode(qx: torch.Tensor, qy: torch.Tensor):
    """8-bit octahedral code -> unit vector (x, y, z)."""
    x = qx.to(torch.float32) * (2.0 / 255.0) - 1.0
    y = qy.to(torch.float32) * (2.0 / 255.0) - 1.0
    z = 1.0 - x.abs() - y.abs()
    t = torch.clamp_min(-z, 0.0)
    x = x + torch.where(x >= 0.0, -t, t)
    y = y + torch.where(y >= 0.0, -t, t)
    inv = torch.rsqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def mesh_rows_hit(meta, fs, o: Vec3, d: Vec3, t_cap, with_uv: bool = False,
                  with_tb: bool = False, ex=None, bounds=None, face_gather=None, tree=None):
    """The mesh query (the JAX package's K2, K3 and K4): the nearest mesh
    face closer than ``t_cap`` per ray, with the winner's uv and TBN
    gathered afterwards from the table ``ex``, one row per winner:
    ``dev.face_ex_t`` (f32 [Fp, 12]) or ``face_ex_o`` (f16 uv pairs +
    octahedral TBN [Fp, 4]).

    ``fs`` is the face buffer, ``dev.face_plane``: the TPU read its
    sublane-shifted copy, which the port does not build. ``bounds`` is
    ``dev.cluster_bounds`` (built from ``meta`` when None); the kernel, on
    CUDA tensors, walks ``face_gather`` and ``tree`` (``dev.face_gather``,
    ``dev.cluster_tree``), which CPU tensors do not need.

    Returns (t [N], inf where no face beats t_cap; unnormalized face normal
    Vec3; geom id f32 [N], -1 for none; extras: (u, v) if ``with_uv``, then
    tangent xyz, bitangent xyz if ``with_tb``). Extras of lanes without a
    mesh winner are those of face 0.
    """
    out = _nearest_face(meta, fs, o, d, t_cap, bounds, face_gather, tree)
    return out[0], Vec3(out[1], out[2], out[3]), out[4], _winner_extras(out, ex, with_uv, with_tb)


def _winner_extras(out: torch.Tensor, ex, with_uv: bool, with_tb: bool) -> tuple:
    """The mesh query's deferred fetch: the winner's texcoord and TBN frame
    from one row of the winner table ``ex`` per lane, decoded by its kind
    (f32 [Fp, 12], f16 pairs + oct8 TBN int32 [Fp, 4])."""
    if not (with_uv or with_tb):
        return ()
    u_b, v_b = out[5], out[6]
    gathered = ex[out[7].to(torch.int64).clamp(0, ex.shape[0] - 1)]
    oct_mode = ex.dtype == torch.int32
    if oct_mode:
        cols = _unpack_f16_pairs(gathered[:, :3])  # [N, 6] uv coefficients
    else:
        cols = gathered  # [N, 12] f32
    extras = []
    if with_uv:
        extras += [cols[:, 0] + u_b * cols[:, 2] + v_b * cols[:, 4],
                   cols[:, 1] + u_b * cols[:, 3] + v_b * cols[:, 5]]
    if with_tb:
        if oct_mode:
            q = [(gathered[:, 3] >> (8 * k)) & 0xFF for k in range(4)]
            extras += [*_oct8_decode(q[0], q[1]), *_oct8_decode(q[2], q[3])]
        else:
            extras += [cols[:, 6 + j] for j in range(6)]
    return tuple(extras)


def _merge_mesh_winner(meta, run: _Running, win, mt, fn: Vec3, gf) -> Vec3:
    """Take a mesh winner (t < the running t) into ``run``: its t, unit face
    normal (returned), OBJ flag and its geom's material by geom id."""
    mesh_nrm = v3.normalize(fn)
    run.t = torch.where(win, mt, run.t)
    run.normal = v3.where(win, mesh_nrm, run.normal)
    run.is_obj = run.is_obj | win
    for gi, g in enumerate(meta.geoms):
        if g.type == int(GeomType.OBJ):
            run.set_material(win & ((gf - gi).abs() < 0.5), g)
    return mesh_nrm


def bvh_scene_hit(meta, fp, o: Vec3, d: Vec3, bounds=None) -> HitSoA:
    """The primitives, then the nearest mesh face closer than their t, with
    materials resolved: the untextured whole-scene query of the JAX
    package's megakernels (``bvh_scene_hit``), as a plain version. ``fp``
    is ``dev.face_plane`` and ``bounds`` ``dev.cluster_bounds`` (built from
    ``meta`` when None); the mesh query is ``mesh_hit_reference``."""
    everyone = torch.ones(o.x.shape, dtype=torch.bool, device=o.x.device)
    return bvh_scene_hit_nearfar(meta, fp, o, d, everyone, bounds)


def mesh_nearfar_hit(meta, fp, o: Vec3, d: Vec3, t_cap, active, bounds=None):
    """Plain version of K5's near-to-far cluster walk: for each ``active``
    ray, the nearest face closer than ``t_cap``; dead lanes find none. The
    lowest face id wins among faces at equal t whatever the walk's order,
    so this runs ``mesh_hit_reference`` (ascending cluster id).

    Returns (win bool[N], t [N] (``t_cap`` where no face won), the winner's
    unnormalized face normal Vec3, geom id f32 [N], -1 for none), like the
    JAX function."""
    if bounds is None:
        bounds = _cluster_bounds(meta, o.x.device)
    rays = torch.stack([
        torch.where(active, o.x, 1e7), torch.where(active, o.y, 1e7),
        torch.where(active, o.z, 1e7), torch.where(active, d.x, 1.0),
        torch.where(active, d.y, 0.0), torch.where(active, d.z, 0.0),
        torch.where(active, t_cap, 0.0)]).to(torch.float32)
    out, _ = mesh_hit_reference(fp, bounds, rays)
    win = out[4] >= 0.0
    return win, torch.where(win, out[0], t_cap), Vec3(out[1], out[2], out[3]), out[4]


def bvh_scene_hit_nearfar(meta, fp, o: Vec3, d: Vec3, active, bounds=None) -> HitSoA:
    """:func:`bvh_scene_hit` through :func:`mesh_nearfar_hit`: lanes that
    are not ``active`` report ``hit=False`` and ``t=+inf``."""
    run = intersect_primitives_soa(meta, o, d)
    win, mt, fn, gf = mesh_nearfar_hit(meta, fp, o, d, run.t, active, bounds)
    _merge_mesh_winner(meta, run, win, mt, fn, gf)
    hit = run.hit_soa()
    return hit._replace(hit=hit.hit & active, t=torch.where(active, hit.t, INF))


def uses_cluster_query(meta, mesh_pallas: bool | None, device) -> bool:
    """Whether :func:`intersect_soa` sends the scene's meshes to the
    cluster query :func:`mesh_rows_hit` (``mesh_pallas``, None: on for a
    CUDA ``device``; a mesh of more than 256 faces in clusters), whose
    shapes are static, rather than the chunked stream, which compacts the
    live lanes."""
    if mesh_pallas is None:
        mesh_pallas = torch.device(device).type == "cuda"
    return bool(mesh_pallas and meta.mesh_clusters and meta.num_faces > 256)


def intersect_soa(
    meta, dev, o: Vec3, d: Vec3, face_chunk: int = 128, bounding_box: bool = False,
    mesh_pallas: bool | None = None, mesh_sort: bool | str = False,
    winner_table: str = "f32", active: torch.Tensor | None = None,
) -> HitSoA:
    """Nearest hit over the whole scene with materials resolved in-loop.

    - ``mesh_pallas`` (None: on for CUDA tensors) sends meshes of more than
      256 faces through the cluster query :func:`mesh_rows_hit`, whose
      winner texcoords and TBN come from the table ``winner_table`` ("f32"
      or "oct"); otherwise the chunked Moller-Trumbore stream runs.
    - ``mesh_sort`` ("need"/True or "coherence") stably sorts the rays
      before the cluster query and scatters the result back: the same
      result, more coherent blocks.
    - ``bounding_box``: the reference's AABB pre-test (pathtrace.cu:348-353)
      for the chunked stream; the same hit either way.
    - ``active`` (bool[N]) marks the lanes whose result the caller uses.
      Dead lanes query the clusters as padding rays (far origin, +x, t_cap 0),
      which visit no cluster, and the chunked stream skips them; their mesh
      result is forced to miss.
    - Bump-mapped meshes perturb the winner's normal through its TBN frame
      (intersections.h:245-279).
    """
    run = nearest_primitives(meta, dev, o, d)
    if not meta.has_obj:
        return run.hit_soa()
    if active is not None:
        o = Vec3(*(torch.where(active, c, 1e7) for c in o))
        d = Vec3(torch.where(active, d.x, 1.0), torch.where(active, d.y, 0.0),
                 torch.where(active, d.z, 0.0))
        t_query = torch.where(active, run.t, 0.0)
    else:
        t_query = run.t
    with_bump = any(g.bump > 0 for g in meta.geoms)
    zeros = torch.zeros_like(o.x)

    if uses_cluster_query(meta, mesh_pallas, o.x.device):
        table = _winner_ex(dev, winner_table)
        query = lambda ov, dv, tc: mesh_rows_hit(
            meta, dev.face_plane, ov, dv, tc, with_uv=meta.has_textures,
            with_tb=with_bump, ex=table, bounds=dev.cluster_bounds,
            face_gather=dev.face_gather, tree=dev.cluster_tree)
        if mesh_sort:
            key = (_mesh_sort_key(meta, o, d) if mesh_sort == "coherence"
                   else (~mesh_aabb_mask(meta, o, d)).to(torch.int32))
            order = torch.argsort(key, stable=True)

            def unscatter(a):
                out = torch.empty_like(a)
                out[order] = a
                return out

            mt, mn, mgid, ex_p = query(Vec3(*(c[order] for c in o)),
                                       Vec3(*(c[order] for c in d)), t_query[order])
            mt, mgid = unscatter(mt), unscatter(mgid)
            mn = Vec3(*(unscatter(c) for c in mn))
            ex_p = tuple(unscatter(a) for a in ex_p)
        else:
            mt, mn, mgid, ex_p = query(o, d, t_query)
        if meta.has_textures:
            mu, mv, bex = ex_p[0], ex_p[1], ex_p[2:]
        else:
            mu, mv, bex = zeros, zeros, ex_p
    elif bounding_box:
        box_mask = mesh_aabb_mask(meta, o, d)
        if bool(box_mask.any()):
            mt, mn, mu, mv, mgid, bex = mesh_intersect_soa(dev, o, d, face_chunk, with_bump)
            mt = torch.where(box_mask, mt, INF)
        else:  # no ray reaches a mesh AABB: skip the face stream
            mt, mn = torch.full_like(zeros, INF), Vec3(zeros, zeros, zeros)
            mu, mv, mgid = zeros, zeros, zeros
            bex = (zeros,) * 6 if with_bump else ()
    elif active is None:
        mt, mn, mu, mv, mgid, bex = mesh_intersect_soa(dev, o, d, face_chunk, with_bump)
    else:  # only the live lanes stream the faces (a dead lane's result is discarded)
        live = active.nonzero().squeeze(1)
        sub = mesh_intersect_soa(dev, Vec3(*(c[live] for c in o)), Vec3(*(c[live] for c in d)),
                                 face_chunk, with_bump)

        def spread(a, fill=0.0):
            return torch.full(zeros.shape, fill, dtype=a.dtype, device=a.device).index_put_(
                (live,), a)

        mt, mu, mv, mgid = spread(sub[0], INF), spread(sub[2]), spread(sub[3]), spread(sub[4])
        mn = Vec3(*(spread(c) for c in sub[1]))
        bex = tuple(spread(c) for c in sub[5])
    if active is not None:
        mt = torch.where(active, mt, INF)

    better = mt < run.t
    mesh_nrm = _merge_mesh_winner(meta, run, better, mt, mn, mgid)
    run.u = torch.where(better, mu, run.u)
    run.v = torch.where(better, mv, run.v)

    if with_bump:
        tangent, bitangent = Vec3(*bex[0:3]), Vec3(*bex[3:6])
        if meta.tex_pack_table:
            texel, present = fetch_texels_packed(
                dev, meta, run.kd, run.ks, run.ke, run.bump, run.u, run.v)[5:7]
        else:
            texel, present = fetch_texel_soa(dev, meta, run.bump, run.u, run.v)
        tsn = v3.normalize(v3.normalize(texel) * 2.0 - 1.0)
        bumped = v3.normalize(Vec3(
            tsn.x * tangent.x + tsn.y * bitangent.x + tsn.z * mesh_nrm.x,
            tsn.x * tangent.y + tsn.y * bitangent.y + tsn.z * mesh_nrm.y,
            tsn.x * tangent.z + tsn.y * bitangent.z + tsn.z * mesh_nrm.z,
        ))
        run.normal = v3.where(better & present, bumped, run.normal)
    return run.hit_soa()


def _texel_coords(u, v, w, h):
    """Nearest-texel column and row: clip(int(u*w), 0, max(w-1, 0))."""
    cu = torch.minimum(torch.clamp_min((u * w).to(torch.int32), 0), torch.clamp_min(w - 1, 0))
    cv = torch.minimum(torch.clamp_min((v * h).to(torch.int32), 0), torch.clamp_min(h - 1, 0))
    return cu, cv


def _byte(words: torch.Tensor, j: int) -> torch.Tensor:
    return ((words >> (8 * j)) & 0xFF).to(torch.float32) / 255.0


def fetch_texel_soa(dev, meta, tex_id, u, v):
    """Nearest texel of texture slot ``tex_id`` at (u, v) from the word
    atlas: (rgb Vec3 in [0, 1], present bool[N]); slot 0 and absent maps
    give zeros. Slot metadata resolves through a select chain over the
    static table ``meta.tex_table``."""
    zi = torch.zeros(tex_id.shape, dtype=torch.int32, device=tex_id.device)
    off, w, h, ch = zi, zi, zi, zi
    for t, (o_, w_, h_, c_) in enumerate(meta.tex_table):
        if t == 0 or c_ == 0:
            continue
        sel = tex_id == t
        off = torch.where(sel, o_, off)
        w = torch.where(sel, w_, w)
        h = torch.where(sel, h_, h)
        ch = torch.where(sel, c_, ch)
    cu, cv = _texel_coords(u, v, w, h)
    word = dev.tex_atlas_w[(off + cv * w + cu).to(torch.int64)]
    present = ch > 0
    return Vec3(*(torch.where(present, _byte(word, j), 0.0) for j in range(3))), present


def fetch_texels_packed(dev, meta, kd_id, ks_id, ke_id, bump_id, u, v):
    """All four of a geom's maps in one [N]-row gather from the packed atlas
    (``meta.tex_pack_table`` must be non-empty). Returns (kd Vec3,
    kd_present, ks Vec3, ks_present, ke Vec3, bump Vec3, bump_present);
    absent maps are zero/False, as in :func:`fetch_texel_soa`."""
    if not meta.tex_pack_table:
        raise ValueError("scene has no packed atlas")
    zi = torch.zeros(kd_id.shape, dtype=torch.int32, device=kd_id.device)
    off, w, h = zi, zi, zi
    kd_p = ks_p = ke_p = bp_p = torch.zeros(kd_id.shape, dtype=torch.bool, device=kd_id.device)
    for (kd_t, ks_t, ke_t, bp_t, o_, w_, h_) in meta.tex_pack_table:
        sel = (kd_id == kd_t) & (ks_id == ks_t) & (ke_id == ke_t) & (bump_id == bp_t)
        off = torch.where(sel, o_, off)
        w = torch.where(sel, w_, w)
        h = torch.where(sel, h_, h)
        kd_p = kd_p | (sel & (kd_t > 0))
        ks_p = ks_p | (sel & (ks_t > 0))
        ke_p = ke_p | (sel & (ke_t > 0))
        bp_p = bp_p | (sel & (bp_t > 0))
    cu, cv = _texel_coords(u, v, w, h)
    words = dev.tex_atlas16_w[(off + cv * w + cu).to(torch.int64)]  # [N, 4]

    def vec(base, p):
        return Vec3(*(torch.where(p, _byte(words[:, (base + j) // 4], (base + j) % 4), 0.0)
                      for j in range(3)))

    return (vec(0, kd_p), kd_p, vec(3, ks_p), ks_p, vec(6, ke_p), vec(9, bp_p), bp_p)
