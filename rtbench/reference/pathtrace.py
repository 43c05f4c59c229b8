"""The plain reference path tracer: plain PyTorch over lanes, each lane one
(iteration, pixel) pair, so that a sample of pixels can be traced alone.

It computes what the configuration states the renderer computes (the
reference MyGPURaytracer's shadeFakeMaterial/scatterRay and
computeIntersections, with the port's documented choices):

- numbers: iteration ``it`` draws one block ``uniform(fold_in(key(seed),
  it), (4 + 3 * depth, W * H))`` of JAX's threefry2x32 (partitionable
  bits, ``(bits >> 9) | 0x3F800000`` - 1); element (r, pixel) is flat
  element ``r * W * H + pixel``. Rows 0-1 jitter the pixel by +-0.5 (AA),
  rows 4 + 3b .. 6 + 3b drive bounce b;
- camera: ``d = normalize(view - right * sx - up * sy)``, ``sx = pixel_length.x
  * (x - W/2)``;
- geometry: cubes and spheres tested in object space (direction
  renormalized, the hit pulled back 1e-4 along the local ray, t the world
  distance), the first geom winning ties; triangles in plane form, the
  nearest face closer than the primitives; bump maps perturb a mesh
  normal through the face's tangent frame;
- shading: mirror, Schlick refraction with total internal reflection, the
  OBJ branch (ke emission x5, a Fresnel choice of the ks texel or a cosine
  kd bounce), cosine diffuse; 0.01 surface offsets; a path ends on a miss,
  on an emitter, or at its last bounce; color * pi is added per iteration;
- the albedo AOV is the first hit's, at iteration 1.

Every float is computed in ``dtype``: float32 is the configuration's
precision, bfloat16 the control's. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scene import OBJ, Faces, Scene, world_faces

MASK32 = 0xFFFFFFFF
HIT_EPS = 1e-4
FLT_EPSILON = 1.1920929e-07
SQRT_ONE_THIRD = math.sqrt(1.0 / 3.0)
TWO_PI = 2.0 * math.pi
INF = float("inf")


# --- threefry2x32 (20 rounds), JAX's key derivation and uniforms ------------------

def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def iteration_key(seed: int, iteration: int) -> tuple[int, int]:
    """fold_in(key(seed), iteration) for an int32 seed."""
    return threefry2x32(0, seed & MASK32, 0, iteration & MASK32)


def uniforms(keys: tuple[torch.Tensor, torch.Tensor], rows: int, n: int,
             pixels: torch.Tensor) -> torch.Tensor:
    """[rows, L] float32: element (r, lane) of lane's iteration block at its
    pixel. ``keys`` are int64 [L] words, ``pixels`` int64 [L]."""
    idx = torch.arange(rows, dtype=torch.int64, device=pixels.device)[:, None] * n + pixels
    y0, y1 = threefry2x32(keys[0][None], keys[1][None], idx >> 32, idx & MASK32)
    bits = (y0 ^ y1) >> 9 | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# --- small vector helpers (tuples of three tensors) ---------------------------------

def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def normalize(a):
    inv = torch.rsqrt(torch.clamp_min(dot(a, a), 1e-30))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def xform_point(m, p):
    return tuple(m[i][0] * p[0] + m[i][1] * p[1] + m[i][2] * p[2] + m[i][3] for i in range(3))


def xform_dir(m, d):
    return tuple(m[i][0] * d[0] + m[i][1] * d[1] + m[i][2] * d[2] for i in range(3))


def reflect(i, n):
    d2 = 2.0 * dot(i, n)
    return (i[0] - d2 * n[0], i[1] - d2 * n[1], i[2] - d2 * n[2])


def scale(v, s):
    return (v[0] * s, v[1] * s, v[2] * s)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def neg(a):
    return (-a[0], -a[1], -a[2])


# --- primitives --------------------------------------------------------------------

def box_hit(g, o, d):
    qo = xform_point(g["inverse"], o)
    qd = normalize(xform_dir(g["inverse"], d))
    ta, tb, sg = [], [], []
    for a in range(3):
        t1 = (-0.5 - qo[a]) / qd[a]
        t2 = (0.5 - qo[a]) / qd[a]
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        ta.append(torch.where(lo > 0, lo, -1e38))
        tb.append(hi)
        one = torch.ones_like(t1)
        sg.append(torch.where(t2 < t1, one, -one))
    tmin = torch.maximum(torch.maximum(ta[0], ta[1]), ta[2])
    tmax = torch.minimum(torch.minimum(tb[0], tb[1]), tb[2])
    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_loc = torch.where(inside, tmax, tmin)
    ux = (inside & (tb[0] == tmax)) | (~inside & (ta[0] == tmin))
    uy = ~ux & ((inside & (tb[1] == tmax)) | (~inside & (ta[1] == tmin)))
    uz = ~ux & ~uy
    ln = (torch.where(ux, sg[0], 0.0), torch.where(uy, sg[1], 0.0), torch.where(uz, sg[2], 0.0))
    p_loc = tuple(qo[a] + (t_loc - HIT_EPS) * qd[a] for a in range(3))
    p_w = xform_point(g["transform"], p_loc)
    normal = normalize(xform_dir(g["inv_transpose"], ln))
    diff = (o[0] - p_w[0], o[1] - p_w[1], o[2] - p_w[2])
    return torch.where(hit, torch.sqrt(dot(diff, diff)), INF), normal


def sphere_hit(g, o, d):
    qo = xform_point(g["inverse"], o)
    qd = normalize(xform_dir(g["inverse"], d))
    vd = dot(qo, qd)
    radicand = vd * vd - (dot(qo, qo) - 0.25)
    root = torch.sqrt(torch.clamp_min(radicand, 0.0))
    t1, t2 = -vd + root, -vd - root
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_loc = torch.where(both_pos, torch.minimum(t1, t2), torch.maximum(t1, t2))
    hit = (radicand >= 0) & ~both_neg
    p_loc = tuple(qo[a] + (t_loc - HIT_EPS) * qd[a] for a in range(3))
    p_w = xform_point(g["transform"], p_loc)
    n = normalize(xform_dir(g["inv_transpose"], p_loc))
    n = where(both_pos, n, neg(n))
    diff = (o[0] - p_w[0], o[1] - p_w[1], o[2] - p_w[2])
    return torch.where(hit, torch.sqrt(dot(diff, diff)), INF), n


class Tracer:
    """One scene on one device in one float dtype; :meth:`render` traces the
    lanes of a set of pixels over a set of iterations."""

    MATERIAL_FIELDS = ("cr", "cg", "cb", "sr", "sg", "sb", "spec_ex", "refl", "refr", "ior",
                       "emit")

    def __init__(self, scene: Scene, device, dtype=torch.float32, faces: Faces | None = None,
                 face_block: int = 1 << 24):
        self.scene, self.device, self.dtype = scene, torch.device(device), dtype
        self.depth = scene.depth
        self.face_block = face_block  # (lane, face) pairs per block of the nearest-face test
        f32 = lambda x: float(np.float32(x))
        self.geoms = []
        for gi, g in enumerate(scene.geoms):
            m = g.material
            self.geoms.append(dict(
                kind=g.kind, index=gi,
                transform=[[f32(v) for v in row] for row in g.transform],
                inverse=[[f32(v) for v in row] for row in g.inverse],
                inv_transpose=[[f32(v) for v in row] for row in g.inv_transpose],
                mat=(*[f32(c) for c in m.color], *[f32(c) for c in m.spec_color],
                     float(m.spec_exponent), float(m.refl), float(m.refr), float(m.ior),
                     float(m.emit)),
                maps=g.maps))
        self.faces = faces if faces is not None else world_faces(scene)
        self.maps = {}
        if self.faces is not None:
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=self.device)
            self.plane = t(self.faces.plane.T).to(dtype)  # [12, F]
            self.face_geom = t(self.faces.geom)
            self.uvc = t(self.faces.uvc).to(dtype)
            self.tb = t(self.faces.tb).to(dtype)
            pad = 1e-3 * float(np.abs(self.faces.hi - self.faces.lo).max()) + 1e-3
            self.lo = [float(x) - pad for x in self.faces.lo]
            self.hi = [float(x) + pad for x in self.faces.hi]
            for g in self.geoms:
                for slot, img in g["maps"].items():
                    self.maps[(g["index"], slot)] = (t(img.reshape(-1, 3)), img.shape[1],
                                                     img.shape[0])
        cam = scene.camera
        self.set_camera(cam)

    def set_camera(self, cam) -> None:
        t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=self.device).to(self.dtype)
        self.cam = dict(position=t(cam.position), view=t(cam.view), right=t(cam.right),
                        up=t(cam.up), pixel_length=t(cam.pixel_length))
        self.resolution = cam.resolution

    # -- rays ---------------------------------------------------------------------
    def camera_rays(self, pixels: torch.Tensor, U: torch.Tensor, aa: bool):
        w, _ = self.resolution
        x = (pixels % w).to(self.dtype)
        y = torch.div(pixels, w, rounding_mode="floor").to(self.dtype)
        if aa:
            x = x + (U[0] - 0.5)
            y = y + (U[1] - 0.5)
        c = self.cam
        sx = c["pixel_length"][0] * (x - w * 0.5)
        sy = c["pixel_length"][1] * (y - self.resolution[1] * 0.5)
        d = normalize(tuple(c["view"][a] - c["right"][a] * sx - c["up"][a] * sy
                            for a in range(3)))
        n = pixels.shape[0]
        o = tuple(c["position"][a].expand(n) for a in range(3))
        return o, d

    # -- the scene query ------------------------------------------------------------
    def _texel(self, gid, slot, u, v):
        """(rgb, present) of map ``slot`` of the hit's geom, nearest texel."""
        z = torch.zeros_like(u)
        rgb, present = [z, z, z], torch.zeros(u.shape, dtype=torch.bool, device=u.device)
        for (gi, s), (img, w, h) in self.maps.items():
            if s != slot:
                continue
            sel = gid == gi
            cu = torch.clamp((u * w).to(torch.int32), 0, w - 1)
            cv = torch.clamp((v * h).to(torch.int32), 0, h - 1)
            texel = img[(cv * w + cu).to(torch.int64)].to(torch.float32) / 255.0
            rgb = [torch.where(sel, texel[:, j].to(u.dtype), rgb[j]) for j in range(3)]
            present = present | sel
        return tuple(rgb), present

    def _nearest_face(self, o, d, t_cap, lanes):
        """For the lanes ``lanes`` (int64 [K]): nearest face closer than
        t_cap, as (t, u, v, face) with face -1 where none."""
        q = self.plane
        F = q.shape[1]
        oo = [x[lanes][:, None] for x in o]
        dd = [x[lanes][:, None] for x in d]
        cap = t_cap[lanes]
        best_t = cap.clone()
        best_f = torch.full_like(lanes, -1)
        best_u = torch.zeros_like(cap)
        best_v = torch.zeros_like(cap)
        K = lanes.shape[0]
        block = max(1, self.face_block // max(K, 1))
        for s in range(0, F, block):
            r = q[:, s:s + block]
            A = oo[0] * r[0] + oo[1] * r[1] + oo[2] * r[2]
            B = dd[0] * r[0] + dd[1] * r[1] + dd[2] * r[2]
            B = torch.where(B.abs() < 1e-20, 1e-20, B)
            t = (r[3] - A) / B
            u = (oo[0] * r[4] + oo[1] * r[5] + oo[2] * r[6]) + t * (
                dd[0] * r[4] + dd[1] * r[5] + dd[2] * r[6])
            u = u - r[7]
            v = (oo[0] * r[8] + oo[1] * r[9] + oo[2] * r[10]) + t * (
                dd[0] * r[8] + dd[1] * r[9] + dd[2] * r[10])
            v = v - r[11]
            ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > HIT_EPS)
            t = torch.where(ok, t, INF)
            tc, j = t.min(dim=1)  # the lowest face index among equal t
            better = tc < best_t
            best_t = torch.where(better, tc, best_t)
            best_f = torch.where(better, j + s, best_f)
            best_u = torch.where(better, u.gather(1, j[:, None])[:, 0], best_u)
            best_v = torch.where(better, v.gather(1, j[:, None])[:, 0], best_v)
        return best_t, best_u, best_v, best_f

    def query(self, o, d, active):
        """Nearest hit of every lane (``active`` lanes only for the mesh):
        a dict of t (inf on a miss), normal, material fields, is_obj, u, v,
        geom id (-1: none)."""
        z = torch.zeros_like(o[0])
        t_run = torch.full_like(z, INF)
        normal = (z, z, z)
        mat = [z] * len(self.MATERIAL_FIELDS)
        gid = torch.full(z.shape, -1, dtype=torch.int64, device=z.device)
        for g in self.geoms:
            if g["kind"] == "cube":
                t, nrm = box_hit(g, o, d)
            elif g["kind"] == "sphere":
                t, nrm = sphere_hit(g, o, d)
            else:
                continue
            better = t < t_run
            t_run = torch.where(better, t, t_run)
            normal = where(better, nrm, normal)
            mat = [torch.where(better, c, m) for c, m in zip(g["mat"], mat)]
            gid = torch.where(better, g["index"], gid)
        is_obj = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
        u_tex = v_tex = z
        if self.faces is not None:
            # Lanes that can reach the faces' box (a conservative slab test).
            inv = [1.0 / torch.where(x.abs() < 1e-20, 1e-20, x) for x in d]
            t1 = [(self.lo[a] - o[a]) * inv[a] for a in range(3)]
            t2 = [(self.hi[a] - o[a]) * inv[a] for a in range(3)]
            tin = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                              torch.minimum(t1[1], t2[1])),
                                torch.minimum(t1[2], t2[2]))
            tout = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                               torch.maximum(t1[1], t2[1])),
                                 torch.maximum(t1[2], t2[2]))
            reach = active & (tout >= torch.clamp_min(tin, 0.0)) & (tin < t_run)
            lanes = reach.nonzero()[:, 0]
            if lanes.numel():
                mt, mu, mv, mf = self._nearest_face(o, d, t_run, lanes)
                win_k = mf >= 0
                lanes, mt, mu, mv, mf = (x[win_k] for x in (lanes, mt, mu, mv, mf))
                win = torch.zeros_like(is_obj)
                win[lanes] = True
                q = self.plane
                fn = normalize(tuple(q[a][mf] for a in range(3)))
                spread = lambda x, fill: torch.full_like(z, fill).index_put_((lanes,), x)
                fn = tuple(spread(c, 0.0) for c in fn)
                t_run = torch.where(win, spread(mt, INF), t_run)
                normal = where(win, fn, normal)
                is_obj = win
                mgid = torch.full_like(gid, -1).index_put_((lanes,), self.face_geom[mf])
                for g in self.geoms:
                    if g["kind"] == OBJ:
                        sel = win & (mgid == g["index"])
                        mat = [torch.where(sel, c, m) for c, m in zip(g["mat"], mat)]
                        gid = torch.where(sel, g["index"], gid)
                c = self.uvc[mf]
                u_tex = spread((c[:, 0] + mu * c[:, 2]) + mv * c[:, 4], 0.0)
                v_tex = spread((c[:, 1] + mu * c[:, 3]) + mv * c[:, 5], 0.0)
                if any(s == "bump" for (_, s) in self.maps):
                    tb = self.tb[mf]
                    tang = tuple(spread(tb[:, a], 0.0) for a in range(3))
                    bit = tuple(spread(tb[:, 3 + a], 0.0) for a in range(3))
                    texel, present = self._texel(gid, "bump", u_tex, v_tex)
                    tsn = normalize(tuple(x * 2.0 - 1.0 for x in normalize(texel)))
                    bumped = normalize(tuple(tsn[0] * tang[a] + tsn[1] * bit[a] + tsn[2] * fn[a]
                                             for a in range(3)))
                    normal = where(win & present, bumped, normal)
        hit = torch.isfinite(t_run)
        return dict(t=t_run, hit=hit, normal=normal, mat=mat, is_obj=is_obj, u=u_tex, v=v_tex,
                    gid=gid)

    # -- shading ------------------------------------------------------------------------
    def _obj_texels(self, h):
        kd, kd_p = self._texel(h["gid"], "kd", h["u"], h["v"])
        ks, ks_p = self._texel(h["gid"], "ks", h["u"], h["v"])
        ke, _ = self._texel(h["gid"], "ke", h["u"], h["v"])
        return kd, kd_p, ks, ks_p, ke

    def albedo(self, h):
        cr, cg, cb, sr, sg, sb, _, _, refr, _, emit = h["mat"]
        color, spec = (cr, cg, cb), (sr, sg, sb)
        z = torch.zeros_like(cr)
        if self.maps:
            kd, kd_p, _, _, ke = self._obj_texels(h)
            emits = (ke[0] > FLT_EPSILON) | (ke[1] > FLT_EPSILON) | (ke[2] > FLT_EPSILON)
            obj = where(emits, scale(ke, 5.0), where(kd_p, kd, color))
        else:
            obj = color
        plain = where(emit > 0, scale(color, emit), where(refr > 0, spec, color))
        return where(h["hit"], where(h["is_obj"], obj, plain), (z, z, z))

    def shade(self, state, h, u_choice, u1, u2):
        origin, direction, color, remaining = state
        cr, cg, cb, sr, sg, sb, spec_ex, refl, refr, ior, emit = h["mat"]
        mcolor, spec = (cr, cg, cb), (sr, sg, sb)
        alive = remaining > 0
        d, nrm, is_hit = direction, h["normal"], h["hit"]
        t_safe = torch.where(is_hit, h["t"], 0.0)
        p = tuple(origin[a] + t_safe * d[a] for a in range(3))
        zero = torch.zeros_like(u1)

        refl_dir = reflect(d, nrm)
        spec_dot = torch.clamp_min(dot(neg(d), refl_dir), 0.0)
        mirror_scale = refl * torch.pow(spec_dot, spec_ex)
        mirror_factor = scale(spec, mirror_scale)
        mirror_origin = add(p, scale(nrm, 0.01))

        cos_theta = dot(neg(d), nrm)
        entering = cos_theta >= 0
        r_nrm = where(entering, nrm, neg(nrm))
        ior1 = torch.where(entering, 1.0, ior)
        ior2 = torch.where(entering, ior, 1.0)
        cos_abs = cos_theta.abs()
        sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_abs * cos_abs, 0.0))
        tir = (ior1 / ior2) * sin_theta > 1.0
        schlick = lambda c, a, b: ((a - b) / (a + b)) ** 2 + (1.0 - ((a - b) / (a + b)) ** 2) * \
            torch.pow(1.0 - c, 5.0)
        choose_reflect = tir | (u_choice < schlick(cos_abs, ior1, ior2))
        eta = ior1 / ior2
        cosi = dot(r_nrm, d)
        k = 1.0 - eta * eta * (1.0 - cosi * cosi)
        coef = eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0))
        refracted = where(k < 0.0, (zero, zero, zero),
                          tuple(eta * d[a] - coef * r_nrm[a] for a in range(3)))
        refr_dir = where(choose_reflect, reflect(d, r_nrm), refracted)
        refr_origin = add(p, scale(refr_dir, 0.01))

        # cosine-weighted hemisphere (Peter Kutz's frame)
        up = torch.sqrt(u1)
        over = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
        around = u2 * TWO_PI
        ax = nrm[0].abs() < SQRT_ONE_THIRD
        ay = nrm[1].abs() < SQRT_ONE_THIRD
        one = torch.ones_like(nrm[0])
        nn = (torch.where(ax, one, zero), torch.where(ax, zero, torch.where(ay, one, zero)),
              torch.where(ax | ay, zero, one))
        p1 = normalize(cross(nrm, nn))
        p2 = normalize(cross(nrm, p1))
        c, s = torch.cos(around) * over, torch.sin(around) * over
        diffuse_dir = tuple(up * nrm[a] + c * p1[a] + s * p2[a] for a in range(3))

        if self.maps:
            kd, kd_p, ks, ks_p, ke = self._obj_texels(h)
            obj_emissive = (ke[0] > FLT_EPSILON) | (ke[1] > FLT_EPSILON) | (ke[2] > FLT_EPSILON)
            obj_emit_factor = scale(ke, 5.0)
            obj_spec = where(ks_p, ks, spec)
            obj_diff = where(kd_p, kd, mcolor)
        else:
            obj_emissive = torch.zeros_like(is_hit)
            obj_emit_factor = (zero, zero, zero)
            obj_spec, obj_diff = spec, mcolor
        obj_specular = u_choice < schlick(cos_theta, 1.0, ior)
        obj_factor = where(obj_specular, obj_spec, obj_diff)
        obj_dir = where(obj_specular, refl_dir, diffuse_dir)
        obj_origin = where(obj_specular, add(p, scale(nrm, 0.01)),
                           add(p, scale(diffuse_dir, 0.01)))
        diff_origin = add(p, scale(diffuse_dir, 0.01))

        is_mirror = refl > 0
        is_refr = ~is_mirror & (refr > 0)
        is_obj = ~is_mirror & ~is_refr & h["is_obj"] & is_hit
        is_obj_emit = is_obj & obj_emissive
        factor = where(is_mirror, mirror_factor, where(
            is_refr, spec, where(is_obj, where(is_obj_emit, obj_emit_factor, obj_factor),
                                 mcolor)))
        new_dir = where(is_mirror, refl_dir,
                        where(is_refr, refr_dir, where(is_obj, obj_dir, diffuse_dir)))
        new_origin = where(is_mirror, mirror_origin,
                           where(is_refr, refr_origin, where(is_obj, obj_origin, diff_origin)))

        emissive = emit > 0.0
        last = remaining == 1
        scatter = tuple(color[a] * factor[a] for a in range(3))
        emitted = tuple(color[a] * mcolor[a] * emit for a in range(3))
        z3 = (zero, zero, zero)
        new_color = where(is_hit, where(emissive, emitted, where(last, z3, scatter)), z3)
        terminated = ~is_hit | emissive | last | is_obj_emit
        new_remaining = torch.where(terminated, 0, remaining - 1)
        upd = alive & is_hit & ~emissive & ~last
        return (where(upd, new_origin, origin), where(upd, new_dir, direction),
                where(alive, new_color, color), torch.where(alive, new_remaining, remaining))

    # -- one pass -------------------------------------------------------------------------
    def trace(self, pixels: torch.Tensor, iterations: torch.Tensor, seed: int, aa: bool = True):
        """Lanes (iteration, pixel) for every iteration of ``iterations``
        ([m]) and pixel of ``pixels`` ([P]), iteration-major: (color * pi
        [3, m * P], first-hit albedo [3, m * P], path segments traced)."""
        n = self.resolution[0] * self.resolution[1]
        m, P = iterations.shape[0], pixels.shape[0]
        keys = torch.tensor([iteration_key(seed, int(it)) for it in iterations.tolist()],
                            dtype=torch.int64, device=self.device).repeat_interleave(P, dim=0)
        lanes = pixels.repeat(m)
        U = uniforms((keys[:, 0], keys[:, 1]), 4 + 3 * self.depth, n, lanes).to(self.dtype)
        o, d = self.camera_rays(lanes, U, aa)
        one = torch.ones(lanes.shape, dtype=self.dtype, device=self.device)
        state = (o, d, (one, one, one),
                 torch.full(lanes.shape, self.depth, dtype=torch.int32, device=self.device))
        segments = 0
        albedo = None
        for b in range(self.depth):
            alive = state[3] > 0
            segments += int(alive.sum())
            h = self.query(state[0], state[1], alive)
            if b == 0:
                albedo = self.albedo(h)
            state = self.shade(state, h, U[4 + 3 * b], U[5 + 3 * b], U[6 + 3 * b])
        color = tuple(c * math.pi for c in state[2])
        return torch.stack(color), torch.stack(albedo), segments

    def render(self, pixels, first: int, count: int, seed: int, aa: bool = True,
               lanes: int = 1 << 17, total: torch.Tensor | None = None):
        """Iterations first .. first + count - 1 at ``pixels`` (int64 [P]):
        (color sum over them [3, P], added to ``total`` if given, the albedo
        of iteration 1 if it is among them else zeros [3, P], path
        segments). The sum runs over the iterations in order, in ``dtype``."""
        P = pixels.shape[0]
        if total is None:
            total = torch.zeros((3, P), dtype=self.dtype, device=self.device)
        albedo = torch.zeros((3, P), dtype=self.dtype, device=self.device)
        segments = 0
        per = max(1, lanes // P)
        for s in range(first, first + count, per):
            its = torch.arange(s, min(s + per, first + count), device=self.device)
            m = its.shape[0]
            color, alb, seg = self.trace(pixels, its, seed, aa)
            segments += seg
            color = color.reshape(3, m, P)
            for i in range(m):
                total = total + color[:, i]
            if s == 1:
                albedo = alb.reshape(3, m, P)[:, 0]
        return total, albedo, segments
