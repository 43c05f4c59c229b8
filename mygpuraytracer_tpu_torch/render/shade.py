"""Wavefront shading: BSDF evaluation + next-ray generation + albedo AOV.

Branchless SoA form of shadeFakeMaterial + scatterRay
(apps/src/pathtrace.cu:397-498, apps/src/interactions.h:112-258), as in
``mygpuraytracer_tpu/render/shade.py``. Every lane computes every branch and
selects; the only gathers are texel fetches, in textured scenes. Branch
precedence (pathtrace.cu:463-496, interactions.h:125-257):

  miss                      -> color = 0, terminate
  emissive material         -> color *= matColor * emittance, terminate
  last bounce (remaining=1) -> color = 0, terminate
  reflective                -> color *= refl * spec^exponent * specColor
  refractive                -> Schlick + TIR, color *= specColor
  OBJ geom                  -> ke-texel emission*5 (terminate) | Fresnel choice
                               of ks-texel specular vs kd-texel cosine diffuse
  diffuse                   -> cosine hemisphere, color *= matColor

Surface offsets: 0.01 along the normal for mirror bounces, 0.01 along the new
direction otherwise (interactions.h:131,165,216,238,255).

The K1 kernel (csrc/megakernel.cu) runs the same function per thread.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import vec3 as v3
from ..ops.trace import HitSoA, fetch_texel_soa, fetch_texels_packed
from ..ops.vec3 import Vec3

FLT_EPSILON = 1.1920929e-07
SQRT_ONE_THIRD = math.sqrt(1.0 / 3.0)
TWO_PI = 2.0 * math.pi


class PathStateSoA(NamedTuple):
    """SoA PathSegment (sceneStructs.h:105-110); pixelIndex == lane index."""

    origin: Vec3
    direction: Vec3
    color: Vec3
    remaining: torch.Tensor  # i32[N]


def cosine_hemisphere_soa(nrm: Vec3, u1, u2) -> Vec3:
    """Cosine-weighted hemisphere with the Peter-Kutz frame trick
    (interactions.h:12-44), in SoA form."""
    up = torch.sqrt(u1)
    over = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    around = u2 * TWO_PI

    ax = nrm.x.abs() < SQRT_ONE_THIRD
    ay = nrm.y.abs() < SQRT_ONE_THIRD
    one = torch.ones_like(nrm.x)
    zero = torch.zeros_like(nrm.x)
    nn = Vec3(
        torch.where(ax, one, zero),
        torch.where(ax, zero, torch.where(ay, one, zero)),
        torch.where(ax | ay, zero, one),
    )
    p1 = v3.normalize(v3.cross(nrm, nn))
    p2 = v3.normalize(v3.cross(nrm, p1))
    c = torch.cos(around) * over
    s = torch.sin(around) * over
    return Vec3(
        up * nrm.x + c * p1.x + s * p2.x,
        up * nrm.y + c * p1.y + s * p2.y,
        up * nrm.z + c * p1.z + s * p2.z,
    )


def refract_soa(i: Vec3, n: Vec3, eta) -> Vec3:
    cosi = v3.dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    coef = eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0))
    out = Vec3(eta * i.x - coef * n.x, eta * i.y - coef * n.y, eta * i.z - coef * n.z)
    zero = torch.zeros_like(cosi)
    return v3.where(k < 0.0, Vec3(zero, zero, zero), out)


def _schlick(cos_theta, ior1, ior2):
    r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    return r0 + (1.0 - r0) * torch.pow(1.0 - cos_theta, 5.0)


def _obj_texels(meta, dev, hit: HitSoA):
    """(kd texel, kd present, ks texel, ks present, ke texel) of the hit's
    maps, one packed gather where the scene has a packed atlas."""
    if meta.tex_pack_table:
        kd, kd_p, ks, ks_p, ke, _, _ = fetch_texels_packed(
            dev, meta, hit.kd, hit.ks, hit.ke, hit.bump, hit.u, hit.v)
        return kd, kd_p, ks, ks_p, ke
    ke, _ = fetch_texel_soa(dev, meta, hit.ke, hit.u, hit.v)
    kd, kd_p = fetch_texel_soa(dev, meta, hit.kd, hit.u, hit.v)
    ks, ks_p = fetch_texel_soa(dev, meta, hit.ks, hit.u, hit.v)
    return kd, kd_p, ks, ks_p, ke


def _emits(ke: Vec3) -> torch.Tensor:
    return (ke.x > FLT_EPSILON) | (ke.y > FLT_EPSILON) | (ke.z > FLT_EPSILON)


def shade_soa(meta, dev, state: PathStateSoA, hit: HitSoA, u_choice, u1, u2) -> PathStateSoA:
    """One shading round over the whole wavefront. Lanes with
    remaining == 0 pass through."""
    alive = state.remaining > 0
    d = state.direction
    nrm = hit.normal
    is_hit = hit.hit
    t_safe = torch.where(is_hit, hit.t, 0.0)
    p = Vec3(
        state.origin.x + t_safe * d.x,
        state.origin.y + t_safe * d.y,
        state.origin.z + t_safe * d.z,
    )

    # ---- mirror (interactions.h:125-133) -----------------------------------
    refl_dir = v3.reflect(d, nrm)
    spec_dot = torch.clamp_min(v3.dot(-d, refl_dir), 0.0)
    spec_pow = torch.pow(spec_dot, hit.spec_ex)  # pow(x,0)=1 as in CUDA
    mirror_scale = hit.refl * spec_pow
    mirror_factor = Vec3(
        mirror_scale * hit.spec_color.x,
        mirror_scale * hit.spec_color.y,
        mirror_scale * hit.spec_color.z,
    )
    mirror_origin = p + 0.01 * nrm

    # ---- refractive (interactions.h:134-166) --------------------------------
    cos_theta = v3.dot(-d, nrm)
    entering = cos_theta >= 0
    r_nrm = v3.where(entering, nrm, -nrm)
    ior1 = torch.where(entering, 1.0, hit.ior)
    ior2 = torch.where(entering, hit.ior, 1.0)
    cos_abs = cos_theta.abs()
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_abs * cos_abs, 0.0))
    tir = (ior1 / ior2) * sin_theta > 1.0
    r_coeff = _schlick(cos_abs, ior1, ior2)
    choose_reflect = tir | (u_choice < r_coeff)
    refr_dir = v3.where(choose_reflect, v3.reflect(d, r_nrm), refract_soa(d, r_nrm, ior1 / ior2))
    refr_origin = p + 0.01 * refr_dir

    # ---- OBJ branch (interactions.h:168-241) ----------------------------------
    diffuse_dir = cosine_hemisphere_soa(nrm, u1, u2)
    zero = torch.zeros_like(u1)
    if meta.has_textures:
        kd_texel, kd_present, ks_texel, ks_present, ke_texel = _obj_texels(meta, dev, hit)
        obj_emissive = _emits(ke_texel)
        obj_emit_factor = 5.0 * ke_texel
        obj_spec_color = v3.where(ks_present, ks_texel, hit.spec_color)
        obj_diff_color = v3.where(kd_present, kd_texel, hit.color)
    else:
        obj_emissive = torch.zeros_like(is_hit)
        obj_emit_factor = Vec3(zero, zero, zero)
        obj_spec_color = hit.spec_color
        obj_diff_color = hit.color
    obj_coeff = _schlick(cos_theta, 1.0, hit.ior)
    obj_specular = u_choice < obj_coeff
    # spec exponent hardcoded 0 in this branch (interactions.h:204) -> *1
    obj_factor = v3.where(obj_specular, obj_spec_color, obj_diff_color)
    obj_dir = v3.where(obj_specular, refl_dir, diffuse_dir)
    obj_origin = v3.where(obj_specular, p + 0.01 * nrm, p + 0.01 * diffuse_dir)

    # ---- pure diffuse ---------------------------------------------------------
    diff_origin = p + 0.01 * diffuse_dir

    # ---- branch select ---------------------------------------------------------
    is_mirror = hit.refl > 0
    is_refr = (~is_mirror) & (hit.refr > 0)
    is_obj = (~is_mirror) & (~is_refr) & hit.is_obj & is_hit
    is_obj_emit = is_obj & obj_emissive

    factor = v3.where(
        is_mirror, mirror_factor,
        v3.where(is_refr, hit.spec_color,
                 v3.where(is_obj, v3.where(is_obj_emit, obj_emit_factor, obj_factor),
                          hit.color)),
    )
    new_dir = v3.where(
        is_mirror, refl_dir, v3.where(is_refr, refr_dir, v3.where(is_obj, obj_dir, diffuse_dir))
    )
    new_origin = v3.where(
        is_mirror, mirror_origin,
        v3.where(is_refr, refr_origin, v3.where(is_obj, obj_origin, diff_origin)),
    )

    # ---- terminal rules (pathtrace.cu:463-496) ---------------------------------
    emissive = hit.emit > 0.0
    last_bounce = state.remaining == 1

    scatter_color = state.color * factor
    emit_color = Vec3(
        state.color.x * hit.color.x * hit.emit,
        state.color.y * hit.color.y * hit.emit,
        state.color.z * hit.color.z * hit.emit,
    )
    zero3 = Vec3(zero, zero, zero)
    new_color = v3.where(
        is_hit,
        v3.where(emissive, emit_color, v3.where(last_bounce, zero3, scatter_color)),
        zero3,
    )
    terminated = (~is_hit) | emissive | last_bounce | is_obj_emit
    new_remaining = torch.where(terminated, 0, state.remaining - 1)

    upd = alive & is_hit & ~emissive & ~last_bounce
    return PathStateSoA(
        origin=v3.where(upd, new_origin, state.origin),
        direction=v3.where(upd, new_dir, state.direction),
        color=v3.where(alive, new_color, state.color),
        remaining=torch.where(alive, new_remaining, state.remaining),
    )


def albedo_soa(meta, dev, hit: HitSoA) -> Vec3:
    """First-hit albedo for the denoiser (pathtrace.cu:412-459)."""
    zero = torch.zeros_like(hit.t)
    if meta.has_textures:
        kd_texel, kd_present, _, _, ke_texel = _obj_texels(meta, dev, hit)
        obj_albedo = v3.where(_emits(ke_texel), 5.0 * ke_texel,
                              v3.where(kd_present, kd_texel, hit.color))
    else:
        obj_albedo = hit.color
    plain = v3.where(
        hit.emit > 0,
        Vec3(hit.color.x * hit.emit, hit.color.y * hit.emit, hit.color.z * hit.emit),
        v3.where(hit.refr > 0, hit.spec_color, hit.color),
    )
    albedo = v3.where(hit.is_obj, obj_albedo, plain)
    return v3.where(hit.hit, albedo, Vec3(zero, zero, zero))
