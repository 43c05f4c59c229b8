"""Direction sampling and reflection/refraction math on [..., 3] tensors.

Counterparts of ``mygpuraytracer_tpu/ops/sampling.py``: cosine-weighted
hemisphere with the Peter-Kutz frame trick (interactions.h:12-44), the
stratified-jitter variant (interactions.h:47-86), the concentric disk for
thin-lens DoF (pathtrace.cu:225-239), and glm-compatible reflect/refract.
The render path uses the SoA forms in render/shade.py and render/camera.py.
"""

from __future__ import annotations

import math

import torch

SQRT_OF_ONE_THIRD = math.sqrt(1.0 / 3.0)  # utilities.h:14
TWO_PI = 2.0 * math.pi


def _hemisphere_frame(normal: torch.Tensor):
    """Two tangents perpendicular to ``normal`` (interactions.h:26-39)."""
    ax = normal[..., 0:1].abs() < SQRT_OF_ONE_THIRD
    ay = normal[..., 1:2].abs() < SQRT_OF_ONE_THIRD
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    not_normal = torch.where(ax, eye[0], torch.where(ay, eye[1], eye[2]))
    p1 = torch.linalg.cross(normal, not_normal)
    p1 = p1 / torch.linalg.norm(p1, dim=-1, keepdim=True)
    p2 = torch.linalg.cross(normal, p1)
    p2 = p2 / torch.linalg.norm(p2, dim=-1, keepdim=True)
    return p1, p2


def _hemisphere_from_polar(normal, up, around):
    over = torch.sqrt(torch.clamp_min(1.0 - up * up, 0.0))
    p1, p2 = _hemisphere_frame(normal)
    return (
        up[..., None] * normal
        + (torch.cos(around) * over)[..., None] * p1
        + (torch.sin(around) * over)[..., None] * p2
    )


def cosine_sample_hemisphere(normal, u1, u2):
    """Cosine-weighted hemisphere direction: up = sqrt(u1), around = 2*pi*u2."""
    return _hemisphere_from_polar(normal, torch.sqrt(u1), u2 * TWO_PI)


def jittered_sample_hemisphere(normal, u1, u2, iteration: int, max_iterations: int):
    """Stratified-jitter hemisphere variant (interactions.h:47-86)."""
    sqrt_val = int(math.sqrt(float(max_iterations)) + 0.5)
    inv = 1.0 / float(sqrt_val)
    x = float(iteration % sqrt_val)
    y = float(math.floor(iteration / sqrt_val))
    xp = torch.clamp((x + u1) * inv, 0.0, 1.0)
    yp = torch.clamp((y + u2) * inv, 0.0, 1.0)
    return _hemisphere_from_polar(normal, torch.sqrt(yp), xp * TWO_PI)


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """[..., 2] uniforms -> concentric disk (pathtrace.cu:225-239)."""
    offset = 2.0 * u - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    use_x = ox.abs() > oy.abs()
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, 0.785398 * (oy / safe_ox), 1.570796 - 0.785398 * (ox / safe_oy))
    disk = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    degenerate = (ox == 0.0) & (oy == 0.0)
    return torch.where(degenerate[..., None], 0.0, disk)


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """glm::reflect: I - 2*dot(N,I)*N."""
    return incident - 2.0 * (incident * normal).sum(-1, keepdim=True) * normal


def refract(incident: torch.Tensor, normal: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """glm::refract. Returns the zero vector on total internal reflection."""
    cosi = (normal * incident).sum(-1, keepdim=True)
    eta = eta[..., None] if eta.ndim == incident.ndim - 1 else eta
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta * incident - (eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0))) * normal
    return torch.where(k < 0.0, 0.0, refr)


def schlick_reflect_coeff(cos_theta: torch.Tensor, ior1, ior2) -> torch.Tensor:
    """Schlick approximation as written in interactions.h:152-153."""
    r0 = ((ior1 - ior2) / (ior1 + ior2)) ** 2
    return r0 + (1.0 - r0) * torch.pow(1.0 - cos_theta, 5.0)
