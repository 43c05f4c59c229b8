"""SoA vec3 helpers: triples of [N] tensors.

The layout of ``mygpuraytracer_tpu/ops/vec3.py``: x, y and z are separate [N]
tensors, so the plain PyTorch path and the K1 CUDA kernel (one thread per
pixel) share one way of writing the math. Scalars may be Python floats;
they enter float32 arithmetic as float32, like JAX's weak-typed scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def splat(c, like: torch.Tensor | None = None, device=None) -> Vec3:
    """A (3,) constant as a Vec3 of float32 0-d tensors, on ``like``'s
    device or ``device`` (default CPU)."""
    if like is not None:
        device = like.device
    return Vec3(*(torch.tensor(float(c[i]), dtype=torch.float32, device=device)
                  for i in range(3)))


def from_array(a: torch.Tensor) -> Vec3:
    """[..., 3] -> Vec3 of [...]."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3) -> torch.Tensor:
    """Vec3 of [...] -> [..., 3]."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: Vec3):
    return torch.sqrt(dot(a, a))


def normalize(a: Vec3) -> Vec3:
    inv = torch.rsqrt(torch.clamp_min(dot(a, a), 1e-30))
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def where(cond, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(cond, a.x, b.x),
        torch.where(cond, a.y, b.y),
        torch.where(cond, a.z, b.z),
    )


def xform_point(m, p: Vec3) -> Vec3:
    """Apply a 4x4 matrix (nested Python floats, row-major) to a point."""
    return Vec3(
        m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
        m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
        m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3],
    )


def xform_dir(m, d: Vec3) -> Vec3:
    return Vec3(
        m[0][0] * d.x + m[0][1] * d.y + m[0][2] * d.z,
        m[1][0] * d.x + m[1][1] * d.y + m[1][2] * d.z,
        m[2][0] * d.x + m[2][1] * d.y + m[2][2] * d.z,
    )


def reflect(i: Vec3, n: Vec3) -> Vec3:
    d2 = 2.0 * dot(i, n)
    return Vec3(i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z)
