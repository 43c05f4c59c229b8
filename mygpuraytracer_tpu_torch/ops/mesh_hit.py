"""The mesh tiers' nearest-face query: one CUDA kernel for K2, K3 and K4.

The port of the function that ``mygpuraytracer_tpu/ops/trace.py``'s three
Pallas mesh tiers compute (``mesh_rows_hit``, ``mesh_list_hit``,
``mesh_pallas_hit``): for each ray, the nearest face of the clustered mesh
with HIT_EPS < t < t_cap, from the plane-form faces ``face_plane`` [16, Fp]
and the cluster AABBs [6, C]. Source: ``csrc/mesh_hit.cu``.

Rays come as one [7, N] float32 tensor (origin xyz, direction xyz, t_cap).
The result is one [8, N] float32 tensor: t (inf where no face beats t_cap),
the winner's face normal xyz (unnormalized), geom id (-1: none), its
barycentric u and v, and its face id (0 where none); and, on request, the
number of clusters each ray tested (int32 [N]). A ray with t_cap 0 (the
padding convention: far origin, +x direction) tests none.

``mesh_hit`` launches the kernel for CUDA tensors and counts its launches
in ``LAUNCHES``; for CPU tensors it runs the plain version,
``mesh_hit_reference``, which walks the clusters in the same order with the
same arithmetic and equals the kernel bit for bit.
"""

from __future__ import annotations

import torch

from ..scene.device_scene import CLUSTER_SIZE

HIT_EPS = 1e-4
DIR_EPS = 1e-20
OUT_ROWS = 8  # t, fn xyz, geom, u, v, face id

LAUNCHES = 0  # kernel launches since the last reset


def _clamp_eps(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < DIR_EPS, DIR_EPS, x)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def mesh_hit_reference(face_plane: torch.Tensor, bounds: torch.Tensor, rays: torch.Tensor,
                       with_visits: bool = False):
    """Plain version of the kernel: clusters in ascending id; per cluster,
    the rays whose slab test passes against their running best test its 128
    faces; the first minimum wins and replaces the best if strictly less."""
    n = rays.shape[1]
    o, d, best = rays[0:3], rays[3:6], rays[6].clone()
    inv = 1.0 / _clamp_eps(d)
    out = torch.zeros((OUT_ROWS, n), dtype=torch.float32, device=rays.device)
    out[4] = -1.0
    visits = torch.zeros(n, dtype=torch.int32, device=rays.device)
    for c in range(bounds.shape[1]):
        t1 = (bounds[0:3, c:c + 1] - o) * inv
        t2 = (bounds[3:6, c:c + 1] - o) * inv
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
        tout = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
        idx = ((tout >= tin.clamp_min(0.0)) & (tin < best)).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        visits[idx] += 1
        f = face_plane[:, c * CLUSTER_SIZE:(c + 1) * CLUSTER_SIZE]  # [16, 128]
        ro, rd = o[:, idx, None], d[:, idx, None]  # [3, k, 1]
        A = _dot(ro, f[0:3])
        B = _clamp_eps(_dot(rd, f[0:3]))
        t = (f[3] - A) / B
        u = _dot(ro, f[4:7]) + t * _dot(rd, f[4:7]) - f[7]
        v = _dot(ro, f[8:11]) + t * _dot(rd, f[8:11]) - f[11]
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
        tc, j = torch.where(ok, t, torch.inf).min(dim=1)  # first index among equal minima
        better = tc < best[idx]
        sel, j = idx[better], j[better]
        best[sel] = tc[better]
        out[1:4, sel] = f[0:3, j]
        out[4, sel] = f[12, j]
        out[5, sel] = u[better].gather(1, j[:, None]).squeeze(1)
        out[6, sel] = v[better].gather(1, j[:, None]).squeeze(1)
        out[7, sel] = (c * CLUSTER_SIZE + j).to(torch.float32)
    out[0] = torch.where(out[4] >= 0.0, best, torch.inf)
    return out, (visits if with_visits else None)


def mesh_hit(face_plane: torch.Tensor, bounds: torch.Tensor, rays: torch.Tensor,
             with_visits: bool = False):
    """Nearest face per ray: ``(out [8, N], visits [N] or None)``, by the
    CUDA kernel for CUDA tensors (one launch on the current stream) and by
    the plain version for CPU tensors."""
    global LAUNCHES
    if rays.device.type == "cpu":
        return mesh_hit_reference(face_plane, bounds, rays, with_visits)
    if rays.device.type != "cuda":
        raise ValueError(f"the mesh kernel runs on CUDA or (plain) CPU tensors, not {rays.device}")
    for name, x in (("face_plane", face_plane), ("bounds", bounds), ("rays", rays)):
        if x.device != rays.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {rays.device}")
    n = rays.shape[1]
    num_clusters = bounds.shape[1]
    if rays.dim() != 2 or rays.shape[0] != 7 or n == 0:
        raise ValueError(f"rays must be [7, N] with N > 0, got {tuple(rays.shape)}")
    if face_plane.dim() != 2 or face_plane.shape[0] < 13 or bounds.shape[0] != 6 \
            or face_plane.shape[1] < num_clusters * CLUSTER_SIZE:
        raise ValueError(f"face_plane {tuple(face_plane.shape)} and bounds "
                         f"{tuple(bounds.shape)} do not describe {CLUSTER_SIZE}-face clusters")
    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=rays.device)
    visits = torch.empty(n, dtype=torch.int32, device=rays.device) if with_visits else None

    from .._build import library

    err = library().mesh_hit(
        rays.data_ptr(), face_plane.data_ptr(), bounds.data_ptr(), out.data_ptr(),
        visits.data_ptr() if visits is not None else None, n, face_plane.shape[1],
        num_clusters, torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mesh kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, visits
