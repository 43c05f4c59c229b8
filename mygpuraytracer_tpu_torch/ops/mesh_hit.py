"""The mesh tiers' nearest-face query: one CUDA kernel for K2, K3 and K4.

The port of the function that ``mygpuraytracer_tpu/ops/trace.py``'s three
Pallas mesh tiers compute (``mesh_rows_hit``, ``mesh_list_hit``,
``mesh_pallas_hit``): for each ray, the nearest face of the clustered mesh
with HIT_EPS < t < t_cap. Source: ``csrc/mesh_hit.cu``, which walks the
cluster tree per ray (``dev.cluster_tree``) and tests the leaves with the
whole warp from ``dev.face_gather``; the plain version walks the plane-form
faces ``face_plane`` [16, Fp] cluster by cluster over their AABBs [6, C].

Rays come as one [7, N] float32 tensor (origin xyz, direction xyz, t_cap).
The result is one [8, N] float32 tensor: t (inf where no face beats t_cap),
the winner's face normal xyz (unnormalized), geom id (-1: none), its
barycentric u and v, and its face id (0 where none); and, on request, the
number of clusters each ray tested (int32 [N]). Among faces at equal t the
lowest face id wins. A ray with t_cap 0 (the padding convention: far
origin, +x direction) tests none.

``mesh_hit`` launches the kernel for CUDA tensors and counts its launches
in ``LAUNCHES`` and on the device (``_build.count_on_device``, which a CUDA
graph's replays move too); for CPU tensors it runs the plain version,
``mesh_hit_reference``, which the kernel equals bit for bit. The kernel and
the plain version visit clusters in different orders, so their visit
counts differ; both lie between two bounds that :func:`clusters_reached`
counts: the clusters whose box the ray enters below its final t (every
correct walk tests them) and those it enters below t_cap.
"""

from __future__ import annotations

import torch

from ..scene.device_scene import CLUSTER_SIZE

HIT_EPS = 1e-4
DIR_EPS = 1e-20
OUT_ROWS = 8  # t, fn xyz, geom, u, v, face id
# The counting build's counters (csrc/mesh.cuh WalkCount): interior nodes
# visited, warp traversal iterations, warp leaf rounds.
STATS = 3
THREADS = 256  # block size (csrc/mesh_hit.cu takes 32 to 256; the fastest on an H100)
MAX_TREE_DEPTH = 32  # the walk's per-thread stack (csrc/mesh.cuh MAX_STACK)

LAUNCHES = 0  # kernel launches from the host since the last reset (a graph capture records one)


def tree_depth(num_clusters: int) -> int:
    """Levels below the root of ``build_cluster_tree``'s tree, leaves
    included: ceil(log2 C), the most entries the walk's stack holds."""
    return (num_clusters - 1).bit_length()


def _clamp_eps(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < DIR_EPS, DIR_EPS, x)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _slab(bounds: torch.Tensor, o: torch.Tensor, inv: torch.Tensor):
    """Slab test of the boxes ``bounds`` [6, C] for rays o, inv [3, N, 1]:
    (passes bool [N, C], entry t [N, C]), with csrc/mesh.cuh's arithmetic."""
    t1 = (bounds[0:3, None, :] - o) * inv
    t2 = (bounds[3:6, None, :] - o) * inv
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tout = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return tout >= tin.clamp_min(0.0), tin


def mesh_hit_reference(face_plane: torch.Tensor, bounds: torch.Tensor, rays: torch.Tensor,
                       with_visits: bool = False, visited: torch.Tensor | None = None):
    """Plain version of the kernel: clusters in ascending id; per cluster,
    the rays whose slab test passes against their running best test its 128
    faces; the first minimum wins and replaces the best if strictly less.
    ``visited`` (bool [C, N]), if given, marks each cluster a ray tested."""
    n = rays.shape[1]
    o, d, best = rays[0:3], rays[3:6], rays[6].clone()
    inv = 1.0 / _clamp_eps(d)
    out = torch.zeros((OUT_ROWS, n), dtype=torch.float32, device=rays.device)
    out[4] = -1.0
    visits = torch.zeros(n, dtype=torch.int32, device=rays.device)
    for c in range(bounds.shape[1]):
        passes, tin = _slab(bounds[:, c:c + 1], o[:, :, None], inv[:, :, None])
        idx = (passes[:, 0] & (tin[:, 0] < best)).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        visits[idx] += 1
        if visited is not None:
            visited[c, idx] = True
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


def clusters_reached(bounds: torch.Tensor, rays: torch.Tensor, t_limit: torch.Tensor,
                     chunk: int = 16384) -> torch.Tensor:
    """Per ray, the clusters whose slab test passes with an entry t below
    ``t_limit`` [N] (int32 [N]), in chunks of ``chunk`` rays. Below the
    ray's final t (the result's t, or t_cap where no face won): the visits
    any correct walk makes. Below t_cap: the most the kernel's walk makes."""
    counts = []
    for s in range(0, rays.shape[1], chunk):
        r = rays[:, s:s + chunk]
        passes, tin = _slab(bounds, r[0:3, :, None], 1.0 / _clamp_eps(r[3:6, :, None]))
        counts.append((passes & (tin < t_limit[s:s + chunk, None])).sum(dim=1, dtype=torch.int32))
    return torch.cat(counts) if counts else torch.zeros(0, dtype=torch.int32, device=rays.device)


def final_t(out: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """The ray's final t: the winner's, or t_cap where no face won."""
    return torch.where(out[4] >= 0.0, out[0], rays[6])


def box_rounding_lanes(face_plane: torch.Tensor, bounds: torch.Tensor, rays: torch.Tensor,
                       out_k: torch.Tensor, out_p: torch.Tensor) -> torch.Tensor:
    """The lanes (bool [N]) on which the kernel's result ``out_k`` differs
    from the plain one ``out_p`` in the one way the two walks may differ:
    the kernel's winning face, tested alone with the plain arithmetic, gives
    the kernel's t, bit for bit, below the plain t, and its cluster is one
    the plain walk did not test (its box entered at or above the plain
    walk's running best: the face's t rounds below its own box entry)."""
    lanes = (out_k.view(torch.int32) != out_p.view(torch.int32)).any(dim=0).nonzero().squeeze(1)
    proven = torch.zeros(rays.shape[1], dtype=torch.bool, device=rays.device)
    if lanes.numel() == 0:
        return proven
    r = rays[:, lanes]
    fid = out_k[7, lanes].to(torch.int64)
    f = face_plane[:, fid]  # [16, k]
    o, d = r[0:3], r[3:6]
    t = (f[3] - _dot(o, f[0:3])) / _clamp_eps(_dot(d, f[0:3]))
    u = _dot(o, f[4:7]) + t * _dot(d, f[4:7]) - f[7]
    v = _dot(o, f[8:11]) + t * _dot(d, f[8:11]) - f[11]
    face_ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > HIT_EPS)
    visited = torch.zeros((bounds.shape[1], lanes.numel()), dtype=torch.bool, device=rays.device)
    mesh_hit_reference(face_plane, bounds, r.contiguous(), visited=visited)
    cluster = fid // CLUSTER_SIZE
    untested = ~visited.gather(0, cluster[None]).squeeze(0)
    plain_t = final_t(out_p[:, lanes], r)
    proven[lanes] = (face_ok & (out_k[4, lanes] >= 0.0) & (t == out_k[0, lanes])
                     & (t < plain_t) & untested)
    return proven


def mesh_hit(face_plane: torch.Tensor, bounds: torch.Tensor, rays: torch.Tensor,
             with_visits: bool = False, face_gather: torch.Tensor | None = None,
             tree: torch.Tensor | None = None, stats: torch.Tensor | None = None,
             threads: int = THREADS):
    """Nearest face per ray: ``(out [8, N], visits [N] or None)``. For CUDA
    tensors, one launch of the kernel on the current stream over
    ``face_gather`` [C, 4, 128, 4] and ``tree`` [C - 1, 16] (the scene's
    ``face_gather`` and ``cluster_tree``; ``bounds`` [6, C] gives C), in
    blocks of ``threads``; ``with_visits`` or ``stats`` (int64 [STATS],
    added into) launches the counting build. For CPU tensors, the plain
    version over ``face_plane`` and ``bounds``."""
    global LAUNCHES
    if rays.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats are the kernel's counters; the plain version has none")
        return mesh_hit_reference(face_plane, bounds, rays, with_visits)
    if rays.device.type != "cuda":
        raise ValueError(f"the mesh kernel runs on CUDA or (plain) CPU tensors, not {rays.device}")
    if face_gather is None or tree is None:
        raise ValueError("the mesh kernel needs the scene's face_gather and cluster_tree")
    n = rays.shape[1]
    num_clusters = bounds.shape[1]
    depth = tree_depth(num_clusters)
    if rays.dim() != 2 or rays.shape[0] != 7 or n == 0:
        raise ValueError(f"rays must be [7, N] with N > 0, got {tuple(rays.shape)}")
    if num_clusters < 2 or depth > MAX_TREE_DEPTH or tuple(tree.shape) != (num_clusters - 1, 16) \
            or face_gather.shape[0] < num_clusters or tuple(face_gather.shape[1:]) != (4, 128, 4):
        raise ValueError(f"the mesh kernel takes 2 to 2^{MAX_TREE_DEPTH} clusters of "
                         f"{CLUSTER_SIZE} faces, got {num_clusters} clusters, tree "
                         f"{tuple(tree.shape)}, face_gather {tuple(face_gather.shape)}")
    for name, x in (("rays", rays), ("face_gather", face_gather), ("tree", tree)):
        if x.device != rays.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {rays.device}")
    if stats is not None and (stats.device != rays.device or stats.dtype != torch.int64
                              or tuple(stats.shape) != (STATS,) or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 [{STATS}] tensor on {rays.device}")
    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=rays.device)
    visits = torch.empty(n, dtype=torch.int32, device=rays.device) if with_visits else None

    from .._build import count_on_device, library, stream_handle

    pointer = lambda x: x.data_ptr() if x is not None else None
    err = library().mesh_hit(
        rays.data_ptr(), face_gather.data_ptr(), tree.data_ptr(), out.data_ptr(),
        pointer(visits), pointer(stats), n, num_clusters, depth, threads,
        stream_handle(rays.device))
    if err != 0:
        raise RuntimeError(f"mesh kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    count_on_device("mesh_hit", rays.device)
    return out, visits
