"""The mesh kernel's CUDA source, compiled for the host, against its plain
version.

The CUDA kernel has no CPU mode. This test compiles csrc/mesh_hit.cu with
the host C++ compiler instead, under the warp stand-in of
tests/test_torch_k5_host.py: the _rn intrinsics as plain IEEE operations,
float4 loads, and each warp as 32 lanes on their own stacks that meet at
each warp-wide call (ballot, shuffle, minimum, sum), so a collective that
not every lane reaches fails the launch (code 99) instead of hanging. So
the kernel's own code runs: each ray's walk over ``cluster_tree`` (the
near-child-first order, the stack and its pruning against the running
best), the warp's tests of the clusters its rays hold from
``face_gather``, the tie rule, and the winner's face tested once more for
its u and v. Built with -ffp-contract=off, it must equal the plain PyTorch
version (ops/mesh_hit.py) bit for bit on all 8 output rows:

- cornellShip and shipTexOnly, 700 rays, a fifth of them dead lanes
  (the padding convention) at random;
- a ragged batch (237 rays: the last warp 13 lanes in the batch, 19
  past it) whose warps have dead lanes in their middle;
- rays aimed at vertices that faces of two clusters share, a batch with
  exact-t ties between faces in different clusters (found by testing every
  face of each ray, and asserted), so the rule that the lower face id wins
  among equal t decides the result. Such rays also meet faces whose t
  rounds below their own cluster's box entry: the rays on which a cluster
  the plain walk prunes holds a face that beats its result (the one case in
  which the two walks may differ, csrc/mesh.cuh) are found by testing every
  face and set apart; on them the kernel may differ only on lanes that
  ops/mesh_hit.py::box_rounding_lanes proves to be that case.

Visit counts are not compared with the plain version's: the kernel's walk
goes near to far, the plain one in ascending cluster id, so either may
test a cluster the other prunes. Per ray the kernel's visits lie between
the clusters whose box the ray enters below its final t (any correct walk
tests them) and those it enters below t_cap. The card itself is checked by
chip_smoke.py and tests/test_torch_mesh_cuda.py.
"""

import re
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import (CLUSTER_SIZE, _plane_form,
                                                          build_cluster_tree, build_device_scene,
                                                          build_face_gather)
from test_torch_k5_host import REPO, _host_build
from test_torch_mesh_tiers import ship_rays

# The launch: every warp of every block in turn, as 32 lanes (host_run_warp).
LAUNCH = re.compile(
    r"kernel<<<blocks, threads, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);", re.S)
LOOP = (r"(void)stream; blockDim.x = threads; bool host_broken = false;"
        r" for (int b_ = 0; b_ < blocks; ++b_) for (int w_ = 0; w_ < threads / 32; ++w_) {"
        r" blockIdx.x = b_; host_broken |= host_run_warp([&] { kernel(\1); }, w_ * 32); }"
        r" if (host_broken) return 99;")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "mesh_hit.cu", LAUNCH, LOOP, "meshhost")
    lib.mesh_hit.restype, lib.mesh_hit.argtypes = _build.SIGNATURES["mesh_hit"]
    return lib


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        _SCENES[name] = build_device_scene(load_scene(str(REPO / f"scenes/{name}.txt")), 128,
                                           device="cpu")
    return _SCENES[name]


def _host_mesh_hit(lib, dev, rays, threads=mh.THREADS):
    """The host build on ``rays``: (out [8, N], visits [N], stats [3])."""
    n = rays.shape[1]
    out = torch.full((mh.OUT_ROWS, n), float("nan"))
    visits = torch.full((n,), -1, dtype=torch.int32)
    stats = torch.zeros(mh.STATS, dtype=torch.int64)
    C = dev.cluster_bounds.shape[1]
    err = lib.mesh_hit(rays.data_ptr(), dev.face_gather.data_ptr(), dev.cluster_tree.data_ptr(),
                       out.data_ptr(), visits.data_ptr(), stats.data_ptr(), n, C,
                       mh.tree_depth(C), threads, None)
    assert err == 0
    return out, visits, stats


def _rays(meta, o_np, d_np, dead):
    """[7, N] rays with t_cap from the primitives; ``dead`` lanes take the
    padding convention (origin 1e7, +x, t_cap 0)."""
    o = trace.Vec3(*(torch.from_numpy(o_np[:, i].copy()) for i in range(3)))
    d = trace.Vec3(*(torch.from_numpy(d_np[:, i].copy()) for i in range(3)))
    t_cap = trace.intersect_primitives_soa(meta, o, d).t
    dead = torch.from_numpy(dead)
    return torch.stack([torch.where(dead, 1e7, o.x), torch.where(dead, 1e7, o.y),
                        torch.where(dead, 1e7, o.z), torch.where(dead, 1.0, d.x),
                        torch.where(dead, 0.0, d.y), torch.where(dead, 0.0, d.z),
                        torch.where(dead, 0.0, t_cap)]).contiguous()


def _all_faces(dev, meta, rays):
    """Every face of every ray with the plain arithmetic: t [N, F], inf
    where the face is not hit below t_cap."""
    f = dev.face_plane[:, :meta.num_faces]
    ro, rd = rays[0:3, :, None], rays[3:6, :, None]
    t = (f[3] - mh._dot(ro, f[0:3])) / mh._clamp_eps(mh._dot(rd, f[0:3]))
    u = mh._dot(ro, f[4:7]) + t * mh._dot(rd, f[4:7]) - f[7]
    v = mh._dot(ro, f[8:11]) + t * mh._dot(rd, f[8:11]) - f[11]
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > mh.HIT_EPS) & (t < rays[6, :, None])
    return torch.where(ok, t, torch.inf)


def _tie_rays(dev, meta, n=320, seed=4):
    """Rays from random points around the ship aimed at vertices that faces
    of two clusters share."""
    F = meta.num_faces
    v0 = dev.face_v0[:F].numpy()
    verts = np.concatenate([v0, v0 + dev.face_e1[:F].numpy(), v0 + dev.face_e2[:F].numpy()])
    clusters = defaultdict(set)
    for vert, c in zip(map(tuple, verts), np.tile(np.arange(F) // CLUSTER_SIZE, 3)):
        clusters[vert].add(c)
    shared = np.array([v for v, cs in clusters.items() if len(cs) > 1], np.float32)
    rng = np.random.default_rng(seed)
    target = shared[rng.integers(0, len(shared), n)]
    o = (target + 3.0 * rng.normal(size=(n, 3))).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _pruned_beats(dev, meta, rays):
    """Per ray (bool [N]): a face in a cluster the plain walk prunes beats
    its result (a lower t, or the same t and a lower face id): the box
    rounding case (csrc/mesh.cuh), in which a walk in another order may
    find another winner. Also the plain result and the rays' least t over
    every face."""
    t = _all_faces(dev, meta, rays)
    visited = torch.zeros((dev.cluster_bounds.shape[1], rays.shape[1]), dtype=torch.bool)
    out_p, _ = mh.mesh_hit_reference(dev.face_plane, dev.cluster_bounds, rays, visited=visited)
    pruned = ~visited.repeat_interleave(CLUSTER_SIZE, dim=0)[:meta.num_faces].T
    best = t.min(dim=1).values
    fid = torch.arange(meta.num_faces)[None, :]
    beats = (t < mh.final_t(out_p, rays)[:, None]) | (
        (t == out_p[0, :, None]) & (fid < out_p[7, :, None]))
    return (pruned & beats & torch.isfinite(t)).any(dim=1), t, best


def _batch(case):
    """(scene name, rays [7, N]) of one case."""
    if case in ("cornellShip", "shipTexOnly"):
        dev, meta = _scene(case)
        o, d = ship_rays(n=700, seed=11)
        return case, _rays(meta, o, d, np.random.default_rng(11).random(700) < 0.2)
    if case == "ragged":
        dev, meta = _scene("cornellShip")
        o, d = ship_rays(n=237, seed=12)
        dead = (np.arange(237) % 32 >= 10) & (np.arange(237) % 32 < 15)
        return "cornellShip", _rays(meta, o, d, dead)
    dev, meta = _scene("cornellShip")
    o, d = _tie_rays(dev, meta)
    return "cornellShip", _rays(meta, o, d, np.zeros(len(o), bool))


@pytest.mark.parametrize("case", ["cornellShip", "shipTexOnly", "ragged", "ties"])
def test_host_build_of_mesh_kernel_matches_plain(case, host_kernel):
    name, rays = _batch(case)
    dev, meta = _scene(name)
    if case == "ties":
        # Rays aimed at vertices on cluster boundaries meet faces whose t
        # rounds below their own box's entry: those rays go to
        # test_host_build_differs_only_by_box_rounding, the rest make the batch.
        rounding, t, best = _pruned_beats(dev, meta, rays)
        rays, t, best = rays[:, ~rounding].contiguous(), t[~rounding], best[~rounding]
    out_h, visits_h, stats = _host_mesh_hit(host_kernel, dev, rays)
    out_p, _ = mh.mesh_hit_reference(dev.face_plane, dev.cluster_bounds, rays)
    assert torch.equal(out_h.view(torch.int32), out_p.view(torch.int32))  # bit for bit
    live = rays[6] > 0
    assert int((out_p[4] >= 0).sum()) > rays.shape[1] // 10 and int(visits_h[~live].sum()) == 0
    # The visit bounds: any correct walk's visits, and the clusters below t_cap.
    necessary = mh.clusters_reached(dev.cluster_bounds, rays, mh.final_t(out_p, rays))
    reachable = mh.clusters_reached(dev.cluster_bounds, rays, rays[6])
    assert (necessary <= visits_h).all() and (visits_h <= reachable).all()
    nodes, walk_iters, leaf_rounds = stats.tolist()
    assert nodes >= int(visits_h.sum()) > 0 and walk_iters == nodes  # host lanes walk apart
    assert 0 < leaf_rounds <= int(visits_h.sum())
    if case == "ties":
        at_best = (t == best[:, None]) & torch.isfinite(best)[:, None]
        first = at_best.float().argmax(dim=1)
        last = at_best.shape[1] - 1 - at_best.flip(1).float().argmax(dim=1)
        ties = at_best.any(dim=1) & (first // CLUSTER_SIZE != last // CLUSTER_SIZE)
        print(f"{int(ties.sum())} of {rays.shape[1]} rays tie at their nearest t across clusters")
        assert int(ties.sum()) >= 1
        assert torch.equal(out_p[0], torch.where(out_p[4] >= 0, best, torch.inf))
        assert torch.equal(out_p[7, ties], first[ties].float())  # the lowest face id won


def test_host_build_differs_only_by_box_rounding(host_kernel):
    """The vertex-aimed rays on which a cluster the plain walk prunes holds
    a face that beats its result: the kernel equals the plain version
    there too, but on lanes where it found such a face, and each of those
    is proven to be that case (ops/mesh_hit.py::box_rounding_lanes)."""
    name, rays = _batch("ties")
    dev, meta = _scene(name)
    rounding, _, _ = _pruned_beats(dev, meta, rays)
    rays = rays[:, rounding].contiguous()
    assert rays.shape[1] >= 1
    out_h, _, _ = _host_mesh_hit(host_kernel, dev, rays)
    out_p, _ = mh.mesh_hit_reference(dev.face_plane, dev.cluster_bounds, rays)
    differ = (out_h.view(torch.int32) != out_p.view(torch.int32)).any(dim=0)
    proven = mh.box_rounding_lanes(dev.face_plane, dev.cluster_bounds, rays, out_h, out_p)
    print(f"{rays.shape[1]} rays with a pruned better face; {int(differ.sum())} differ, "
          f"{int(proven.sum())} proven box rounding")
    assert torch.equal(differ, proven)


@pytest.mark.parametrize("threads", [32, 128, 256])
def test_host_build_block_sizes(threads, host_kernel):
    name, rays = _batch("ragged")
    dev, _ = _scene(name)
    want = _host_mesh_hit(host_kernel, dev, rays)
    got = _host_mesh_hit(host_kernel, dev, rays, threads)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("threads", [0, 48, 512])
def test_host_build_refuses_block_sizes(threads, host_kernel):
    dev, _ = _scene("cornellShip")
    rays = _batch("ragged")[1]
    out = torch.zeros((mh.OUT_ROWS, rays.shape[1]))
    C = dev.cluster_bounds.shape[1]
    err = host_kernel.mesh_hit(rays.data_ptr(), dev.face_gather.data_ptr(),
                               dev.cluster_tree.data_ptr(), out.data_ptr(), None, None,
                               rays.shape[1], C, mh.tree_depth(C), threads, None)
    assert err != 0 and not out.any()


def test_box_rounding_lanes_proves_only_that_case():
    """The check chip_smoke.py runs on lanes that differ: a plain walk over
    boxes that lie beyond some winners' faces (as a rounded box entry can)
    misses those faces, and the true result then differs from it in the
    one allowed way on exactly those lanes; another face id is no proof."""
    dev, meta = _scene("cornellShip")
    o, d = ship_rays(n=400, seed=13)
    rays = _rays(meta, o, d, np.zeros(400, bool))
    out_k, _ = mh.mesh_hit_reference(dev.face_plane, dev.cluster_bounds, rays)
    c = int(torch.mode(out_k[7, out_k[4] >= 0].long() // CLUSTER_SIZE).values)
    far = dev.cluster_bounds.clone()
    far[0:3, c] += 50.0  # cluster c's box, moved out of the room
    far[3:6, c] += 50.0
    out_p, _ = mh.mesh_hit_reference(dev.face_plane, far, rays)
    moved = (out_k[4] >= 0) & (out_k[7].long() // CLUSTER_SIZE == c)
    assert int(moved.sum()) > 0
    proven = mh.box_rounding_lanes(dev.face_plane, far, rays, out_k, out_p)
    assert torch.equal(proven, moved & (mh.final_t(out_k, rays) < mh.final_t(out_p, rays)))
    assert int(proven.sum()) > 0
    wrong = out_k.clone()
    wrong[7, moved] = (wrong[7, moved] + 1) % meta.num_faces
    assert not mh.box_rounding_lanes(dev.face_plane, far, rays, wrong, out_p)[moved].any()
    assert not mh.box_rounding_lanes(dev.face_plane, dev.cluster_bounds, rays, out_k, out_k).any()


def test_host_build_tie_at_a_box_entry(host_kernel):
    """Two clusters of 128 copies of one triangle in the plane z = 1: the
    first cluster's box starts at z = 1, the second's before it. Rays up
    from z = 0 meet every face at t = 1 exactly and enter the second box
    first, so the walk finds face 128 first; the first box's entry t equals
    that best, and only the rule that a box at the best t still passes and
    the lower face id wins gives the plain version's face 0."""
    v0 = np.tile(np.float32([0.0, 0.0, 1.0]), (256, 1))
    e1 = np.tile(np.float32([1.0, 0.0, 0.0]), (256, 1))
    e2 = np.tile(np.float32([0.0, 1.0, 0.0]), (256, 1))
    face_plane = _plane_form(v0, e1, e2, np.full(256, 3), 256)
    cmin, cmax = np.float32([[0, 0, 1], [0, 0, 0.5]]), np.float32([[1, 1, 2], [1, 1, 1]])
    dev = SimpleNamespace(face_plane=torch.from_numpy(face_plane),
                          cluster_bounds=torch.from_numpy(np.concatenate([cmin.T, cmax.T])),
                          face_gather=torch.from_numpy(np.ascontiguousarray(
                              build_face_gather(face_plane))),
                          cluster_tree=torch.from_numpy(build_cluster_tree(cmin, cmax)))
    xy = np.random.default_rng(6).uniform(0.05, 0.45, size=(2, 45)).astype(np.float32)
    rays = torch.from_numpy(np.stack([xy[0], xy[1], np.zeros(45, np.float32),
                                      *np.zeros((2, 45), np.float32), np.ones(45, np.float32),
                                      np.full(45, np.inf, np.float32)]))
    out_h, visits_h, _ = _host_mesh_hit(host_kernel, dev, rays)
    out_p, _ = mh.mesh_hit_reference(dev.face_plane, dev.cluster_bounds, rays)
    assert torch.equal(out_h.view(torch.int32), out_p.view(torch.int32))
    assert (out_p[0] == 1.0).all() and (out_p[7] == 0.0).all() and (visits_h == 2).all()
