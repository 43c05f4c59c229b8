"""The mesh tiers' CUDA kernel on the card against its plain version.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py
Without a CUDA device every case skips: the kernel has no CPU mode.

- The kernel's raw outputs equal the plain version's bit for bit on the
  same CUDA tensors: the kernel rounds every operation as PyTorch's
  one-op-at-a-time arithmetic does, and the lowest face id wins among
  equal t in both (csrc/mesh_hit.cu). Its visits lie between the clusters
  whose box a ray enters below its final t and those it enters below t_cap
  (the kernel walks near to far, the plain version in ascending id); the
  counting build gives the timed build's outputs, and so does every block
  size the launch takes.
- The mesh query under each winner table (oct, f32) through
  ``intersect_soa`` on the card, once with the kernel and once with the plain version in its place
  on the same CUDA tensors: every field of the hit equal. (Against the CPU
  the primitives' t already differs in the last place: PyTorch's CUDA
  rsqrt is not the CPU's 1/sqrt.)
"""

import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 3000
EXACT = ("t", "hit", "is_obj", "material_id", "kd", "ks", "ke", "bump")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh kernel has no CPU mode")


def _rays(n, seed, center):
    """Origins on a shell of radius 8 around ``center``, aimed near it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (np.float32(center) + 8.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = (np.float32(center) + rng.normal(size=(n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _vec(a, device):
    return Vec3(*(torch.from_numpy(a[:, i].copy()).to(device) for i in range(3)))


SCENES = {"cornellShip": (1.0, 3.0, 3.0), "shipTexOnly": (1.5, 2.8, 3.0)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("scene", list(SCENES))
def test_kernel_equals_plain_bit_for_bit(scene):
    _need_cuda()
    dev, meta = build_device_scene(load_scene(str(REPO / f"scenes/{scene}.txt")), device="cuda")
    o, d = _rays(N, 1, SCENES[scene])
    t_cap = trace.intersect_primitives_soa(meta, _vec(o, "cuda"), _vec(d, "cuda")).t
    dead = torch.from_numpy(np.random.default_rng(2).random(N) < 0.2).cuda()
    rays = torch.cat([torch.where(dead, 1e7, _vec(o, "cuda").x)[None],
                      torch.where(dead, 1e7, _vec(o, "cuda").y)[None],
                      torch.where(dead, 1e7, _vec(o, "cuda").z)[None],
                      torch.where(dead, 1.0, _vec(d, "cuda").x)[None],
                      torch.where(dead, 0.0, _vec(d, "cuda").y)[None],
                      torch.where(dead, 0.0, _vec(d, "cuda").z)[None],
                      torch.where(dead, 0.0, t_cap)[None]]).contiguous()
    walk = dict(face_gather=dev.face_gather, tree=dev.cluster_tree)
    before = mh.LAUNCHES
    stats = torch.zeros(mh.STATS, dtype=torch.int64, device="cuda")
    out_k, visits_k = mh.mesh_hit(dev.face_plane, dev.cluster_bounds, rays, with_visits=True,
                                  stats=stats, **walk)
    torch.cuda.synchronize()
    assert mh.LAUNCHES == before + 1
    out_p, _ = mh.mesh_hit_reference(dev.face_plane, dev.cluster_bounds, rays)
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
    necessary = mh.clusters_reached(dev.cluster_bounds, rays, mh.final_t(out_p, rays))
    reachable = mh.clusters_reached(dev.cluster_bounds, rays, rays[6])
    assert (necessary <= visits_k).all() and (visits_k <= reachable).all()
    assert int((out_k[4] >= 0).sum()) > N // 10 and int(visits_k[dead].sum()) == 0
    nodes, walk_iters, leaf_rounds = stats.tolist()
    assert nodes >= int(visits_k.sum()) > 0 and 0 < walk_iters <= nodes
    assert 0 < leaf_rounds <= int(visits_k.sum())
    for threads in (32, 64, 128, 256):
        out, _ = mh.mesh_hit(dev.face_plane, dev.cluster_bounds, rays, threads=threads, **walk)
        assert torch.equal(out.view(torch.int32), out_k.view(torch.int32)), threads


@pytest.mark.requires_cuda
@pytest.mark.parametrize("table", ["oct", "f32"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_tier_on_card_matches_plain_tier(scene, table, monkeypatch):
    _need_cuda()
    dev, meta = build_device_scene(load_scene(str(REPO / f"scenes/{scene}.txt")), device="cuda")
    o, d = _vec(_rays(N, 3, SCENES[scene])[0], "cuda"), _vec(_rays(N, 3, SCENES[scene])[1], "cuda")
    kw = dict(mesh_pallas=True, mesh_sort="need", winner_table=table)
    before = mh.LAUNCHES
    hk = trace.intersect_soa(meta, dev, o, d, **kw)
    torch.cuda.synchronize()
    assert mh.LAUNCHES == before + 1
    monkeypatch.setattr(trace, "mesh_hit", lambda fp, bounds, rays, with_visits=False, **walk:
                        mh.mesh_hit_reference(fp, bounds, rays, with_visits))
    hp = trace.intersect_soa(meta, dev, o, d, **kw)
    assert mh.LAUNCHES == before + 1
    for name in EXACT + ("u", "v"):
        assert torch.equal(getattr(hk, name), getattr(hp, name)), name
    for a, b in zip(hk.normal, hp.normal):
        assert torch.equal(a, b)
    assert int(hp.is_obj.sum()) > N // 10
