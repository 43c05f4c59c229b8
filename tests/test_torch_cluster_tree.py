"""The cluster walk's scene layouts (K5 and the mesh tiers' kernel): the
cluster tree and the per-cluster float4 copy of the planes.

- ``cluster_tree`` (``scene/device_scene.py::build_cluster_tree``): every
  child box a node holds is the exact float32 min/max union of the clusters
  below it, so it contains the boxes of that child's own children bit for
  bit and a leaf's box equals its cluster's ``cluster_bounds`` column; the
  leaves are the C clusters, once each, in ascending order; the depth is at
  most ceil(log2 C) + 1. The walk (csrc/mesh.cuh) prunes with these boxes,
  and a box that were not an exact union could prune a cluster the plain
  walk tests.
- ``face_gather`` [Fp / 128, 4, 128, 4]: element [c, k, j, i] is row 4k + i
  of ``face_plane`` at face c * 128 + j, bit for bit, for rows 0-12, and zero
  for the padding rows 13-15.
- Both are built for every mesh of more than 256 faces, the meshes the
  tiers and K5 walk, textured (shipTexOnly, which K5 cannot run) or not; a
  scene without such a mesh gets empty ones.

Tolerance: none (exact float32 copies and min/max).
"""

import math
import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.render import megakernel
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_cluster_tree, build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _walk(nodes: np.ndarray, i: int = 0, level: int = 1):
    """Yield (box [6], link, level) for the children of node ``i`` and of
    every node below it, left subtree before right; level 1 is the root's
    children."""
    links = nodes.view(np.int32)
    for col, link in ((0, int(links[i, 12])), (6, int(links[i, 13]))):
        yield nodes[i, col:col + 6], link, level
        if link >= 0:
            yield from _walk(nodes, link, level + 1)


def _check_tree(cmin: np.ndarray, cmax: np.ndarray):
    nodes = build_cluster_tree(cmin, cmax)
    C = len(cmin)
    assert nodes.dtype == np.float32 and nodes.shape == (max(C - 1, 0), 16)
    assert not nodes[:, 14:16].any()
    if C == 1:
        assert megakernel.tree_depth(C) == 0
        return
    bits = lambda a: a.view(np.int32)
    leaves, levels = [], []
    for box, link, level in _walk(nodes):
        levels.append(level)
        if link < 0:
            c = -1 - link
            leaves.append(c)
            assert np.array_equal(bits(box), bits(np.concatenate([cmin[c], cmax[c]])))
        else:  # an interior child: its box contains its children's, bit for bit
            for col in (0, 6):
                child = nodes[link, col:col + 6]
                assert (box[:3] <= child[:3]).all() and (box[3:] >= child[3:]).all()
            union = np.concatenate([np.minimum(nodes[link, 0:3], nodes[link, 6:9]),
                                    np.maximum(nodes[link, 3:6], nodes[link, 9:12])])
            assert np.array_equal(bits(box), bits(union))
    assert leaves == list(range(C))  # each cluster once, in Morton (index) order
    assert max(levels) == megakernel.tree_depth(C) <= math.ceil(math.log2(C)) + 1


@pytest.mark.parametrize("name", ["cornellShip", "shipOnly"])
def test_cluster_tree_of_the_scene(name):
    dev, meta = build_device_scene(load_scene(str(REPO / f"scenes/{name}.txt")), device="cpu")
    bounds = dev.cluster_bounds.numpy()
    C = bounds.shape[1]
    assert C == len(meta.mesh_clusters) > 2
    tree = dev.cluster_tree.numpy()
    want = build_cluster_tree(bounds[0:3].T.copy(), bounds[3:6].T.copy())
    assert np.array_equal(tree.view(np.int32), want.view(np.int32))
    _check_tree(bounds[0:3].T.copy(), bounds[3:6].T.copy())


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 183, 1000])
def test_cluster_tree_of_random_boxes(C):
    rs = np.random.default_rng(C)
    lo = rs.normal(size=(C, 3)).astype(np.float32)
    hi = lo + rs.random((C, 3)).astype(np.float32)
    _check_tree(lo, hi)


@pytest.mark.parametrize("name", ["cornellShip", "shipOnly", "shipTexOnly"])
def test_face_gather_is_face_plane_in_cluster_blocks(name):
    dev, _ = build_device_scene(load_scene(str(REPO / f"scenes/{name}.txt")), device="cpu")
    fp, fg = dev.face_plane, dev.face_gather
    C = fp.shape[1] // 128
    assert fg.dtype == torch.float32 and tuple(fg.shape) == (C, 4, 128, 4) and fg.is_contiguous()
    rows = fg.permute(1, 3, 0, 2).reshape(16, C * 128)  # [k, i, c, j] -> row 4k + i, face
    assert torch.equal(rows[:13].view(torch.int32), fp[:13].view(torch.int32))
    assert not rows[13:].any()
    c, k, j, i = 5, 2, 77, 3  # one element by the documented index
    assert fg[c, k, j, i].item() == fp[4 * k + i, c * 128 + j].item()


@pytest.mark.parametrize("name", ["builtin_cornell", "shipTexOnly"])
def test_k5_layouts_are_empty_where_k5_cannot_run(name):
    # K5 cannot run either scene: one has no mesh, the other textures. The
    # layouts are empty only without a mesh of more than 256 faces; the
    # textured ship has them, for the mesh tiers' walk.
    dev, meta = build_device_scene(load_scene(str(REPO / f"scenes/{name}.txt")), device="cpu")
    assert meta.has_textures or meta.num_faces <= 256
    options = RenderOptions(megakernel=True, bounce_megakernel=True)
    assert not (megakernel.supports_megakernel(meta, options) and megakernel._uses_bvh(meta))
    C = dev.cluster_bounds.shape[1] if meta.num_faces > 256 else 0
    assert tuple(dev.face_gather.shape) == (C, 4, 128, 4) and dev.face_gather.dtype == torch.float32
    assert tuple(dev.cluster_tree.shape) == (max(C - 1, 0), 16)
    assert dev.cluster_tree.dtype == torch.float32
    assert (C > 0) == (name == "shipTexOnly")


def test_textured_scene_gets_the_walk_layouts():
    """shipTexOnly (textured, bump-mapped): ``face_gather`` is its own
    ``face_plane`` rows 0-12 in the float4 layout, bit for bit, and the tree
    is ``build_cluster_tree`` of its ``cluster_bounds``."""
    dev, meta = build_device_scene(load_scene(str(REPO / "scenes/shipTexOnly.txt")), device="cpu")
    assert meta.has_textures and meta.num_faces > 256
    fp, fg = dev.face_plane, dev.face_gather
    C = dev.cluster_bounds.shape[1]
    assert tuple(fg.shape) == (C, 4, 128, 4) and C * 128 == fp.shape[1] and fg.is_contiguous()
    for c in (0, C // 2, C - 1):
        for k in range(4):
            for i in range(4):
                row = 4 * k + i
                want = fp[row, c * 128:(c + 1) * 128] if row < 13 else torch.zeros(128)
                assert torch.equal(fg[c, k, :, i].view(torch.int32), want.view(torch.int32))
    bounds = dev.cluster_bounds.numpy()
    want = build_cluster_tree(bounds[0:3].T.copy(), bounds[3:6].T.copy())
    assert np.array_equal(dev.cluster_tree.numpy().view(np.int32), want.view(np.int32))
