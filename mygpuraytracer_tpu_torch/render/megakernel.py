"""The whole-iteration kernels: K1 for primitive and small-mesh scenes, K5
for large untextured meshes.

K1 is the port of ``mygpuraytracer_tpu/render/megakernel.py::_make_kernel``
(the Pallas kernel that ``megakernel_accumulate`` launches). Each pixel runs
``num_iters`` iterations: AA jitter, thin-lens DoF, the bounce loop over
cubes, spheres and up to 256 listed triangles, shading, and color * pi added
into the accumulator. The albedo and normal AOVs are written at iteration 1.
Persistent lanes take pixels from a queue and start a new path as soon as
one ends. Source: ``csrc/megakernel.cu``.

K5 is the port of ``_make_bounce_kernel`` (launched by
``bvh_bounce_accumulate``), which the JAX package runs for meshes of more
than 256 faces under ``RenderOptions(megakernel=True,
bounce_megakernel=True)``. Per iteration: the raygen uniforms through
``ops/prng.py::iteration_uniforms`` (K6 under ``rng`` "pallas"/"auto" on
CUDA), the camera rays in PyTorch, then one launch that runs the whole
bounce loop, each ray walking the cluster tree (``dev.cluster_tree``) on its
own stack and the warp testing the clusters its rays reach
(``dev.face_gather``), and adds into the accumulator, with K1's AOV rule.
Source: ``csrc/bounce.cu``.

Unlike the TPU kernels, which baked each scene into their programs and drew
from the hardware PRNG, the CUDA kernels are generic programs: the scene
reaches them as a packed float record (:func:`scene_record`), and they draw
at the wavefront's counters (K1 always threefry; K5 the stream ``rng``
selects), so their images equal their plain versions'
(:func:`megakernel_accumulate_reference`,
:func:`bvh_bounce_accumulate_reference`) up to float rounding.

K5's iteration words (the iteration key, K6's seed, the iteration) go to
the kernel by value or, for an iteration counted on the device (a CUDA
graph of the Renderer's, render/graphs.py), through device memory (its
WORDS build), where a one-thread kernel launched before it derives them
from the base key and the iteration, which it reads there.

The wrappers count their launches in ``LAUNCHES`` (K1) and
``BOUNCE_LAUNCHES`` (K5), and on the device (``_build.count_on_device``,
which a CUDA graph's replays move too). For CPU tensors they run the plain versions; for
CUDA tensors they launch the kernel, on the accumulator's device, or raise.

Each takes an optional pixel range ``pixels = (p0, count)``: the
accumulator is then [9, count] and holds the image's pixels p0 .. p0 +
count - 1, which draw at their own RNG counters, so ranges that tile the
image sum to the whole launch's accumulator bit for bit (the kernels and
their plain versions alike; ``parallel/sharded.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import prng, rng
from ..ops.mesh_hit import MAX_TREE_DEPTH, tree_depth
from ..ops.trace import bvh_scene_hit_nearfar
from ..ops.vec3 import Vec3
from ..scene.device_scene import CameraParams, DeviceScene, SceneMeta
from .camera import generate_camera_rays
from .pathtrace import (SampleOutput, accumulate_sample, num_rng_streams, trace_sample,
                        wavefront_sample)

# Record layout; csrc/megakernel.cu reads the same offsets.
HEADER = 16  # [num_geoms, num_faces, camera: pos3 view3 up3 right3 pixel_length2]
GEOM_STRIDE = 48  # type, material, xform 3x4, inverse 3x4, inv_transpose 3x3, material 11
FACE_STRIDE = 16  # geom, v0 3, e1 3, e2 3, unit normal 3, pad 3

# K1's counters: warp rounds, live lane-rounds (hit and shade on a live
# path), raygen lane-rounds, warp rounds with a raygen, pixel fetches, fetch
# atomics, warp rounds after the queue ran dry (csrc/megakernel.cu).
K1_STATS = 7
# K5's counters: tree nodes, warp traversal iterations, warp bounce rounds,
# lanes of ended paths over those rounds (csrc/bounce.cu).
STATS = 4

LAUNCHES = 0  # K1 launches from the host since the last reset
BOUNCE_LAUNCHES = 0  # K5 launches from the host since the last reset (a graph capture records one)


def _uses_bvh(meta: SceneMeta) -> bool:
    """Large meshes take the cluster walk (K5); small ones stay literal (K1)."""
    small = meta.mega_faces and len(meta.mega_faces) == meta.num_faces
    return bool(meta.has_obj and not small and meta.mesh_clusters)


def supports_megakernel(meta: SceneMeta, options) -> bool:
    """Primitive scenes and meshes small enough to be listed whole in
    ``meta.mega_faces`` (K1), and, only under the ``bounce_megakernel``
    opt-in, large meshes through the cluster walk (K5); no textures, no
    first-bounce cache."""
    mesh_ok = (
        (not meta.has_obj)
        or (meta.mega_faces and len(meta.mega_faces) == meta.num_faces)
        or (options.bounce_megakernel and bool(meta.mesh_clusters))
    )
    return bool(mesh_ok and not meta.has_textures and not options.first_bounce_cache_active)


def scene_record(meta: SceneMeta, camera: CameraParams) -> torch.Tensor:
    """Pack camera, geoms (with their materials) and listed faces into the
    float32 record the kernel reads, on the camera's device."""
    G, F = meta.num_geoms, len(meta.mega_faces)
    rec = np.zeros(HEADER + GEOM_STRIDE * G + FACE_STRIDE * F, np.float32)
    rec[0], rec[1] = G, F
    cam = [camera.position, camera.view, camera.up, camera.right, camera.pixel_length]
    rec[2:16] = np.concatenate([c.detach().cpu().numpy() for c in cam])
    for i, g in enumerate(meta.geoms):
        r = rec[HEADER + GEOM_STRIDE * i:HEADER + GEOM_STRIDE * (i + 1)]
        r[0], r[1] = g.type, g.material_id
        r[2:14] = np.asarray(g.transform)[:3].reshape(-1)
        r[14:26] = np.asarray(g.inverse_transform)[:3].reshape(-1)
        r[26:35] = np.asarray(g.inv_transpose)[:3, :3].reshape(-1)
        r[35:38], r[38:41] = g.color, g.spec_color
        r[41:46] = (g.spec_exponent, g.has_reflective, g.has_refractive, g.ior, g.emittance)
    base = HEADER + GEOM_STRIDE * G
    for i, (gi, v0, e1, e2, nrm) in enumerate(meta.mega_faces):
        r = rec[base + FACE_STRIDE * i:base + FACE_STRIDE * (i + 1)]
        r[0] = gi
        r[1:13] = (*v0, *e1, *e2, *nrm)
    return torch.from_numpy(rec).to(camera.position.device)


def _pixel_range(meta: SceneMeta, pixels: tuple[int, int] | None) -> tuple[int, int, int]:
    """(n, p0, count): the image's pixel count and the range ``pixels``
    (default: the whole image), checked to lie in it."""
    n = meta.resolution[0] * meta.resolution[1]
    p0, count = (0, n) if pixels is None else (int(pixels[0]), int(pixels[1]))
    if not (0 <= p0 and 0 <= count and p0 + count <= n):
        raise ValueError(f"pixel range ({p0}, {count}) lies outside the image's {n} pixels")
    return n, p0, count


def _check_acc(acc: torch.Tensor, n: int, name: str) -> None:
    if acc.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or (plain) CPU tensors, not {acc.device}")
    if acc.dtype != torch.float32 or tuple(acc.shape) != (9, n) or not acc.is_contiguous():
        raise ValueError(f"acc must be contiguous float32 [9, {n}], got "
                         f"{acc.dtype} {tuple(acc.shape)}")


def megakernel_accumulate_reference(
    dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
    start_iteration: int, num_iters: int, base_key: rng.Key,
    pixels: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Plain version of K1: the wavefront per iteration, with threefry
    numbers whatever ``options.rng`` says (as K1 draws), accumulated into
    ``acc`` [9, count] (the pixel range; [9, N] for the whole image) in
    place."""
    _pixel_range(meta, pixels)
    options = dataclasses.replace(options, megakernel=False, rng="threefry")
    for i in range(num_iters):
        it = start_iteration + i
        accumulate_sample(acc, wavefront_sample(dev, meta, options, it, base_key,
                                                pixels=pixels), it)
    return acc


def megakernel_accumulate(
    dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
    start_iteration: int, num_iters: int, base_key: rng.Key,
    record: torch.Tensor | None = None, stats: torch.Tensor | None = None,
    threads: int = 0, blocks_per_sm: int = 0, pixels: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Accumulate ``num_iters`` iterations from ``start_iteration`` into
    ``acc`` [9, N] float32 (rows: color sum rgb, albedo rgb, normal xyz) in
    one kernel launch on the current stream; with ``pixels`` = (p0, count),
    into ``acc`` [9, count] for the image's pixels p0 .. p0 + count - 1. ``record`` is
    :func:`scene_record`, built here when not given. ``stats`` (int64
    [K1_STATS]), if given, selects the counting build and gains its
    counters. ``threads`` (32 to 256, a multiple of 32) and
    ``blocks_per_sm`` set the launch for a sweep; 0 takes the kernel's block
    size and as many blocks as the occupancy query allows."""
    global LAUNCHES
    if acc.device.type == "cpu":
        return megakernel_accumulate_reference(
            dev, meta, options, acc, start_iteration, num_iters, base_key, pixels)
    width, height = meta.resolution
    n, p0, count = _pixel_range(meta, pixels)
    _check_acc(acc, count, "K1")
    if not supports_megakernel(meta, options) or _uses_bvh(meta):
        raise ValueError("scene/options not supported by K1 (see supports_megakernel)")
    if options.dir_aov:
        raise ValueError("K1 does not compute dir_aov")
    if meta.trace_depth < 1 or num_iters < 0 or start_iteration < 1:
        raise ValueError("need trace_depth >= 1, num_iters >= 0, start_iteration >= 1")
    if num_iters == 0:
        return acc
    if record is None:
        record = scene_record(meta, dev.camera)
    G, F = meta.num_geoms, len(meta.mega_faces)
    if record.device != acc.device or record.dtype != torch.float32 or not record.is_contiguous() \
            or record.numel() != HEADER + GEOM_STRIDE * G + FACE_STRIDE * F:
        raise ValueError("record must be this scene's scene_record, a contiguous float32 tensor "
                         "on acc's device")
    if stats is not None and (stats.device != acc.device or stats.dtype != torch.int64
                              or tuple(stats.shape) != (K1_STATS,) or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 [{K1_STATS}] tensor on {acc.device}")

    from .._build import count_on_device, device_guard, library, stream_handle

    queue = torch.empty(1, dtype=torch.int32, device=acc.device)  # zeroed by the launch
    dof = bool(options.depth_of_field and options.lens_radius > 0)
    with device_guard(acc.device):
        err = library().k1_accumulate(
            record.data_ptr(), acc.data_ptr(), queue.data_ptr(),
            stats.data_ptr() if stats is not None else None, G, F, n, p0, count, width, height,
            meta.trace_depth, int(start_iteration), int(num_iters), base_key[0], base_key[1],
            int(bool(options.antialiasing)), int(dof),
            float(options.lens_radius), float(options.focal_distance), int(threads),
            int(blocks_per_sm), stream_handle(acc.device),
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    LAUNCHES += 1
    count_on_device("k1", acc.device)
    return acc


def bvh_bounce_accumulate_reference(
    dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
    start_iteration: int, num_iters: int, base_key: rng.Key,
    pixels: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Plain version of K5: the wavefront per iteration, accumulated into
    ``acc`` [9, count] (the pixel range; [9, N] for the whole image) in
    place. Its numbers are the plain versions of the
    stream K5 draws (``prng.uniforms_mode`` of ``options.rng`` and
    ``acc``'s device), and its scene query is
    ``ops/trace.py::bvh_scene_hit_nearfar`` (``mesh_hit_reference``) over
    ``face_plane`` (the TPU kernel walked a sublane-shifted copy,
    ``face_shift``, which the port does not build)."""
    n, p0, count = _pixel_range(meta, pixels)
    k = num_rng_streams(meta.trace_depth)
    mode = prng.uniforms_mode(options, acc.device)
    fp, bounds = dev.face_plane, dev.cluster_bounds
    everyone = torch.ones(count, dtype=torch.bool, device=acc.device)
    query = lambda o, d, active=None: bvh_scene_hit_nearfar(
        meta, fp, o, d, everyone if active is None else active, bounds)
    for i in range(num_iters):
        it = start_iteration + i
        ikey = rng.iteration_key(base_key, it)
        U = (prng.uniforms_reference(rng.randint(ikey), k, count, acc.device, col0=p0)
             if mode == "pallas" else rng.uniform_columns(ikey, k, n, p0, count, acc.device))
        accumulate_sample(acc, trace_sample(dev, meta, options, it, U, query, p0=p0), it)
    return acc


def bvh_bounce_accumulate(
    dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
    start_iteration, num_iters: int, base_key: rng.Key,
    record: torch.Tensor | None = None, visits: torch.Tensor | None = None,
    pixels: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Accumulate ``num_iters`` iterations from ``start_iteration`` into
    ``acc`` [9, N] float32 (rows: color sum rgb, albedo rgb, normal xyz):
    per iteration, the raygen uniforms (``prng.sample_uniforms``, 4 rows), the
    camera rays, then one K5 launch (:func:`bounce_launch`). ``record`` is
    :func:`scene_record`, built here when not given. ``visits`` (int32 [N]),
    if given, gains the clusters each ray tested. With ``pixels`` = (p0,
    count), ``acc`` is [9, count] (and ``visits`` [count]) for the image's
    pixels p0 .. p0 + count - 1.

    ``start_iteration`` is an int, or a 0-dim int64 tensor on ``acc``'s
    device that counts the iterations on the device (the capture route,
    render/graphs.py): K6 and K5 then derive each iteration's words from
    ``base_key`` and the iteration, which they read from device memory, so
    that no launch holds a host value of the iteration."""
    if acc.device.type == "cpu":
        return bvh_bounce_accumulate_reference(
            dev, meta, options, acc, start_iteration, num_iters, base_key, pixels)
    counted = isinstance(start_iteration, torch.Tensor)
    if num_iters < 0 or (not counted and start_iteration < 1):
        raise ValueError("need num_iters >= 0, start_iteration >= 1")
    if counted and (pixels is not None or visits is not None):
        raise ValueError("an iteration counted on the device takes the whole image, no visits")
    if record is None:
        record = scene_record(meta, dev.camera)
    n, p0, _ = _pixel_range(meta, pixels)
    for i in range(num_iters):
        it = start_iteration + i if i else start_iteration
        U = prng.sample_uniforms(options, base_key, it, 4, n, acc.device, pixels)
        o, d = generate_camera_rays(dev.camera, meta.resolution, options, U, p0=p0)
        rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])
        if counted:
            bounce_launch(dev, meta, options, acc, rays, it, None, record, base_key=base_key)
        else:
            bounce_launch(dev, meta, options, acc, rays, it, rng.iteration_key(base_key, it),
                          record, visits, p0=p0)
    return acc


def bounce_launch(dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
                  rays: torch.Tensor, iteration, ikey: rng.Key | None,
                  record: torch.Tensor, visits: torch.Tensor | None = None,
                  stats: torch.Tensor | None = None, p0: int = 0,
                  base_key: rng.Key | None = None) -> torch.Tensor:
    """One K5 launch on the current stream: iteration ``iteration``'s bounce
    loop from the camera rays ``rays`` [6, count] (origin xyz, direction
    xyz) of the image's pixels p0 .. p0 + count - 1 (the whole image: p0 =
    0, count = N) under the iteration key ``ikey``, added into ``acc`` [9,
    count] (CUDA tensors only). ``visits`` (int32 [count]) gains the
    clusters each ray tested; ``stats`` (int64 [STATS]) gains the tree nodes
    the rays visited, the warp traversal iterations, the warp bounce rounds
    and the lanes of ended paths over those rounds. An iteration counted on
    the device (``iteration`` a 0-dim int64 tensor on ``acc``'s device)
    takes ``base_key`` instead of ``ikey``: a one-thread kernel before K5
    reads the iteration from device memory and derives its key and K6's
    seed from ``base_key``, and K5 reads them there (the whole image, no
    counters)."""
    global BOUNCE_LAUNCHES
    if acc.device.type != "cuda":
        raise ValueError("bounce_launch takes CUDA tensors; bvh_bounce_accumulate runs K5's "
                         f"plain version for CPU tensors, got {acc.device}")
    n, p0, count = _pixel_range(meta, (p0, rays.shape[-1]))
    _check_acc(acc, count, "K5")
    if not (supports_megakernel(meta, options) and _uses_bvh(meta)):
        raise ValueError("scene/options not supported by K5 (see supports_megakernel, _uses_bvh)")
    if options.dir_aov:
        raise ValueError("K5 does not compute dir_aov")
    counted = isinstance(iteration, torch.Tensor)
    if meta.trace_depth < 1 or (not counted and iteration < 1):
        raise ValueError("need trace_depth >= 1 and iteration >= 1")
    if counted and (iteration.device != acc.device or iteration.dtype != torch.int64
                    or iteration.dim() != 0 or base_key is None or ikey is not None
                    or p0 != 0 or count != n or visits is not None or stats is not None):
        raise ValueError("a counted iteration is a 0-dim int64 tensor on acc's device, with "
                         "base_key and no ikey, for a whole-image launch without visits or "
                         "stats")
    faces, tree = dev.face_gather, dev.cluster_tree
    num_clusters = dev.cluster_bounds.shape[1]
    depth = tree_depth(num_clusters)
    if num_clusters < 2 or depth > MAX_TREE_DEPTH or tuple(tree.shape) != (num_clusters - 1, 16) \
            or faces.shape[0] < num_clusters or tuple(faces.shape[1:]) != (4, 128, 4):
        raise ValueError(f"K5 takes 2 to 2^{MAX_TREE_DEPTH} clusters of 128 faces, got "
                         f"{num_clusters} clusters, tree {tuple(tree.shape)}, faces "
                         f"{tuple(faces.shape)}")
    if tuple(rays.shape) != (6, count):
        raise ValueError(f"rays must be [6, {count}], got {tuple(rays.shape)}")
    for name, x in (("rays", rays), ("record", record), ("face_gather", faces), ("tree", tree)):
        if x.device != acc.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {acc.device}")
    for name, x, dtype, shape in (("visits", visits, torch.int32, (count,)),
                                  ("stats", stats, torch.int64, (STATS,))):
        if x is not None and (x.device != acc.device or x.dtype != dtype
                              or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on "
                             f"{acc.device}")

    from .._build import count_on_device, device_guard, library, stream_handle

    counter = prng.uniforms_mode(options, acc.device) == "pallas"
    pointer = lambda x: x.data_ptr() if x is not None else None
    if counted:  # the launch's words scratch, written and read on the device
        words = torch.empty(4, dtype=torch.int64, device=acc.device)
        values = (0, int(counter), *base_key, 0, iteration.data_ptr(), words.data_ptr())
    else:
        values = (int(iteration), int(counter), *ikey, rng.randint(ikey) if counter else 0, None,
                  None)
    with device_guard(acc.device):
        err = library().k5_bounce(
            rays.data_ptr(), record.data_ptr(), faces.data_ptr(), tree.data_ptr(),
            acc.data_ptr(), pointer(visits), pointer(stats), n, p0, count, meta.trace_depth,
            *values, num_clusters, depth, stream_handle(acc.device))
    if err != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {err}")
    BOUNCE_LAUNCHES += 1
    count_on_device("k5", acc.device)
    return acc


def accumulate(dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
               start_iteration: int, num_iters: int, base_key: rng.Key,
               record: torch.Tensor | None = None,
               pixels: tuple[int, int] | None = None) -> torch.Tensor:
    """Accumulate ``num_iters`` iterations into ``acc`` [9, N] ([9, count]
    for the pixel range ``pixels``) through the whole-iteration kernel the
    scene takes: K5 (:func:`bvh_bounce_accumulate`) for a large mesh under
    ``bounce_megakernel``, else K1 (:func:`megakernel_accumulate`)."""
    run = bvh_bounce_accumulate if _uses_bvh(meta) else megakernel_accumulate
    return run(dev, meta, options, acc, start_iteration, num_iters, base_key, record=record,
               pixels=pixels)


def megakernel_sample(dev: DeviceScene, meta: SceneMeta, options, iteration: int,
                      base_key: rng.Key,
                      pixels: tuple[int, int] | None = None) -> SampleOutput:
    """One iteration through :func:`accumulate` into a zeroed accumulator:
    this sample's color * pi and, at iteration 1, its first-hit albedo and
    normal (zeros otherwise), as ``render_sample`` returns them."""
    _, _, count = _pixel_range(meta, pixels)
    acc = torch.zeros((9, count), dtype=torch.float32, device=dev.camera.position.device)
    accumulate(dev, meta, options, acc, iteration, 1, base_key, pixels=pixels)
    return SampleOutput(color=Vec3(*acc[0:3]), albedo=Vec3(*acc[3:6]), normal=Vec3(*acc[6:9]))
