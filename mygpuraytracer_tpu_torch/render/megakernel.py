"""K1: whole Monte-Carlo iterations in one CUDA kernel launch.

The port of ``mygpuraytracer_tpu/render/megakernel.py::_make_kernel`` (the
Pallas kernel that ``megakernel_accumulate`` launches). One thread follows
one pixel through ``num_iters`` iterations: AA jitter, thin-lens DoF, the
bounce loop over cubes, spheres and up to 256 listed triangles, shading,
and color * pi added into the accumulator. The albedo and normal AOVs are
written at iteration 1. Source: ``csrc/megakernel.cu``.

Unlike the TPU kernel, which baked each scene into its program and drew from
the hardware PRNG, the CUDA kernel is one generic program: the scene reaches
it as a packed float record (:func:`scene_record`), and it draws threefry
numbers at the wavefront's counters, so its image equals the plain version's
(:func:`megakernel_accumulate_reference`) up to float rounding.

The wrapper counts its launches in ``LAUNCHES``. For CPU tensors it runs the
plain version; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rng
from ..scene.device_scene import CameraParams, DeviceScene, SceneMeta
from .pathtrace import accumulate_sample, render_sample

# Record layout; csrc/megakernel.cu reads the same offsets.
HEADER = 16  # [num_geoms, num_faces, camera: pos3 view3 up3 right3 pixel_length2]
GEOM_STRIDE = 48  # type, material, xform 3x4, inverse 3x4, inv_transpose 3x3, material 11
FACE_STRIDE = 16  # geom, v0 3, e1 3, e2 3, unit normal 3, pad 3

LAUNCHES = 0  # kernel launches since the last reset


def supports_megakernel(meta: SceneMeta, options) -> bool:
    """Primitive scenes and meshes small enough to be listed whole in
    ``meta.mega_faces``; no textures, no first-bounce cache. (The JAX
    package also routes large meshes to its bounce kernel K5 under
    ``bounce_megakernel``; that kernel is not ported yet.)"""
    mesh_ok = (not meta.has_obj) or (
        bool(meta.mega_faces) and len(meta.mega_faces) == meta.num_faces
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


def megakernel_accumulate_reference(
    dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
    start_iteration: int, num_iters: int, base_key: rng.Key,
) -> torch.Tensor:
    """Plain version of K1: the wavefront ``render_sample`` per iteration,
    accumulated into ``acc`` [9, N] in place."""
    for i in range(num_iters):
        it = start_iteration + i
        accumulate_sample(acc, render_sample(dev, meta, options, it, base_key), it)
    return acc


def megakernel_accumulate(
    dev: DeviceScene, meta: SceneMeta, options, acc: torch.Tensor,
    start_iteration: int, num_iters: int, base_key: rng.Key,
    record: torch.Tensor | None = None,
) -> torch.Tensor:
    """Accumulate ``num_iters`` iterations from ``start_iteration`` into
    ``acc`` [9, N] float32 (rows: color sum rgb, albedo rgb, normal xyz) in
    one kernel launch on the current stream. ``record`` is
    :func:`scene_record`, built here when not given."""
    global LAUNCHES
    if acc.device.type == "cpu":
        return megakernel_accumulate_reference(
            dev, meta, options, acc, start_iteration, num_iters, base_key)
    width, height = meta.resolution
    n = width * height
    if acc.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, not {acc.device}")
    if acc.dtype != torch.float32 or tuple(acc.shape) != (9, n) or not acc.is_contiguous():
        raise ValueError(f"acc must be contiguous float32 [9, {n}], got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    if not supports_megakernel(meta, options):
        raise ValueError("scene/options not supported by K1 (see supports_megakernel)")
    if options.dir_aov:
        raise ValueError("K1 does not compute dir_aov")
    if meta.trace_depth < 1 or num_iters < 0 or start_iteration < 1:
        raise ValueError("need trace_depth >= 1, num_iters >= 0, start_iteration >= 1")
    if num_iters == 0:
        return acc
    if record is None:
        record = scene_record(meta, dev.camera)
    if record.device != acc.device or record.dtype != torch.float32 or not record.is_contiguous():
        raise ValueError("record must be a contiguous float32 tensor on acc's device")

    from .._build import library

    dof = bool(options.depth_of_field and options.lens_radius > 0)
    err = library().k1_accumulate(
        record.data_ptr(), acc.data_ptr(), n, width, height, meta.trace_depth,
        int(start_iteration), int(num_iters), base_key[0], base_key[1],
        int(bool(options.antialiasing)), int(dof),
        float(options.lens_radius), float(options.focal_distance),
        torch.cuda.current_stream(acc.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return acc
