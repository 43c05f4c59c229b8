"""Static-shape device representation of a scene, as torch tensors.

The subset of ``mygpuraytracer_tpu/scene/device_scene.py`` that primitive
scenes and small meshes need:

- geoms     -> tensors [G, ...] (type, material, transforms, AABB, texture
               slot ids) plus host-static ``GeomStatic`` records whose
               transforms and material constants the trace code uses as
               Python floats;
- faces     -> one world-space triangle buffer [F, ...] (v0/e1/e2/uv/geom),
               Morton-ordered and padded with degenerate triangles to a
               ``face_chunk`` multiple;
- materials -> tensors [M, ...];
- meshes of at most ``MEGA_FACE_CAP`` faces also as ``SceneMeta.mega_faces``
  (geom, v0, e1, e2, unit normal), which the K1 kernel reads.

Faces are stored in world space (vertices pre-transformed at load), so the
returned ``t`` is a true world-space distance.

Texture atlases, the 128-face cluster buffers of the mesh tiers
(``face_plane``, ``face_shift``, winner tables) are not built here: the
texture and mesh-tier slices of the port add them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .structs import Camera, FaceArray, GeomType, Scene

# Faces per Morton leaf cluster (the face buffer is laid out in this order).
CLUSTER_SIZE = 128
# Meshes with at most this many faces are read by the K1 kernel as a list.
MEGA_FACE_CAP = 256


class CameraParams(NamedTuple):
    """Camera state for raygen (sceneStructs.h:84-93), float32 [3]/[2]."""

    position: torch.Tensor
    view: torch.Tensor
    up: torch.Tensor
    right: torch.Tensor
    pixel_length: torch.Tensor


class DeviceScene(NamedTuple):
    """Scene tensors on one device."""

    geom_type: torch.Tensor  # i32[G]
    geom_material: torch.Tensor  # i32[G]
    transform: torch.Tensor  # f32[G,4,4]
    inverse_transform: torch.Tensor  # f32[G,4,4]
    inv_transpose: torch.Tensor  # f32[G,4,4]
    aabb_min: torch.Tensor  # f32[G,3]
    aabb_max: torch.Tensor  # f32[G,3]
    geom_kd: torch.Tensor  # i32[G] texture slot (0 = none)
    geom_ks: torch.Tensor
    geom_ke: torch.Tensor
    geom_bump: torch.Tensor
    face_v0: torch.Tensor  # f32[F,3]
    face_e1: torch.Tensor  # f32[F,3]  v1 - v0
    face_e2: torch.Tensor  # f32[F,3]  v2 - v0
    face_uv0: torch.Tensor  # f32[F,2]
    face_uv1: torch.Tensor
    face_uv2: torch.Tensor
    face_geom: torch.Tensor  # i32[F] owning geom (pad faces point at geom 0)
    mat_color: torch.Tensor  # f32[M,3]
    mat_spec_color: torch.Tensor  # f32[M,3]
    mat_spec_ex: torch.Tensor  # f32[M]
    mat_refl: torch.Tensor
    mat_refr: torch.Tensor
    mat_ior: torch.Tensor
    mat_emittance: torch.Tensor
    camera: CameraParams


@dataclasses.dataclass(frozen=True)
class GeomStatic:
    """Host-static per-geom constants (transforms and material as floats)."""

    type: int
    material_id: int
    transform: tuple  # 4x4 nested tuple of floats
    inverse_transform: tuple
    inv_transpose: tuple
    color: tuple  # (r,g,b)
    spec_color: tuple
    spec_exponent: float
    has_reflective: float
    has_refractive: float
    ior: float
    emittance: float
    kd: int  # texture slots (0 = none)
    ks: int
    ke: int
    bump: int
    face_start: int
    face_count: int
    aabb_min: tuple = (0.0, 0.0, 0.0)
    aabb_max: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (host) scene facts."""

    resolution: tuple[int, int]  # (x, y)
    trace_depth: int
    iterations: int
    image_name: str
    num_geoms: int
    num_faces: int  # real (unpadded) face count
    has_obj: bool
    has_textures: bool
    face_ranges: tuple[tuple[int, int], ...]
    geoms: tuple[GeomStatic, ...] = ()
    # Per real face (geom_index, v0(3), e1(3), e2(3), unit_normal(3)) in
    # world space, when the scene has at most MEGA_FACE_CAP faces.
    mega_faces: tuple = ()
    # ((min3, max3), ...) world AABBs of the CLUSTER_SIZE-face Morton
    # clusters the face buffer is laid out in.
    mesh_clusters: tuple = ()
    cluster_size: int = CLUSTER_SIZE
    # Per texture slot (offset, width, height, channels); slot 0 = none.
    tex_table: tuple = ()


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """30-bit 3D Morton code (10 bits/axis)."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


def build_clusters(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                   cluster_size: int = CLUSTER_SIZE):
    """Morton-order world-space triangles by centroid and group them into
    uniform leaf clusters. Returns (order, cmin [C,3], cmax [C,3])."""
    n = len(v0)
    cent = v0 + (e1 + e2) / 3.0
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-9) * 1023.0).astype(np.uint64)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")
    sv0, se1, se2 = v0[order], e1[order], e2[order]
    n_clus = (n + cluster_size - 1) // cluster_size
    cmin = np.zeros((n_clus, 3), np.float32)
    cmax = np.zeros((n_clus, 3), np.float32)
    for c in range(n_clus):
        s, e = c * cluster_size, min((c + 1) * cluster_size, n)
        pts = np.concatenate([sv0[s:e], sv0[s:e] + se1[s:e], sv0[s:e] + se2[s:e]])
        cmin[c] = pts.min(axis=0)
        cmax[c] = pts.max(axis=0)
    return order, cmin, cmax


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def camera_params(cam: Camera, device="cuda") -> CameraParams:
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CameraParams(
        position=f(cam.position), view=f(cam.view), up=f(cam.up),
        right=f(cam.right), pixel_length=f(cam.pixel_length),
    )


def _texture_slots(geoms):
    """Texture slot ids per geom and the slot table, in the JAX package's
    slot order (all kd maps, then ks, ke, bump)."""
    table = [(0, 0, 0, 0)]
    offset = 1

    def add(tex) -> int:
        nonlocal offset
        if not tex.present:
            return 0
        table.append((offset, tex.width, tex.height, tex.channels))
        offset += tex.width * tex.height
        return len(table) - 1

    slots = [np.array([add(getattr(g, m)) for g in geoms], np.int32)
             for m in ("kd", "ks", "ke", "bump")]
    return slots, tuple(table)


def build_device_scene(
    scene: Scene, face_chunk: int = 64, device="cuda"
) -> tuple[DeviceScene, SceneMeta]:
    """Flatten a parsed host Scene into (DeviceScene, SceneMeta)."""
    geoms = scene.geoms
    G = len(geoms)
    if G == 0:
        raise ValueError("scene has no geometry")

    geom_type = np.array([int(g.type) for g in geoms], np.int32)
    geom_material = np.array([g.materialid for g in geoms], np.int32)
    transform = np.stack([g.transform for g in geoms]).astype(np.float32)
    inverse_transform = np.stack([g.inverse_transform for g in geoms]).astype(np.float32)
    inv_transpose = np.stack([g.inv_transpose for g in geoms]).astype(np.float32)
    (geom_kd, geom_ks, geom_ke, geom_bump), tex_table = _texture_slots(geoms)
    has_textures = bool(
        (geom_kd > 0).any() or (geom_ks > 0).any()
        or (geom_ke > 0).any() or (geom_bump > 0).any()
    )

    # --- Faces -> world-space triangle soup --------------------------------
    v0s, e1s, e2s, uv0s, uv1s, uv2s, fgeom = [], [], [], [], [], [], []
    face_ranges: list[tuple[int, int]] = []
    aabb_min = np.zeros((G, 3), np.float32)
    aabb_max = np.zeros((G, 3), np.float32)
    cursor = 0
    for gi, (g, faces) in enumerate(zip(geoms, scene.all_faces)):
        start = cursor
        if len(faces):
            if not isinstance(faces, FaceArray):
                faces = FaceArray.from_faces(list(faces))
            local = faces.positions  # [f,3,3]
            uvs = faces.uvs  # [f,3,2]
            hom = np.concatenate(
                [local, np.ones((*local.shape[:2], 1), np.float32)], axis=-1
            )
            world = np.einsum("ij,fvj->fvi", g.transform.astype(np.float64), hom)[
                ..., :3
            ].astype(np.float32)
            v0s.append(world[:, 0])
            e1s.append(world[:, 1] - world[:, 0])
            e2s.append(world[:, 2] - world[:, 0])
            uv0s.append(uvs[:, 0])
            uv1s.append(uvs[:, 1])
            uv2s.append(uvs[:, 2])
            fgeom.append(np.full(len(faces), gi, np.int32))
            cursor += len(faces)
            aabb_min[gi] = world.reshape(-1, 3).min(axis=0)
            aabb_max[gi] = world.reshape(-1, 3).max(axis=0)
        face_ranges.append((start, cursor - start))
    num_faces = cursor

    # Morton order (only tie-breaks depend on it; face_geom tracks owners).
    mesh_cluster_bounds = ()
    F = _pad_to(max(num_faces, 1), face_chunk)
    pad3 = lambda: np.zeros((F, 3), np.float32)
    pad2 = lambda: np.zeros((F, 2), np.float32)
    face_v0, face_e1, face_e2 = pad3(), pad3(), pad3()
    face_uv0, face_uv1, face_uv2 = pad2(), pad2(), pad2()
    face_geom = np.zeros(F, np.int32)
    if num_faces:
        all_v0 = np.concatenate(v0s)
        all_e1 = np.concatenate(e1s)
        all_e2 = np.concatenate(e2s)
        order, cmin, cmax = build_clusters(all_v0, all_e1, all_e2, CLUSTER_SIZE)
        face_v0[:num_faces] = all_v0[order]
        face_e1[:num_faces] = all_e1[order]
        face_e2[:num_faces] = all_e2[order]
        face_uv0[:num_faces] = np.concatenate(uv0s)[order]
        face_uv1[:num_faces] = np.concatenate(uv1s)[order]
        face_uv2[:num_faces] = np.concatenate(uv2s)[order]
        face_geom[:num_faces] = np.concatenate(fgeom)[order]
        mesh_cluster_bounds = tuple(
            (tuple(float(x) for x in mn), tuple(float(x) for x in mx))
            for mn, mx in zip(cmin, cmax)
        )

    # --- Materials ----------------------------------------------------------
    mats = scene.materials
    M = max(len(mats), 1)
    mat_color = np.zeros((M, 3), np.float32)
    mat_spec_color = np.zeros((M, 3), np.float32)
    mat_scalars = np.zeros((5, M), np.float32)  # spec_ex refl refr ior emit
    for i, m in enumerate(mats):
        mat_color[i] = m.color
        mat_spec_color[i] = m.specular_color
        mat_scalars[:, i] = (m.specular_exponent, m.has_reflective,
                             m.has_refractive, m.index_of_refraction, m.emittance)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    dev = DeviceScene(
        geom_type=t(geom_type), geom_material=t(geom_material),
        transform=t(transform), inverse_transform=t(inverse_transform),
        inv_transpose=t(inv_transpose), aabb_min=t(aabb_min), aabb_max=t(aabb_max),
        geom_kd=t(geom_kd), geom_ks=t(geom_ks), geom_ke=t(geom_ke),
        geom_bump=t(geom_bump),
        face_v0=t(face_v0), face_e1=t(face_e1), face_e2=t(face_e2),
        face_uv0=t(face_uv0), face_uv1=t(face_uv1), face_uv2=t(face_uv2),
        face_geom=t(face_geom),
        mat_color=t(mat_color), mat_spec_color=t(mat_spec_color),
        mat_spec_ex=t(mat_scalars[0]), mat_refl=t(mat_scalars[1]),
        mat_refr=t(mat_scalars[2]), mat_ior=t(mat_scalars[3]),
        mat_emittance=t(mat_scalars[4]),
        camera=camera_params(scene.state.camera, device),
    )

    def _t4(m) -> tuple:
        return tuple(tuple(float(v) for v in row) for row in np.asarray(m))

    def _t3(v) -> tuple:
        return tuple(float(x) for x in np.asarray(v))

    geom_statics = []
    for gi, g in enumerate(geoms):
        m = mats[g.materialid] if 0 <= g.materialid < len(mats) else mats[0]
        geom_statics.append(GeomStatic(
            type=int(g.type),
            material_id=int(g.materialid),
            transform=_t4(g.transform),
            inverse_transform=_t4(g.inverse_transform),
            inv_transpose=_t4(g.inv_transpose),
            color=_t3(m.color),
            spec_color=_t3(m.specular_color),
            spec_exponent=float(m.specular_exponent),
            has_reflective=float(m.has_reflective),
            has_refractive=float(m.has_refractive),
            ior=float(m.index_of_refraction),
            emittance=float(m.emittance),
            kd=int(geom_kd[gi]), ks=int(geom_ks[gi]),
            ke=int(geom_ke[gi]), bump=int(geom_bump[gi]),
            face_start=int(face_ranges[gi][0]),
            face_count=int(face_ranges[gi][1]),
            aabb_min=_t3(aabb_min[gi]),
            aabb_max=_t3(aabb_max[gi]),
        ))

    mega_faces = ()
    if 0 < num_faces <= MEGA_FACE_CAP:
        mf = []
        for i in range(num_faces):
            nrm = np.cross(face_e1[i].astype(np.float64), face_e2[i].astype(np.float64))
            nl = np.linalg.norm(nrm)
            nrm = nrm / nl if nl > 0 else nrm
            mf.append((int(face_geom[i]), _t3(face_v0[i]), _t3(face_e1[i]),
                       _t3(face_e2[i]), _t3(nrm)))
        mega_faces = tuple(mf)

    meta = SceneMeta(
        resolution=tuple(scene.state.camera.resolution),
        trace_depth=scene.state.trace_depth,
        iterations=scene.state.iterations,
        image_name=scene.state.image_name,
        num_geoms=G,
        num_faces=num_faces,
        has_obj=any(g.type == GeomType.OBJ for g in geoms),
        has_textures=has_textures,
        face_ranges=tuple(face_ranges),
        geoms=tuple(geom_statics),
        mega_faces=mega_faces,
        mesh_clusters=mesh_cluster_bounds,
        cluster_size=CLUSTER_SIZE,
        tex_table=tex_table,
    )
    return dev, meta
