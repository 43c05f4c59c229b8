"""Static-shape device representation of a scene, as torch tensors.

Counterpart of ``mygpuraytracer_tpu/scene/device_scene.py``:

- geoms     -> tensors [G, ...] (type, material, transforms, AABB, texture
               slot ids) plus host-static ``GeomStatic`` records whose
               transforms and material constants the trace code uses as
               Python floats;
- faces     -> one world-space triangle buffer [F, ...] (v0/e1/e2/uv/geom,
               unit tangent/bitangent), Morton-ordered and padded with
               degenerate triangles to a ``face_chunk`` multiple;
- clusters  -> the same faces in plane form, ``face_plane`` [16, Fp], laid
               out in 128-face Morton clusters whose AABBs are
               ``cluster_bounds`` [6, C]: what the cluster query reads
               (ops/mesh_hit.py), and the mesh query's winner tables of
               uv/TBN (``face_ex_t`` f32, ``face_ex_o`` f16 pairs +
               octahedral TBN);
- textures  -> byte-packed atlases (``tex_atlas_w`` one word per texel,
               ``tex_atlas16_w`` four words per texel of a geom's
               kd/ks/ke/bump maps) with static slot tables in ``SceneMeta``;
- materials -> tensors [M, ...];
- cubes and spheres -> ``prim_table`` [P, PRIM_COLS], one row per cube or
  sphere in geom order (:func:`primitive_table`): what the wavefront's
  nearest-primitive kernel (csrc/prims_hit.cu) reads;
- meshes of at most ``MEGA_FACE_CAP`` faces also as ``SceneMeta.mega_faces``
  (geom, v0, e1, e2, unit normal), which the K1 kernel reads.

Faces are stored in world space (vertices pre-transformed at load), so the
returned ``t`` is a true world-space distance. The plane form and the TBN
frame are computed in float64 and cast to float32, as the JAX package does,
so the arrays equal its bit for bit. The packed-word tables hold uint32 bit
patterns in int32 tensors (torch's bitwise ops take int32).

The TPU's sublane-shifted copy of the faces (``face_shift``) is not built:
it is a layout for the TPU's lane rolls. Two layouts of the port's own serve
the per-ray cluster walk (csrc/mesh.cuh) of the mesh tiers' kernel
(csrc/mesh_hit.cu) and of K5 (csrc/bounce.cu): ``cluster_tree``, a balanced
binary tree over the Morton-ordered cluster boxes
(:func:`build_cluster_tree`), and ``face_gather``, ``face_plane``'s rows
0-12 as float4s in per-cluster blocks, so that 32 lanes testing 32
consecutive faces read 512 contiguous bytes per float4. They are built for
every mesh of more than ``MEGA_FACE_CAP`` faces, textured or not; elsewhere
both are empty.
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

# The primitive table's row (csrc/prims_hit.cu reads the same offsets):
# type (int32 bits: GeomType), inverse_transform and transform rows 0-2 of 4
# columns, inv_transpose rows 0-2 of 3, color, spec color, spec exponent,
# reflective, refractive, ior, emittance, then material id and the kd, ks,
# ke and bump texture slots (int32 bits).
PRIM_TYPE, PRIM_INV, PRIM_XFORM, PRIM_INVT, PRIM_MAT, PRIM_INTS = 0, 1, 13, 25, 34, 45
PRIM_COLS = 50


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
    face_tb: torch.Tensor  # f32[F,6] unit tangent xyz, bitangent xyz (bump TBN)
    # Plane form, quantity-major: rows fn(3), c=fn.v0, U(3), cu=U.v0, V(3),
    # cv=V.v0, geom, pad; (U, V) is the dual basis of (e1, e2), so a point x
    # of the plane has barycentrics u = x.U - cu, v = x.V - cv. Pad faces
    # have fn = 0 and c = 1e30: their t is inf and never wins.
    face_plane: torch.Tensor  # f32[16, Fp], Fp = faces padded to CLUSTER_SIZE
    # Per face: uv0, uv1-uv0, uv2-uv0 (u and v each), unit tangent,
    # bitangent; f32[Fp, 12], the used rows 0-5 and 8-13 of the plane
    # extension (_uv_tbn) transposed. f32[1, 12] zeros when untextured.
    face_ex_t: torch.Tensor
    face_ex_o: torch.Tensor  # u32-as-i32 [Fp, 4]: 3 f16-pair uv words + tx|ty<<8|bx<<16|by<<24 (oct8)
    cluster_bounds: torch.Tensor  # f32[6, C]: min xyz, max xyz of each cluster
    # Rows 0-12 of face_plane, zero-padded to 16, four rows to a float4 and
    # one block per cluster: f32[Fp / 128, 4, 128, 4], [c, k, j, i] = row
    # 4k + i of face c * 128 + j. f32[0, 4, 128, 4] unless the scene has a
    # mesh of more than MEGA_FACE_CAP faces (the cluster walk's meshes).
    face_gather: torch.Tensor
    # build_cluster_tree: f32[max(C - 1, 0), 16], the interior nodes in
    # preorder (root 0); per node the left child's box (min xyz, max xyz),
    # the right child's box, then the two child links as int32 bits.
    # f32[0, 16] unless the scene has such a mesh, as face_gather.
    cluster_tree: torch.Tensor
    prim_table: torch.Tensor  # f32[P, PRIM_COLS]: primitive_table(SceneMeta.geoms)
    mat_color: torch.Tensor  # f32[M,3]
    mat_spec_color: torch.Tensor  # f32[M,3]
    mat_spec_ex: torch.Tensor  # f32[M]
    mat_refl: torch.Tensor
    mat_refr: torch.Tensor
    mat_ior: torch.Tensor
    mat_emittance: torch.Tensor
    tex_atlas_w: torch.Tensor  # u32-as-i32 [P]: r | g<<8 | b<<16 per texel; texel 0 = none
    tex_atlas16_w: torch.Tensor  # u32-as-i32 [P16, 4]: kd.rgb ks.rgb ke.rgb bump.rgb bytes
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
    # Per textured geom (kd_id, ks_id, ke_id, bump_id, offset, width, height)
    # into tex_atlas16_w; empty when a geom's maps differ in resolution.
    tex_pack_table: tuple = ()


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


def build_cluster_tree(cmin: np.ndarray, cmax: np.ndarray) -> np.ndarray:
    """A balanced binary tree over the clusters' index range, split at the
    midpoint: the nodes, f32[max(C - 1, 0), 16].

    The clusters are in Morton order, so an index range is a coherent piece
    of the mesh. Node ``i`` (preorder, root 0) holds, in columns 0-5 and
    6-11, the boxes of its left (lower) and right child: the exact float32
    min/max of their clusters' boxes ``cmin``/``cmax`` [C, 3], so a child
    that is one cluster carries that cluster's box bit for bit. Columns 12
    and 13 hold the child links as int32 bits: an interior node's index, or
    ``-1 - c`` for cluster ``c``; 14-15 are zero. With one cluster there is
    no node and the root link is ``-1``. The levels below the root, leaves
    included, are ``ceil(log2 C)`` (render/megakernel.py::tree_depth).
    """
    n = len(cmin)
    nodes = np.zeros((max(n - 1, 0), 16), np.float32)
    links = nodes.view(np.int32)
    count = [0]

    def build(lo: int, hi: int) -> int:
        """The link of the subtree over clusters [lo, hi)."""
        if hi - lo == 1:
            return -1 - lo
        i = count[0]
        count[0] += 1
        mid = (lo + hi) // 2
        for col, (a, b) in ((0, (lo, mid)), (6, (mid, hi))):
            nodes[i, col:col + 3] = cmin[a:b].min(axis=0)
            nodes[i, col + 3:col + 6] = cmax[a:b].max(axis=0)
        links[i, 12:14] = build(lo, mid), build(mid, hi)
        return i

    if n:
        build(0, n)
    return nodes


def build_face_gather(face_plane: np.ndarray) -> np.ndarray:
    """Rows 0-12 of ``face_plane`` [16, Fp], zero-padded to 16, four rows to
    a float4 and one block per cluster: f32[Fp / 128, 4, 128, 4], element
    [c, k, j, i] is row 4k + i of face c * 128 + j."""
    fp = face_plane.shape[1]
    rows = np.zeros((16, fp), np.float32)
    rows[:13] = face_plane[:13]
    return rows.reshape(4, 4, fp // CLUSTER_SIZE, CLUSTER_SIZE).transpose(2, 0, 3, 1)


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def camera_params(cam: Camera, device="cuda") -> CameraParams:
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CameraParams(
        position=f(cam.position), view=f(cam.view), up=f(cam.up),
        right=f(cam.right), pixel_length=f(cam.pixel_length),
    )


def _pack_words(u8: np.ndarray) -> np.ndarray:
    """Little-endian byte pack of a (n, k<=4) uint8 array into uint32."""
    w = np.zeros(u8.shape[0], np.uint32)
    for j in range(u8.shape[1]):
        w |= u8[:, j].astype(np.uint32) << np.uint32(8 * j)
    return w


def _pack_f16_pairs(f32: np.ndarray) -> np.ndarray:
    """(n, 2k) float32 -> (n, k) uint32 of f16 pairs, even column low."""
    h = np.ascontiguousarray(f32.astype(np.float16)).view(np.uint16)
    return h[:, 0::2].astype(np.uint32) | (h[:, 1::2].astype(np.uint32) << np.uint32(16))


def _oct8(vecs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """8-bit octahedral code of (n, 3) unit vectors as two uint32 columns in
    [0, 255]; zero vectors (degenerate-uv tangents) map to the +z pole."""
    v = vecs.astype(np.float64)
    s = np.abs(v).sum(axis=1)
    s = np.where(s < 1e-20, 1.0, s)
    px, py = v[:, 0] / s, v[:, 1] / s
    fx = (1.0 - np.abs(py)) * np.where(px >= 0.0, 1.0, -1.0)
    fy = (1.0 - np.abs(px)) * np.where(py >= 0.0, 1.0, -1.0)
    neg = v[:, 2] < 0.0
    x = np.where(neg, fx, px)
    y = np.where(neg, fy, py)
    q = lambda a: np.clip(np.rint((a * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint32)
    return q(x), q(y)


def _texel_bytes(tex) -> np.ndarray:
    """A texture's texels as (w*h, 3) uint8 (gray repeated to rgb)."""
    img = tex.image
    if img.shape[-1] < 3:
        img = np.repeat(img[..., :1], 3, axis=-1)
    u8 = img[..., :3].reshape(-1, 3)
    if u8.dtype != np.uint8:
        raise TypeError(f"texture image dtype {u8.dtype} reached atlas packing; "
                        "textures are uint8 by contract (utils/png.py load_texture)")
    return u8


def _texture_atlases(geoms):
    """Texture slots per geom, in the JAX package's slot order (all kd maps,
    then ks, ke, bump), the per-slot word atlas and its table, and the
    per-geom packed atlas and its table."""
    table = [(0, 0, 0, 0)]
    words = [np.zeros(1, np.uint32)]
    offset = 1

    def add(tex) -> int:
        nonlocal offset
        if not tex.present:
            return 0
        words.append(_pack_words(_texel_bytes(tex)))
        table.append((offset, tex.width, tex.height, tex.channels))
        offset += tex.width * tex.height
        return len(table) - 1

    slots = [np.array([add(getattr(g, m)) for g in geoms], np.int32)
             for m in ("kd", "ks", "ke", "bump")]

    pack_words, pack_table, pack_off = [np.zeros((1, 4), np.uint32)], [], 1
    for gi, g in enumerate(geoms):
        maps = [g.kd, g.ks, g.ke, g.bump]
        present = [t for t in maps if t.present]
        if not present:
            continue
        if len({(t.width, t.height) for t in present}) != 1:
            pack_words, pack_table = [np.zeros((1, 4), np.uint32)], []
            break  # mixed resolutions within one geom: per-map fetches only
        w_, h_ = present[0].width, present[0].height
        row_u8 = np.zeros((w_ * h_, 16), np.uint8)
        for mi, t in enumerate(maps):
            if t.present:
                row_u8[:, 3 * mi:3 * mi + 3] = _texel_bytes(t)
        pack_words.append(np.stack(
            [_pack_words(row_u8[:, 4 * j:4 * j + 4]) for j in range(4)], axis=1))
        pack_table.append((*(int(s[gi]) for s in slots), pack_off, w_, h_))
        pack_off += row_u8.shape[0]
    return (slots, tuple(table), np.concatenate(words),
            tuple(pack_table), np.concatenate(pack_words))


def _plane_form(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, geom: np.ndarray,
                fp: int) -> np.ndarray:
    """face_plane [16, fp] from world triangles (float64 precompute of a
    well-conditioned dual basis, cast to float32)."""
    n = len(v0)
    out = np.zeros((16, fp), np.float32)
    fv0, fe1, fe2 = (a.astype(np.float64) for a in (v0, e1, e2))
    fn = np.cross(fe1, fe2)
    d11 = np.einsum("ij,ij->i", fe1, fe1)
    d12 = np.einsum("ij,ij->i", fe1, fe2)
    d22 = np.einsum("ij,ij->i", fe2, fe2)
    inv = 1.0 / np.maximum(d11 * d22 - d12 * d12, 1e-30)
    U = (d22[:, None] * fe1 - d12[:, None] * fe2) * inv[:, None]
    V = (d11[:, None] * fe2 - d12[:, None] * fe1) * inv[:, None]
    out[0:3, :n] = fn.T
    out[3, :n] = np.einsum("ij,ij->i", fn, fv0)
    out[4:7, :n] = U.T
    out[7, :n] = np.einsum("ij,ij->i", U, fv0)
    out[8:11, :n] = V.T
    out[11, :n] = np.einsum("ij,ij->i", V, fv0)
    out[12, :n] = geom.astype(np.float32)
    out[3, n:] = 1e30
    return out


def _uv_tbn(e1, e2, uv0, uv1, uv2, fp: int) -> tuple[np.ndarray, np.ndarray]:
    """(face_tb [n, 6], plane extension [16, fp]): unit tangent/bitangent from
    world edges and uv deltas (intersections.h:245-279), and the uv
    interpolation coefficients, in float64 then float32."""
    n = len(e1)
    fe1, fe2 = e1.astype(np.float64), e2.astype(np.float64)
    fuv0 = uv0.astype(np.float64)
    duv1 = uv1.astype(np.float64) - fuv0
    duv2 = uv2.astype(np.float64) - fuv0
    den = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    f = 1.0 / np.where(np.abs(den) < 1e-20, 1e-20, den)
    T = f[:, None] * (duv2[:, 1:2] * fe1 - duv1[:, 1:2] * fe2)
    B = f[:, None] * (-duv2[:, 0:1] * fe1 + duv1[:, 0:1] * fe2)

    def unit(a):
        nrm = np.linalg.norm(a, axis=1, keepdims=True)
        return a / np.where(nrm < 1e-20, 1.0, nrm)

    tb = np.zeros((n, 6), np.float32)
    tb[:, 0:3] = unit(T)
    tb[:, 3:6] = unit(B)
    ex = np.zeros((16, fp), np.float32)
    ex[0:2, :n] = fuv0.T
    ex[2:4, :n] = duv1.T
    ex[4:6, :n] = duv2.T
    ex[8:14, :n] = tb.T
    return tb, ex


def primitive_table(geoms) -> np.ndarray:
    """The cubes and spheres of ``geoms`` (``GeomStatic`` records, in order;
    other types are left out) as float32 rows of ``PRIM_COLS``: the
    transforms and material constants that ``ops/trace.py::
    intersect_primitives_soa`` reads as Python floats, rounded to float32
    as its arithmetic rounds them, and the int fields as int32 bits."""
    prims = [g for g in geoms if g.type in (GeomType.CUBE, GeomType.SPHERE)]
    table = np.zeros((len(prims), PRIM_COLS), np.float32)
    ints = table.view(np.int32)
    for row, g in enumerate(prims):
        ints[row, PRIM_TYPE] = g.type
        table[row, PRIM_INV:PRIM_XFORM] = np.asarray(g.inverse_transform, np.float32)[:3].ravel()
        table[row, PRIM_XFORM:PRIM_INVT] = np.asarray(g.transform, np.float32)[:3].ravel()
        table[row, PRIM_INVT:PRIM_MAT] = np.asarray(g.inv_transpose, np.float32)[:3, :3].ravel()
        table[row, PRIM_MAT:PRIM_INTS] = (*g.color, *g.spec_color, g.spec_exponent,
                                          g.has_reflective, g.has_refractive, g.ior, g.emittance)
        ints[row, PRIM_INTS:PRIM_COLS] = (g.material_id, g.kd, g.ks, g.ke, g.bump)
    return table


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
    ((geom_kd, geom_ks, geom_ke, geom_bump), tex_table, tex_atlas_w,
     tex_pack_table, tex_atlas16_w) = _texture_atlases(geoms)
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
    cluster_bounds = np.array([[c[k][i] for c in mesh_cluster_bounds]
                               for k in (0, 1) for i in range(3)], np.float32).reshape(6, -1)

    # --- Plane form, uv/TBN extension and the winner tables -----------------
    Fp = _pad_to(max(num_faces, 1), CLUSTER_SIZE)
    face_plane = np.zeros((16, Fp), np.float32)
    face_tb = np.zeros((F, 6), np.float32)
    plane_ex = np.zeros((16, 1), np.float32)
    if num_faces:
        sl = slice(0, num_faces)
        face_plane = _plane_form(face_v0[sl], face_e1[sl], face_e2[sl], face_geom[sl], Fp)
        if has_textures:
            face_tb[sl], plane_ex = _uv_tbn(
                face_e1[sl], face_e2[sl], face_uv0[sl], face_uv1[sl], face_uv2[sl], Fp)
    # The cluster walk's layouts, for every mesh that takes the cluster query or K5.
    face_gather = np.zeros((0, 4, CLUSTER_SIZE, 4), np.float32)
    cluster_tree = np.zeros((0, 16), np.float32)
    if num_faces > MEGA_FACE_CAP:
        face_gather = build_face_gather(face_plane)
        cluster_tree = build_cluster_tree(cluster_bounds[0:3].T, cluster_bounds[3:6].T)
    ex12 = np.ascontiguousarray(plane_ex[list(range(6)) + list(range(8, 14))].T)
    otx, oty = _oct8(ex12[:, 6:9])
    obx, oby = _oct8(ex12[:, 9:12])
    oct_word = otx | (oty << np.uint32(8)) | (obx << np.uint32(16)) | (oby << np.uint32(24))
    face_ex_o = np.concatenate([_pack_f16_pairs(ex12[:, :6]), oct_word[:, None]], axis=1)

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
    words = lambda a: t(np.ascontiguousarray(a, np.uint32).view(np.int32))

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

    dev = DeviceScene(
        geom_type=t(geom_type), geom_material=t(geom_material),
        transform=t(transform), inverse_transform=t(inverse_transform),
        inv_transpose=t(inv_transpose), aabb_min=t(aabb_min), aabb_max=t(aabb_max),
        geom_kd=t(geom_kd), geom_ks=t(geom_ks), geom_ke=t(geom_ke),
        geom_bump=t(geom_bump),
        face_v0=t(face_v0), face_e1=t(face_e1), face_e2=t(face_e2),
        face_uv0=t(face_uv0), face_uv1=t(face_uv1), face_uv2=t(face_uv2),
        face_geom=t(face_geom), face_tb=t(face_tb),
        face_plane=t(face_plane), face_ex_t=t(ex12), face_ex_o=words(face_ex_o),
        cluster_bounds=t(cluster_bounds), face_gather=t(face_gather),
        cluster_tree=t(cluster_tree), prim_table=t(primitive_table(geom_statics)),
        mat_color=t(mat_color), mat_spec_color=t(mat_spec_color),
        mat_spec_ex=t(mat_scalars[0]), mat_refl=t(mat_scalars[1]),
        mat_refr=t(mat_scalars[2]), mat_ior=t(mat_scalars[3]),
        mat_emittance=t(mat_scalars[4]),
        tex_atlas_w=words(tex_atlas_w), tex_atlas16_w=words(tex_atlas16_w),
        camera=camera_params(scene.state.camera, device),
    )

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
        tex_pack_table=tex_pack_table,
    )
    return dev, meta
