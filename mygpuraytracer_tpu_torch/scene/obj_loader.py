"""Wavefront OBJ + MTL ingestion.

From-scratch replacement for the reference's tinyobj path
(apps/src/scene.cpp:38-234 / tiny_obj_loader.h): parses v/vt/vn/f records,
fan-triangulates polygons, computes the per-geom AABB, loads the *first*
material of the .mtl (the reference assumes one material per model,
scene.cpp:68,134) with its kd/ks/ke/bump texture maps, and synthesizes a
scene Material from it (scene.cpp:220-232).

Geometry is parsed by the native loader (``native_loader.py``: the JAX
package's C++ parser, which Morton-orders the triangles), built for the host
at first use; without a host C++ compiler it is parsed in Python, in file
order. ``device_scene.build_device_scene`` Morton-orders the face buffer
either way; only faces whose codes tie keep the parser's order.

Deviation from the reference (documented): scene.cpp:60-65 initializes
``maxX``/``minZ``/``maxZ`` with the wrong FLT_MAX/FLT_MIN sentinels, producing
a broken AABB (harmless there because BOUNDING_BOX is compiled out). We
compute the correct AABB, which the mesh pre-test uses.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from .native_loader import native_parse_obj
from .structs import FaceArray, Material, Texture
from ..utils.png import load_texture


@dataclasses.dataclass
class MtlMaterial:
    name: str = ""
    diffuse: tuple = (0.0, 0.0, 0.0)  # Kd
    specular: tuple = (0.0, 0.0, 0.0)  # Ks
    emission: tuple = (0.0, 0.0, 0.0)  # Ke
    ior: float = 1.0  # Ni
    shininess: float = 1.0  # Ns
    diffuse_texname: str = ""
    specular_texname: str = ""
    emissive_texname: str = ""
    bump_texname: str = ""


def parse_mtl(path: str) -> list[MtlMaterial]:
    mats: list[MtlMaterial] = []
    cur: MtlMaterial | None = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            key = tokens[0]
            if key == "newmtl":
                cur = MtlMaterial(name=" ".join(tokens[1:]))
                mats.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur.diffuse = tuple(float(x) for x in tokens[1:4])
            elif key == "Ks":
                cur.specular = tuple(float(x) for x in tokens[1:4])
            elif key == "Ke":
                cur.emission = tuple(float(x) for x in tokens[1:4])
            elif key == "Ni":
                cur.ior = float(tokens[1])
            elif key == "Ns":
                cur.shininess = float(tokens[1])
            elif key == "map_Kd":
                cur.diffuse_texname = _texname(tokens)
            elif key == "map_Ks":
                cur.specular_texname = _texname(tokens)
            elif key == "map_Ke":
                cur.emissive_texname = _texname(tokens)
            elif key in ("map_bump", "map_Bump", "bump"):
                cur.bump_texname = _texname(tokens)
    return mats


def _texname(tokens: list[str]) -> str:
    """Texture map name = the whole rest of the line (names may contain
    spaces, e.g. the reference's 'Intergalactic Spaceship_color_4.jpg'),
    with Windows backslash separators normalized (the reference .mtl files
    are Blender-on-Windows exports using literal '..\\\\textures\\\\...')."""
    import re

    return re.sub("/+", "/", " ".join(tokens[1:]).replace("\\", "/"))


def _resolve_index(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices count from the end."""
    return idx - 1 if idx > 0 else count + idx


def _parse_face_vertex(token: str):
    """Parse 'v', 'v/vt', 'v//vn', or 'v/vt/vn' into (v, vt) 1-based or None."""
    parts = token.split("/")
    v = int(parts[0])
    vt = int(parts[1]) if len(parts) > 1 and parts[1] else None
    return v, vt


@dataclasses.dataclass
class ObjModel:
    faces: FaceArray
    min_pos: np.ndarray
    max_pos: np.ndarray
    material: MtlMaterial
    kd: Texture
    ks: Texture
    ke: Texture
    bump: Texture


def _load_tex(name: str, search_dirs: list[str]) -> Texture:
    """Load a texture map by name, searching like tinyobj's mtl dir logic
    plus the path as given (scene.cpp:138-218). Missing map → empty Texture,
    matching the reference's failed-load path (scene.cpp:150-154)."""
    if not name:
        return Texture()
    candidates = [name] + [os.path.join(d, os.path.basename(name)) for d in search_dirs]
    candidates += [os.path.join(d, name) for d in search_dirs]
    for cand in candidates:
        if os.path.isfile(cand):
            arr = load_texture(cand, flip_vertical=True)
            return Texture(
                width=arr.shape[1], height=arr.shape[0], channels=arr.shape[2], image=arr
            )
    # Loud fallback: a silently-untextured mesh renders (and BENCHMARKS!)
    # like an untextured one — this exact trap produced bogus round-3
    # "textured ship" numbers when the gitignored procedural textures were
    # absent from a fresh checkout (docs/MESH_TIERS.md).
    print(f"warning: texture map '{name}' not found "
          f"(searched {len(candidates)} paths) — using empty texture",
          file=sys.stderr)
    return Texture()


def _scan_mtllibs(path: str) -> list[str]:
    """Cheap scan for mtllib lines."""
    libs = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("mtllib"):
                libs.append(line.split(None, 1)[1].strip())
    return libs


def _python_parse_geometry(path: str):
    """Returns (tri_pos [n,3,3], tri_uv [n,3,2], mn, mx)."""
    positions: list[tuple] = []
    texcoords: list[tuple] = []
    tri_v: list[tuple] = []
    tri_vt: list[tuple] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            key = tokens[0]
            if key == "v":
                positions.append(tuple(float(x) for x in tokens[1:4]))
            elif key == "vt":
                texcoords.append(tuple(float(x) for x in tokens[1:3]))
            elif key == "f":
                verts = [_parse_face_vertex(t) for t in tokens[1:]]
                for i in range(1, len(verts) - 1):  # fan triangulation
                    tri_v.append((verts[0][0], verts[i][0], verts[i + 1][0]))
                    tri_vt.append((verts[0][1], verts[i][1], verts[i + 1][1]))

    np_pos = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
    np_uv = np.asarray(texcoords, dtype=np.float32).reshape(-1, 2)
    n = len(tri_v)
    pos = np.zeros((n, 3, 3), np.float32)
    uv = np.zeros((n, 3, 2), np.float32)
    for t, (vs, vts) in enumerate(zip(tri_v, tri_vt)):
        for k in range(3):
            pos[t, k] = np_pos[_resolve_index(vs[k], len(np_pos))]
            if vts[k] is not None and len(np_uv):
                uv[t, k] = np_uv[_resolve_index(vts[k], len(np_uv))]
    if n:
        flat = pos.reshape(-1, 3)
        mn, mx = flat.min(axis=0), flat.max(axis=0)
    else:
        mn = mx = np.zeros(3, np.float32)
    return pos, uv, mn.astype(np.float32), mx.astype(np.float32)


def load_obj(path: str, mtl_search_path: str | None = None) -> ObjModel:
    """Parse an OBJ file into triangles + first-material textures.

    ``mtl_search_path`` mirrors reader_config.mtl_search_path
    ('../models/materials', scene.cpp:41); we additionally search next to the
    OBJ itself and in a sibling ``textures/`` directory so reference assets
    resolve from any CWD.
    """
    native = native_parse_obj(path)
    pos, uv, mn, mx = native if native is not None else _python_parse_geometry(path)
    faces = FaceArray(positions=pos, uvs=uv)

    obj_dir = os.path.dirname(os.path.abspath(path))
    search_dirs = [obj_dir]
    if mtl_search_path:
        search_dirs.append(mtl_search_path)
    search_dirs += [
        os.path.join(obj_dir, "materials"),
        os.path.join(obj_dir, os.pardir, "textures"),
        os.path.join(obj_dir, os.pardir, "models", "materials"),
    ]

    material = MtlMaterial()
    for mtl_name in _scan_mtllibs(path):
        cands = [mtl_name] + [
            os.path.join(d, os.path.basename(mtl_name)) for d in search_dirs
        ]
        for cand in cands:
            if os.path.isfile(cand):
                mats = parse_mtl(cand)
                if mats:
                    # Reference uses objMaterials[0] only (scene.cpp:68,134).
                    material = mats[0]
                # texture names resolve relative to the .mtl's own directory
                # (tinyobj mtl_basedir semantics) — needed when the mtllib
                # lives outside the OBJ's tree (e.g. the reference checkout)
                mtl_dir = os.path.dirname(os.path.abspath(cand))
                search_dirs[:0] = [
                    mtl_dir,
                    os.path.normpath(os.path.join(mtl_dir, os.pardir)),
                    os.path.normpath(
                        os.path.join(mtl_dir, os.pardir, os.pardir, "textures")
                    ),
                ]
                break
        else:
            continue
        break

    return ObjModel(
        faces=faces,
        min_pos=mn,
        max_pos=mx,
        material=material,
        kd=_load_tex(material.diffuse_texname, search_dirs),
        ks=_load_tex(material.specular_texname, search_dirs),
        ke=_load_tex(material.emissive_texname, search_dirs),
        bump=_load_tex(material.bump_texname, search_dirs),
    )


def synthesize_material(m: MtlMaterial) -> Material:
    """scene.cpp:220-232: one scene Material synthesized per OBJ model.

    specular.exponent is forced to 0 and reflect/refract flags to 0; emittance
    comes from Ke's red channel only — all reference quirks kept."""
    return Material(
        color=np.asarray(m.diffuse, np.float32),
        specular_exponent=0.0,
        specular_color=np.asarray(m.specular, np.float32),
        has_reflective=0.0,
        has_refractive=0.0,
        index_of_refraction=m.ior,
        emittance=float(m.emission[0]),
    )
