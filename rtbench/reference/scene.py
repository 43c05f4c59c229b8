"""The plain reference's scene input: the scene file, the OBJ and MTL, the
PNG textures and the world-space face tables, read here from the files
themselves (nothing of the program is imported).

Semantics, as the reference path tracer (nkkk98/MyGPURaytracer) defines
them and as the port's documentation states them:

- scene file: ``MATERIAL n`` + 7 property lines, ``OBJECT n`` + type line
  (+ OBJ file name) + ``material k`` + TRANS/ROTAT/SCALE until a blank line,
  ``CAMERA`` + RES/FOVY/ITERATIONS/DEPTH/FILE + EYE/LOOKAT/UP;
- a geom's matrix is T @ Rx @ Ry @ Rz @ S (degrees), built in float64 and
  stored in float32; its inverse and inverse transpose are taken of the
  float32 matrix in float64 and stored in float32;
- an OBJ is fan-triangulated; its one material is the MTL's first, with
  specular exponent and the reflect/refract flags forced to 0 and the
  emittance Ke's red channel; its maps are 8-bit PNGs, flipped so that row
  0 is the bottom row, read nearest-texel as byte / 255;
- triangles go to world space through the float64 matrix; each face gets a
  plane form (normal, and the dual basis U, V of its edges, with their dot
  products against v0), computed in float64 and stored in float32;
- the winner table the CUDA path reads ("oct"): texcoord coefficients as
  IEEE halves and the tangent frame as 8-bit octahedral codes; both are part
  of the configuration, so the reference decodes the same quantized values.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import zlib

import numpy as np

OBJ = "obj"


@dataclasses.dataclass
class Material:
    color: tuple = (0.0, 0.0, 0.0)
    spec_exponent: float = 0.0
    spec_color: tuple = (0.0, 0.0, 0.0)
    refl: float = 0.0
    refr: float = 0.0
    ior: float = 0.0
    emit: float = 0.0


@dataclasses.dataclass
class Geom:
    kind: str
    material: Material
    transform: np.ndarray  # float32 [4, 4]
    inverse: np.ndarray
    inv_transpose: np.ndarray
    faces: np.ndarray | None = None  # float32 [F, 3, 3] local positions (OBJ)
    uvs: np.ndarray | None = None  # float32 [F, 3, 2]
    maps: dict = dataclasses.field(default_factory=dict)  # kd/ks/ke/bump -> uint8 [H, W, 3]


@dataclasses.dataclass
class Camera:
    resolution: tuple  # (width, height)
    fovy: float
    position: np.ndarray  # float32 [3]
    look_at: np.ndarray
    view: np.ndarray = None
    right: np.ndarray = None
    up: np.ndarray = None
    pixel_length: np.ndarray = None

    def derive(self) -> None:
        """Pixel size from the vertical field of view, and the look-at frame
        with world up (0, 1, 0), in float64 and stored in float32."""
        w, h = self.resolution
        yscaled = math.tan(self.fovy * math.pi / 180.0)
        xscaled = yscaled * w / h
        self.pixel_length = np.array([2.0 * xscaled / w, 2.0 * yscaled / h], np.float32)
        offset = np.asarray(self.position, np.float64) - np.asarray(self.look_at, np.float64)
        self.view = (-offset / np.linalg.norm(offset)).astype(np.float32)
        r = np.cross(self.view.astype(np.float64), np.array([0.0, 1.0, 0.0]))
        self.right = r.astype(np.float32)
        self.up = np.cross(r, self.view.astype(np.float64)).astype(np.float32)

    def moved(self, position) -> "Camera":
        cam = dataclasses.replace(self, position=np.asarray(position, np.float32))
        cam.derive()
        return cam


@dataclasses.dataclass
class Scene:
    materials: list
    geoms: list
    camera: Camera
    depth: int
    iterations: int


def _rot(axis: int, deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[j, j] = c, c
    m[i, j], m[j, i] = (-s, s) if axis != 1 else (s, -s)
    return m


def matrices(trans, rot, scale):
    t = np.eye(4)
    t[:3, 3] = np.asarray(trans, np.float64)
    s = np.diag([*np.asarray(scale, np.float64), 1.0])
    m = (t @ _rot(0, rot[0]) @ _rot(1, rot[1]) @ _rot(2, rot[2]) @ s).astype(np.float32)
    inv = np.linalg.inv(m.astype(np.float64))
    return m, inv.astype(np.float32), inv.T.astype(np.float32)


# --- PNG ---------------------------------------------------------------------

def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced PNG (gray, gray+alpha, RGB, RGBA, palette) ->
    uint8 [H, W, C], all five scanline filters."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if depth != 8 or interlace:
        raise ValueError("only 8-bit non-interlaced PNGs are read")
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.int64)
    for y in range(h):
        kind, line, prior = int(rows[y, 0]), rows[y, 1:].astype(np.int64), out[y]
        cur = np.zeros(stride, np.int64)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prior) & 0xFF
        else:
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prior[i]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[y + 1] = cur
    img = out[1:].astype(np.uint8).reshape(h, w, bpp)
    if ctype == 3:
        img = palette[img[..., 0]]
    return img


def read_map(path: str) -> np.ndarray:
    """A texture map as uint8 [H, W, 3], row 0 the bottom row; gray repeated."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[-1] < 3:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[::-1, :, :3])


# --- OBJ + MTL ---------------------------------------------------------------

def read_obj(path: str):
    """(local positions [F, 3, 3], uvs [F, 3, 2], mtllib names), fan-triangulated."""
    pos, tex, fv, ft, libs = [], [], [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                pos.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                tex.append([float(x) for x in tok[1:3]])
            elif tok[0] == "f":
                vs = [t.split("/") for t in tok[1:]]
                for i in range(1, len(vs) - 1):
                    tri = (vs[0], vs[i], vs[i + 1])
                    fv.append([int(p[0]) for p in tri])
                    ft.append([int(p[1]) if len(p) > 1 and p[1] else 0 for p in tri])
            elif tok[0] == "mtllib":
                libs.append(line.split(None, 1)[1].strip())
    P = np.asarray(pos, np.float32).reshape(-1, 3)
    T = np.asarray(tex, np.float32).reshape(-1, 2)
    fv = np.asarray(fv, np.int64)
    ft = np.asarray(ft, np.int64)
    resolve = lambda i, n: np.where(i > 0, i - 1, n + i)
    faces = P[resolve(fv, len(P))]
    uvs = np.zeros(fv.shape + (2,), np.float32)
    if len(T):
        has = ft != 0
        uvs[has] = T[resolve(ft, len(T))[has]]
    return faces, uvs, libs


def read_mtl(path: str) -> dict:
    """The first material of an MTL file as a dict of its keys."""
    mat = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                if mat is not None:
                    break
                mat = {}
            elif mat is not None:
                mat[tok[0]] = tok[1:]
    return mat or {}


def _find(name: str, dirs) -> str | None:
    for d in dirs:
        p = os.path.join(d, os.path.basename(name.replace("\\", "/")))
        if os.path.isfile(p):
            return p
    return None


def load_obj_geom(path: str, scene_dir: str, m, inv, it) -> tuple[Geom, Material]:
    faces, uvs, libs = read_obj(path)
    obj_dir = os.path.dirname(path)
    dirs = [obj_dir, os.path.join(scene_dir, "..", "models", "materials"),
            os.path.join(obj_dir, "materials"), os.path.join(obj_dir, "..", "textures"),
            os.path.join(scene_dir, "textures")]
    mtl = {}
    for lib in libs:
        p = _find(lib, dirs)
        if p:
            mtl = read_mtl(p)
            mtl_dir = os.path.dirname(p)
            dirs = [mtl_dir, os.path.join(mtl_dir, ".."),
                    os.path.join(mtl_dir, "..", "..", "textures")] + dirs
            break
    vec = lambda k, d=(0.0, 0.0, 0.0): tuple(float(x) for x in mtl.get(k, d)[:3])
    mat = Material(color=vec("Kd"), spec_color=vec("Ks"), ior=float(mtl.get("Ni", [1.0])[0]),
                   emit=vec("Ke")[0])
    maps = {}
    for slot, keys in (("kd", ("map_Kd",)), ("ks", ("map_Ks",)), ("ke", ("map_Ke",)),
                       ("bump", ("map_bump", "map_Bump", "bump"))):
        for k in keys:
            if k in mtl:
                p = _find(" ".join(mtl[k]), dirs)
                if p is None:
                    raise FileNotFoundError(f"texture map {' '.join(mtl[k])} not found")
                maps[slot] = read_map(p)
    return Geom(OBJ, mat, m, inv, it, faces=faces, uvs=uvs, maps=maps), mat


# --- the scene file ------------------------------------------------------------

def load_scene(path: str, meshes: bool = True) -> Scene:
    """The scene file; with ``meshes`` False an OBJ object is only its kind
    and matrix (no OBJ, MTL or texture is read): the camera and the
    primitives' kinds, at the cost of parsing the text."""
    scene_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()
    materials, geoms, camera, depth, iterations = [], [], None, 0, 0
    i = 0

    def nxt():
        nonlocal i
        line = lines[i] if i < len(lines) else ""
        i += 1
        return line

    while i < len(lines):
        tok = nxt().split()
        if not tok:
            continue
        if tok[0] == "MATERIAL":
            props = {}
            for _ in range(7):
                t = nxt().split()
                props[t[0]] = [float(x) for x in t[1:]]
            materials.append(Material(
                color=tuple(props["RGB"][:3]), spec_exponent=props["SPECEX"][0],
                spec_color=tuple(props["SPECRGB"][:3]), refl=props["REFL"][0],
                refr=props["REFR"][0], ior=props["REFRIOR"][0], emit=props["EMITTANCE"][0]))
        elif tok[0] == "OBJECT":
            kind = nxt().strip()
            obj_file = nxt().strip() if kind == OBJ else None
            mat_id = None
            if kind != OBJ:
                t = nxt().split()
                mat_id = int(t[1])
            trs = {"TRANS": (0.0, 0.0, 0.0), "ROTAT": (0.0, 0.0, 0.0), "SCALE": (1.0, 1.0, 1.0)}
            line = nxt()
            while line.strip():
                t = line.split()
                if t[0] in trs:
                    trs[t[0]] = tuple(float(x) for x in t[1:4])
                if i >= len(lines):
                    break
                line = nxt()
            f32 = lambda v: np.asarray(v, np.float32)
            m, inv, it = matrices(f32(trs["TRANS"]), f32(trs["ROTAT"]), f32(trs["SCALE"]))
            if kind == OBJ and not meshes:
                materials.append(Material())
                geoms.append(Geom(OBJ, materials[-1], m, inv, it))
            elif kind == OBJ:
                p = obj_file if os.path.isabs(obj_file) else os.path.join(scene_dir, obj_file)
                geom, mat = load_obj_geom(os.path.normpath(p), scene_dir, m, inv, it)
                materials.append(mat)
                geoms.append(geom)
            else:
                geoms.append(Geom(kind, mat_id, m, inv, it))
        elif tok[0] == "CAMERA":
            props = {}
            for _ in range(5):
                t = nxt().split()
                props[t[0]] = t[1:]
            line = nxt()
            while line.strip():
                t = line.split()
                props[t[0]] = t[1:]
                if i >= len(lines):
                    break
                line = nxt()
            depth, iterations = int(props["DEPTH"][0]), int(props["ITERATIONS"][0])
            camera = Camera(resolution=(int(props["RES"][0]), int(props["RES"][1])),
                            fovy=float(props["FOVY"][0]),
                            position=np.array([float(x) for x in props["EYE"]], np.float32),
                            look_at=np.array([float(x) for x in props["LOOKAT"]], np.float32))
    for g in geoms:
        if not isinstance(g.material, Material):
            g.material = materials[g.material]
    camera.derive()
    return Scene(materials, geoms, camera, depth, iterations)


def set_resolution(scene: Scene, width: int, height: int) -> None:
    scene.camera = dataclasses.replace(scene.camera, resolution=(width, height))
    scene.camera.derive()


# --- world-space faces -----------------------------------------------------------

def oct8(vecs: np.ndarray):
    """8-bit octahedral codes (x, y) of unit vectors; zero vectors -> +z."""
    v = vecs.astype(np.float64)
    s = np.abs(v).sum(axis=1)
    s = np.where(s < 1e-20, 1.0, s)
    px, py = v[:, 0] / s, v[:, 1] / s
    fx = (1.0 - np.abs(py)) * np.where(px >= 0.0, 1.0, -1.0)
    fy = (1.0 - np.abs(px)) * np.where(py >= 0.0, 1.0, -1.0)
    neg = v[:, 2] < 0.0
    q = lambda a: np.clip(np.rint((a * 0.5 + 0.5) * 255.0), 0, 255)
    return q(np.where(neg, fx, px)), q(np.where(neg, fy, py))


def oct8_decode(qx: np.ndarray, qy: np.ndarray) -> np.ndarray:
    """float32 decode of the codes, as the card reads them."""
    x = qx.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    y = qy.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    z = np.float32(1.0) - np.abs(x) - np.abs(y)
    t = np.maximum(-z, np.float32(0.0))
    x = x + np.where(x >= 0.0, -t, t)
    y = y + np.where(y >= 0.0, -t, t)
    inv = (np.float32(1.0) / np.sqrt(x * x + y * y + z * z)).astype(np.float32)
    return np.stack([x * inv, y * inv, z * inv], axis=1).astype(np.float32)


@dataclasses.dataclass
class Faces:
    """Every OBJ triangle of the scene in world space, the arrays the
    reference's nearest-face test reads."""
    plane: np.ndarray  # float32 [F, 12]: n, n.v0, U, U.v0, V, V.v0
    geom: np.ndarray  # int [F] owning geom
    uvc: np.ndarray  # float32 [F, 6]: uv0, duv1, duv2 (half-rounded)
    tb: np.ndarray  # float32 [F, 6]: tangent, bitangent (oct8-decoded)
    lo: np.ndarray  # float32 [3] world AABB of all faces
    hi: np.ndarray


def world_faces(scene: Scene) -> Faces | None:
    v0s, e1s, e2s, uvs, gid = [], [], [], [], []
    for gi, g in enumerate(scene.geoms):
        if g.kind != OBJ or g.faces is None or not len(g.faces):
            continue
        hom = np.concatenate([g.faces, np.ones(g.faces.shape[:2] + (1,), np.float32)], axis=-1)
        world = np.einsum("ij,fvj->fvi", g.transform.astype(np.float64), hom)[..., :3]
        world = world.astype(np.float32)
        v0s.append(world[:, 0])
        e1s.append(world[:, 1] - world[:, 0])
        e2s.append(world[:, 2] - world[:, 0])
        uvs.append(g.uvs)
        gid.append(np.full(len(world), gi))
    if not v0s:
        return None
    v0, e1, e2 = (np.concatenate(a) for a in (v0s, e1s, e2s))
    uv = np.concatenate(uvs)
    fv0, fe1, fe2 = (a.astype(np.float64) for a in (v0, e1, e2))
    fn = np.cross(fe1, fe2)
    d11 = np.einsum("ij,ij->i", fe1, fe1)
    d12 = np.einsum("ij,ij->i", fe1, fe2)
    d22 = np.einsum("ij,ij->i", fe2, fe2)
    inv = 1.0 / np.maximum(d11 * d22 - d12 * d12, 1e-30)
    U = (d22[:, None] * fe1 - d12[:, None] * fe2) * inv[:, None]
    V = (d11[:, None] * fe2 - d12[:, None] * fe1) * inv[:, None]
    dot = lambda a, b: np.einsum("ij,ij->i", a, b)[:, None]
    plane = np.concatenate([fn, dot(fn, fv0), U, dot(U, fv0), V, dot(V, fv0)],
                           axis=1).astype(np.float32)
    # texcoord coefficients and the tangent frame (float64, then float32)
    fuv0 = uv[:, 0].astype(np.float64)
    duv1 = uv[:, 1].astype(np.float64) - fuv0
    duv2 = uv[:, 2].astype(np.float64) - fuv0
    den = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    f = 1.0 / np.where(np.abs(den) < 1e-20, 1e-20, den)
    T = f[:, None] * (duv2[:, 1:2] * fe1 - duv1[:, 1:2] * fe2)
    B = f[:, None] * (-duv2[:, 0:1] * fe1 + duv1[:, 0:1] * fe2)
    unit = lambda a: a / np.where(np.linalg.norm(a, axis=1, keepdims=True) < 1e-20, 1.0,
                                  np.linalg.norm(a, axis=1, keepdims=True))
    T32, B32 = unit(T).astype(np.float32), unit(B).astype(np.float32)
    uvc = np.concatenate([fuv0, duv1, duv2], axis=1).astype(np.float32)
    uvc = uvc.astype(np.float16).astype(np.float32)
    tb = np.concatenate([oct8_decode(*oct8(T32)), oct8_decode(*oct8(B32))], axis=1)
    pts = np.concatenate([v0, v0 + e1, v0 + e2])
    return Faces(plane=plane, geom=np.concatenate(gid), uvc=uvc, tb=tb,
                 lo=pts.min(axis=0), hi=pts.max(axis=0))
