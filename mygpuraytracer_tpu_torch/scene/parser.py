"""scene.txt parser.

Reimplements the reference's line-token scene DSL (apps/src/scene.cpp):

- ``MATERIAL n`` followed by exactly 7 property lines
  RGB / SPECEX / SPECRGB / REFL / REFR / REFRIOR / EMITTANCE
  (scene.cpp:388-423)
- ``OBJECT n`` followed by a type line (sphere|cube|triangle|obj), for obj an
  extra filename line, a ``material k`` link line for non-obj geoms, then
  TRANS/ROTAT/SCALE lines until a blank line (scene.cpp:236-322).
  Reference quirk kept: for ``obj`` geoms the material link line is *not*
  consumed — it falls into the transform loop and is ignored; the material is
  synthesized from the .mtl instead (scene.cpp:274-282,220-232).
- ``CAMERA`` followed by RES/FOVY/ITERATIONS/DEPTH/FILE then EYE/LOOKAT/UP
  (scene.cpp:324-386).

Lines are split on arbitrary whitespace (utilities.cpp:74-80) and read
CRLF-safely (utilities.cpp:82-112).
"""

from __future__ import annotations

import os

import numpy as np

from . import obj_loader
from .structs import Camera, Geom, GeomType, Material, RenderState, Scene


def _tokenize(line: str) -> list[str]:
    return line.split()


class _LineReader:
    def __init__(self, text: str):
        # splitlines handles \n, \r\n and \r like safeGetline.
        self._lines = text.splitlines()
        self._pos = 0

    def good(self) -> bool:
        return self._pos < len(self._lines)

    def getline(self) -> str:
        if not self.good():
            return ""
        line = self._lines[self._pos]
        self._pos += 1
        return line


def load_scene(filename: str) -> Scene:
    with open(filename, "r", errors="replace") as f:
        text = f.read()
    reader = _LineReader(text)
    scene = Scene(source_path=os.path.abspath(filename))

    while reader.good():
        line = reader.getline()
        if not line.strip():
            continue
        tokens = _tokenize(line)
        if tokens[0] == "MATERIAL":
            _load_material(reader, scene, tokens[1])
        elif tokens[0] == "OBJECT":
            _load_geom(reader, scene, tokens[1])
        elif tokens[0] == "CAMERA":
            _load_camera(reader, scene)
    return scene


def _load_material(reader: _LineReader, scene: Scene, materialid: str) -> None:
    mid = int(materialid)
    if mid != len(scene.materials):
        raise ValueError(
            f"MATERIAL id {mid} does not match expected {len(scene.materials)}"
        )
    m = Material()
    for _ in range(7):
        tokens = _tokenize(reader.getline())
        key = tokens[0]
        if key == "RGB":
            m.color = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "SPECEX":
            m.specular_exponent = float(tokens[1])
        elif key == "SPECRGB":
            m.specular_color = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif key == "REFL":
            m.has_reflective = float(tokens[1])
        elif key == "REFR":
            m.has_refractive = float(tokens[1])
        elif key == "REFRIOR":
            m.index_of_refraction = float(tokens[1])
        elif key == "EMITTANCE":
            m.emittance = float(tokens[1])
    scene.materials.append(m)


def _load_geom(reader: _LineReader, scene: Scene, objectid: str) -> None:
    gid = int(objectid)
    if gid != len(scene.geoms):
        raise ValueError(f"OBJECT id {gid} does not match expected {len(scene.geoms)}")
    geom = Geom()
    obj_file = ""

    line = reader.getline().strip()
    if line == "sphere":
        geom.type = GeomType.SPHERE
    elif line == "cube":
        geom.type = GeomType.CUBE
    elif line == "triangle":
        geom.type = GeomType.TRIANGLE
    elif line == "obj":
        geom.type = GeomType.OBJ
        obj_file = reader.getline().strip()

    if geom.type != GeomType.OBJ:
        tokens = _tokenize(reader.getline())
        if tokens:
            geom.materialid = int(tokens[1])
    else:
        geom.materialid = -1  # synthesized later (scene.cpp:282)

    # Transform lines until blank; unknown tokens (e.g. the dead 'material'
    # line after an obj filename) are skipped, as in scene.cpp:286-299.
    line = reader.getline()
    while line.strip():
        tokens = _tokenize(line)
        if tokens[0] == "TRANS":
            geom.translation = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif tokens[0] == "ROTAT":
            geom.rotation = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif tokens[0] == "SCALE":
            geom.scale = np.array([float(t) for t in tokens[1:4]], np.float32)
        if not reader.good():
            break
        line = reader.getline()

    geom.finalize_transform()

    if geom.type == GeomType.OBJ:
        _load_obj_geom(scene, geom, obj_file)
    else:
        geom.face_count = 0
        scene.geoms.append(geom)
        scene.all_faces.append([])


def _resolve_asset(scene: Scene, path: str) -> str:
    """Resolve an asset path relative to the scene file's directory (the
    reference resolves relative to the CWD of the build dir; scene-relative is
    the portable equivalent for paths like ``../models/cube.obj``)."""
    if os.path.isabs(path) and os.path.isfile(path):
        return path
    scene_dir = os.path.dirname(scene.source_path)
    candidates = [
        os.path.normpath(os.path.join(scene_dir, path)),
        os.path.normpath(os.path.join(scene_dir, os.pardir, path)),
        os.path.normpath(os.path.join(scene_dir, "..", "models", os.path.basename(path))),
    ]
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"OBJ asset not found: {path} (searched {candidates})")


def _load_obj_geom(scene: Scene, geom: Geom, obj_file: str) -> None:
    path = _resolve_asset(scene, obj_file)
    mtl_dir = os.path.normpath(
        os.path.join(os.path.dirname(scene.source_path), os.pardir, "models", "materials")
    )
    model = obj_loader.load_obj(path, mtl_search_path=mtl_dir)
    geom.face_count = len(model.faces)
    geom.min_pos = model.min_pos
    geom.max_pos = model.max_pos
    geom.kd, geom.ks, geom.ke, geom.bump = model.kd, model.ks, model.ke, model.bump
    scene.all_faces.append(model.faces)
    scene.materials.append(obj_loader.synthesize_material(model.material))
    geom.materialid = len(scene.materials) - 1
    scene.geoms.append(geom)


def _load_camera(reader: _LineReader, scene: Scene) -> None:
    state: RenderState = scene.state
    cam: Camera = state.camera
    fovy = 45.0
    for _ in range(5):
        tokens = _tokenize(reader.getline())
        if tokens[0] == "RES":
            cam.resolution = (int(tokens[1]), int(tokens[2]))
        elif tokens[0] == "FOVY":
            fovy = float(tokens[1])
        elif tokens[0] == "ITERATIONS":
            state.iterations = int(tokens[1])
        elif tokens[0] == "DEPTH":
            state.trace_depth = int(tokens[1])
        elif tokens[0] == "FILE":
            state.image_name = tokens[1]

    line = reader.getline()
    while line.strip():
        tokens = _tokenize(line)
        if tokens[0] == "EYE":
            cam.position = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif tokens[0] == "LOOKAT":
            cam.look_at = np.array([float(t) for t in tokens[1:4]], np.float32)
        elif tokens[0] == "UP":
            cam.up = np.array([float(t) for t in tokens[1:4]], np.float32)
        if not reader.good():
            break
        line = reader.getline()

    cam.derive_fov(fovy)
    # The app rebuilds view/right/up before the first frame (main.cpp:222-240),
    # clobbering scene.cpp's partially-initialized values; reproduce that.
    cam.rebuild()
    state.alloc()
