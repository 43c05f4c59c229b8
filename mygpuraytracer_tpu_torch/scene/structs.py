"""Host-side scene state structures.

Field-for-field dataclass equivalents of the reference's POD state API
(apps/src/sceneStructs.h:10-121). These are the *host* representation produced
by the parser; ``device_scene.build_device_scene`` flattens them into static-
shape tensors for the device.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from . import transforms

BACKGROUND_COLOR = np.zeros(3, dtype=np.float32)  # sceneStructs.h:8


class GeomType(enum.IntEnum):
    """sceneStructs.h:10-15."""

    SPHERE = 0
    CUBE = 1
    TRIANGLE = 2
    OBJ = 3


@dataclasses.dataclass
class Texture:
    """sceneStructs.h:36-48. ``image`` is HxWxC uint8 (bottom-up, stb-style)."""

    width: int = 0
    height: int = 0
    channels: int = 0
    image: np.ndarray | None = None

    @property
    def present(self) -> bool:
        return self.channels > 0 and self.image is not None


@dataclasses.dataclass
class Material:
    """sceneStructs.h:72-82."""

    color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    specular_exponent: float = 0.0
    specular_color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    has_reflective: float = 0.0
    has_refractive: float = 0.0
    index_of_refraction: float = 0.0
    emittance: float = 0.0


@dataclasses.dataclass
class Face:
    """sceneStructs.h:29-34, flattened to arrays (positions/uvs per vertex)."""

    positions: np.ndarray  # [3,3]
    uvs: np.ndarray  # [3,2]
    normals: np.ndarray  # [3,3] vertex normals (loaded, unused for shading — parity)


@dataclasses.dataclass
class FaceArray:
    """A whole mesh's faces as arrays — the SoA form of list[Face].

    The reference keeps std::vector<Face> per geom (scene.h allFaces); array
    form scales to large meshes and feeds build_device_scene without
    restacking. Indexing yields Face views for API parity.
    """

    positions: np.ndarray  # [F,3,3]
    uvs: np.ndarray  # [F,3,2]

    def __len__(self) -> int:
        return self.positions.shape[0]

    def __getitem__(self, i: int) -> Face:
        return Face(
            positions=self.positions[i],
            uvs=self.uvs[i],
            normals=np.zeros((3, 3), np.float32),
        )

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @staticmethod
    def empty() -> "FaceArray":
        return FaceArray(
            positions=np.zeros((0, 3, 3), np.float32),
            uvs=np.zeros((0, 3, 2), np.float32),
        )

    @staticmethod
    def from_faces(faces: list) -> "FaceArray":
        if not faces:
            return FaceArray.empty()
        return FaceArray(
            positions=np.stack([f.positions for f in faces]).astype(np.float32),
            uvs=np.stack([f.uvs for f in faces]).astype(np.float32),
        )


@dataclasses.dataclass
class Geom:
    """sceneStructs.h:50-70 (device pointers replaced by indices)."""

    type: GeomType = GeomType.SPHERE
    materialid: int = -1
    translation: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    inverse_transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    inv_transpose: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    face_count: int = 0
    kd: Texture = dataclasses.field(default_factory=Texture)
    ks: Texture = dataclasses.field(default_factory=Texture)
    bump: Texture = dataclasses.field(default_factory=Texture)
    ke: Texture = dataclasses.field(default_factory=Texture)
    min_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    max_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))

    def finalize_transform(self) -> None:
        self.transform = transforms.build_transformation_matrix(
            self.translation, self.rotation, self.scale
        )
        self.inverse_transform = transforms.inverse(self.transform)
        self.inv_transpose = transforms.inverse_transpose(self.transform)


@dataclasses.dataclass
class Camera:
    """sceneStructs.h:84-93 plus the app-level rebuild of runCuda.

    The parser reproduces scene.cpp:364-374 (fov/pixelLength); ``rebuild``
    reproduces apps/src/main.cpp:222-240, which overwrites view/right/up from
    the eye->lookAt geometry with world up (0,1,0) before the first frame.
    """

    resolution: tuple[int, int] = (0, 0)  # (x, y)
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    look_at: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    view: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    right: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    fov: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float32))
    pixel_length: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float32))
    fovy: float = 45.0

    def derive_fov(self, fovy_deg: float) -> None:
        """scene.cpp:364-372."""
        self.fovy = fovy_deg
        xres, yres = self.resolution
        yscaled = math.tan(fovy_deg * math.pi / 180.0)
        xscaled = yscaled * xres / yres
        fovx = math.degrees(math.atan(xscaled))
        self.fov = np.array([fovx, fovy_deg], dtype=np.float32)
        self.pixel_length = np.array(
            [2.0 * xscaled / xres, 2.0 * yscaled / yres], dtype=np.float32
        )

    def rebuild(self) -> None:
        """main.cpp:222-240: reconstruct view/right/up from eye & lookAt.

        The app derives spherical coords (phi, theta) from view then rebuilds
        the eye position on that sphere around lookAt; for roll-free cameras
        this equals a plain look-at with world up (0,1,0), which is what we
        compute directly.
        """
        offset = np.asarray(self.position, np.float64) - np.asarray(self.look_at, np.float64)
        self.view = (-offset / np.linalg.norm(offset)).astype(np.float32)
        world_up = np.array([0.0, 1.0, 0.0])
        r = np.cross(self.view.astype(np.float64), world_up)
        self.right = r.astype(np.float32)
        self.up = np.cross(r, self.view.astype(np.float64)).astype(np.float32)


@dataclasses.dataclass
class RenderState:
    """sceneStructs.h:95-103."""

    camera: Camera = dataclasses.field(default_factory=Camera)
    iterations: int = 0
    trace_depth: int = 0
    image: np.ndarray | None = None  # accumulated beauty, HxWx3 f32
    albedo: np.ndarray | None = None
    output: np.ndarray | None = None  # denoised
    image_name: str = ""

    def alloc(self) -> None:
        xres, yres = self.camera.resolution
        shape = (yres, xres, 3)
        self.image = np.zeros(shape, np.float32)
        self.albedo = np.zeros(shape, np.float32)
        self.output = np.zeros(shape, np.float32)


@dataclasses.dataclass
class Scene:
    """Host scene: mirrors the public surface of apps/src/scene.h:12-32."""

    geoms: list[Geom] = dataclasses.field(default_factory=list)
    materials: list[Material] = dataclasses.field(default_factory=list)
    # all_faces[i] is the (possibly empty) face list of geoms[i], as in
    # Scene::allFaces (scene.h / scene.cpp:130,313).
    all_faces: list[list[Face]] = dataclasses.field(default_factory=list)
    state: RenderState = dataclasses.field(default_factory=RenderState)
    source_path: str = ""

    def set_resolution(self, width: int, height: int) -> None:
        """Re-derive the camera for a different resolution (keeps fovy).

        Handy for fast tests/benchmarks; the reference would require editing
        the scene file's RES line.
        """
        cam = self.state.camera
        cam.resolution = (width, height)
        cam.derive_fov(cam.fovy)
        self.state.alloc()
