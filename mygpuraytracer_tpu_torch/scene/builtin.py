"""Built-in scenes constructed programmatically.

The framework ships the canonical Cornell-box family as code so demos,
benchmarks and the graft entry points run without any scene files on disk.
Values match the bundled reference scenes (scenes/cornell.txt etc.).
"""

from __future__ import annotations

import numpy as np

from .structs import Camera, Geom, GeomType, Material, RenderState, Scene


def _material(color, spec_ex=0.0, spec=(0, 0, 0), refl=0.0, refr=0.0, ior=0.0, emit=0.0):
    return Material(
        color=np.asarray(color, np.float32),
        specular_exponent=spec_ex,
        specular_color=np.asarray(spec, np.float32),
        has_reflective=refl,
        has_refractive=refr,
        index_of_refraction=ior,
        emittance=emit,
    )


def _geom(gtype, mat_id, trans, rot, scale):
    g = Geom(type=gtype, materialid=mat_id)
    g.translation = np.asarray(trans, np.float32)
    g.rotation = np.asarray(rot, np.float32)
    g.scale = np.asarray(scale, np.float32)
    g.finalize_transform()
    return g


def _camera(scene: Scene, res=(800, 800), fovy=45.0, iters=5000, depth=8, name="cornell",
            eye=(0.0, 5.0, 10.5), look_at=(0.0, 5.0, 0.0)):
    st: RenderState = scene.state
    cam: Camera = st.camera
    cam.resolution = tuple(res)
    cam.position = np.asarray(eye, np.float32)
    cam.look_at = np.asarray(look_at, np.float32)
    cam.up = np.array([0, 1, 0], np.float32)
    st.iterations = iters
    st.trace_depth = depth
    st.image_name = name
    cam.derive_fov(fovy)
    cam.rebuild()
    st.alloc()


def cornell_box(resolution=(800, 800), iterations=5000, depth=8) -> Scene:
    """The classic Cornell box: area light, white/red/green walls, white
    sphere (matches scenes/cornell.txt)."""
    s = Scene(source_path="<builtin:cornell>")
    s.materials = [
        _material((1, 1, 1), emit=5.0),  # 0 light
        _material((0.98, 0.98, 0.98)),  # 1 diffuse white
        _material((0.85, 0.35, 0.35)),  # 2 diffuse red
        _material((0.35, 0.85, 0.35)),  # 3 diffuse green
        _material((0.98, 0.98, 0.98), spec=(0.98, 0.98, 0.98), refl=1.0),  # 4 mirror
    ]
    s.geoms = [
        _geom(GeomType.CUBE, 0, (0, 10, 0), (0, 0, 0), (3, 0.3, 3)),  # light
        _geom(GeomType.CUBE, 1, (0, 0, 0), (0, 0, 0), (10, 0.01, 10)),  # floor
        _geom(GeomType.CUBE, 1, (0, 10, 0), (0, 0, 90), (0.01, 10, 10)),  # ceiling
        _geom(GeomType.CUBE, 1, (0, 5, -5), (0, 90, 0), (0.01, 10, 10)),  # back
        _geom(GeomType.CUBE, 2, (-5, 5, 0), (0, 0, 0), (0.01, 10, 10)),  # left red
        _geom(GeomType.CUBE, 3, (5, 5, 0), (0, 0, 0), (0.01, 10, 10)),  # right green
        _geom(GeomType.SPHERE, 1, (-1, 4, -1), (0, 0, 0), (3, 3, 3)),  # sphere
    ]
    s.all_faces = [[] for _ in s.geoms]
    _camera(s, res=resolution, iters=iterations, depth=depth)
    return s


def cornell_glass(resolution=(800, 800), iterations=5000, depth=8) -> Scene:
    """Cornell box with a refractive sphere (cf. scenes/cornellGlass.txt)."""
    s = cornell_box(resolution, iterations, depth)
    s.materials.append(
        _material((0.98, 0.98, 0.98), spec=(0.85, 0.85, 0.98), refr=1.0, ior=1.65)
    )
    s.geoms.append(
        _geom(GeomType.SPHERE, len(s.materials) - 1, (2, 2.5, 2), (0, 0, 0), (3, 3, 3))
    )
    s.all_faces.append([])
    s.state.image_name = "cornellGlass"
    return s


def emissive_sphere(resolution=(800, 800), iterations=5000, depth=8) -> Scene:
    """A single emissive sphere (matches scenes/sphere.txt)."""
    s = Scene(source_path="<builtin:sphere>")
    s.materials = [_material((1, 1, 1), emit=5.0)]
    s.geoms = [_geom(GeomType.SPHERE, 0, (0, 0, 0), (0, 0, 0), (3, 3, 3))]
    s.all_faces = [[]]
    _camera(s, res=resolution, iters=iterations, depth=depth, name="sphere")
    return s


BUILTIN_SCENES = {
    "cornell": cornell_box,
    "cornellGlass": cornell_glass,
    "sphere": emissive_sphere,
}
