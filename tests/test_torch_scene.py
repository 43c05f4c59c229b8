"""Host scenes and device scenes of the port against the JAX package.

Same inputs on both sides: the builtin factories with the same arguments,
the bundled scenes/*.txt, and a 12-face cube OBJ written into tmp_path.
Tolerance: exact equality for everything the port copies or computes in the
same float32/float64 steps; mesh faces are compared as sets by the generic
scene comparison, and in order by the OBJ tests below (both packages parse
with the C++ loader, which Morton-orders them; without a host compiler the
port parses in Python, in file order).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene import builtin as jax_builtin
from mygpuraytracer_tpu.scene import transforms as jax_transforms
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene import builtin, transforms
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE_FILES = sorted(p.name for p in (REPO / "scenes").glob("*.txt"))
MISSING_ASSET = {"cornellCottage.txt": "its OBJ lives outside the repository (scenes/cornellCottage.txt:144)"}

CUBE_V = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
          (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
CUBE_F = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]


def write_cube_scene(d: pathlib.Path) -> str:
    """Cornell box plus a 12-face cube OBJ (6 quads, fan-triangulated)."""
    (d / "cube.obj").write_text(
        "mtllib cube.mtl\n" + "".join(f"v {x} {y} {z}\n" for x, y, z in CUBE_V)
        + "".join("f " + " ".join(map(str, f)) + "\n" for f in CUBE_F))
    (d / "cube.mtl").write_text("newmtl cube\nKd 0.8 0.6 0.2\nKs 0.9 0.9 0.9\nNi 1.5\n")
    text = (REPO / "scenes/builtin_cornell.txt").read_text().rstrip()
    text += "\n\nOBJECT 7\nobj\ncube.obj\nTRANS 2 2 0\nROTAT 0 30 0\nSCALE 1.2 1.2 1.2\n"
    (d / "cube.txt").write_text(text)
    return str(d / "cube.txt")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _assert_same(a, b, where=""):
    """Recursive field-by-field equality of dataclasses, lists and arrays."""
    if hasattr(a, "positions") and hasattr(a, "uvs"):  # FaceArray: order-insensitive
        _assert_same_faces(a, b, where)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _sorted_faces(fa) -> np.ndarray:
    rows = np.concatenate([fa.positions.reshape(len(fa), -1), fa.uvs.reshape(len(fa), -1)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def _assert_same_faces(a, b, where):
    assert len(a) == len(b), where
    np.testing.assert_array_equal(_sorted_faces(a), _sorted_faces(b), err_msg=where)


def _assert_same_scene(js, ts):
    assert ts.source_path == js.source_path
    _assert_same(js.materials, ts.materials, "materials")
    _assert_same(js.state, ts.state, "state")
    assert len(js.geoms) == len(ts.geoms)
    for i, (jg, tg) in enumerate(zip(js.geoms, ts.geoms)):
        _assert_same(jg, tg, f"geoms[{i}]")
    for i, (jf, tf) in enumerate(zip(js.all_faces, ts.all_faces)):
        if len(jf) or len(tf):
            _assert_same_faces(jf, tf, f"all_faces[{i}]")


@pytest.mark.parametrize("name", ["cornell", "cornellGlass", "sphere"])
def test_builtin_scenes_match(name):
    kw = dict(resolution=(96, 64), iterations=7, depth=5)
    _assert_same_scene(jax_builtin.BUILTIN_SCENES[name](**kw), builtin.BUILTIN_SCENES[name](**kw))


@pytest.mark.parametrize("fname", SCENE_FILES)
def test_bundled_scene_files_match(fname):
    if fname in MISSING_ASSET:
        pytest.skip(MISSING_ASSET[fname])
    path = str(REPO / "scenes" / fname)
    _assert_same_scene(jax_load_scene(path), load_scene(path))


def test_cube_obj_scene_matches(tmp_path):
    path = write_cube_scene(tmp_path)
    js, ts = jax_load_scene(path), load_scene(path)
    _assert_same_scene(js, ts)
    assert len(ts.all_faces[-1]) == 12


@pytest.mark.parametrize("obj", ["spaceship_tex.obj", "spaceship.obj"])
def test_obj_faces_in_jax_order(obj):
    """The port's loader lays the faces out in the JAX package's order, so
    the clusters and plane-form buffers built from them are the same."""
    from mygpuraytracer_tpu.scene.obj_loader import load_obj as jax_load_obj
    from mygpuraytracer_tpu_torch.scene.obj_loader import load_obj

    path = str(REPO / "scenes/models" / obj)
    a, b = jax_load_obj(path).faces, load_obj(path).faces
    np.testing.assert_array_equal(b.positions, a.positions)
    np.testing.assert_array_equal(b.uvs, a.uvs)


def test_python_parse_equals_native_file_order():
    """The fallback parser (no host compiler) reads what the C++ loader
    reads, in file order."""
    from mygpuraytracer_tpu_torch.scene.native_loader import native_parse_obj
    from mygpuraytracer_tpu_torch.scene.obj_loader import _python_parse_geometry

    path = str(REPO / "scenes/models/spaceship_tex.obj")
    native = native_parse_obj(path, morton_order=False)
    assert native is not None
    for a, b in zip(_python_parse_geometry(path), native):
        np.testing.assert_array_equal(a, b)


def test_transforms_match():
    gen = np.random.default_rng(1)
    for _ in range(20):
        t, r, s = gen.normal(size=3), gen.uniform(-180, 180, 3), gen.uniform(0.1, 3, 3)
        m = transforms.build_transformation_matrix(t, r, s)
        np.testing.assert_array_equal(m, jax_transforms.build_transformation_matrix(t, r, s))
        np.testing.assert_array_equal(transforms.inverse(m), jax_transforms.inverse(m))
        np.testing.assert_array_equal(transforms.inverse_transpose(m),
                                      jax_transforms.inverse_transpose(m))


DEVICE_FIELDS = [
    "geom_type", "geom_material", "transform", "inverse_transform", "inv_transpose",
    "aabb_min", "aabb_max", "geom_kd", "geom_ks", "geom_ke", "geom_bump",
    "face_v0", "face_e1", "face_e2", "face_uv0", "face_uv1", "face_uv2", "face_geom",
    "mat_color", "mat_spec_color", "mat_spec_ex", "mat_refl", "mat_refr", "mat_ior",
    "mat_emittance",
]
META_FIELDS = [
    "resolution", "trace_depth", "iterations", "image_name", "num_geoms", "num_faces",
    "has_obj", "has_textures", "face_ranges", "geoms", "mega_faces", "mesh_clusters",
    "cluster_size", "tex_table",
]


def _scene(kind, tmp_path, pkg):
    if kind == "cube":
        load = jax_load_scene if pkg == "jax" else load_scene
        s = load(write_cube_scene(tmp_path))
        s.set_resolution(64, 48)
        return s
    mod = jax_builtin if pkg == "jax" else builtin
    return mod.BUILTIN_SCENES[kind](resolution=(64, 48))


@pytest.mark.parametrize("kind", ["cornell", "cornellGlass", "cube"])
def test_device_scene_matches(kind, tmp_path):
    jdev, jmeta = jax_build(_scene(kind, tmp_path, "jax"))
    tdev, tmeta = build_device_scene(_scene(kind, tmp_path, "torch"), device="cpu")
    for f in DEVICE_FIELDS:
        np.testing.assert_array_equal(getattr(tdev, f).numpy(), np.asarray(getattr(jdev, f)),
                                      err_msg=f)
    for f in ("position", "view", "up", "right", "pixel_length"):
        np.testing.assert_array_equal(getattr(tdev.camera, f).numpy(),
                                      np.asarray(getattr(jdev.camera, f)), err_msg=f)
    for f in META_FIELDS:
        j, t = getattr(jmeta, f), getattr(tmeta, f)
        if f == "geoms":
            for jg, tg in zip(j, t):
                assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
        else:
            assert j == t, f
    if kind == "cube":
        assert tmeta.num_faces == 12 and len(tmeta.mega_faces) == 12
