"""The port's wavefront against the JAX package's, and its Renderer against
the committed goldens.

Same scene, same seed and iteration on both sides; the JAX side runs its
wavefront on the CPU (megakernel off, threefry RNG). The port draws the same
threefry numbers (ops/rng.py), so the comparison is tight: rmse < 1e-3 on the
color (measured 0: bit-identical on the CPU), and the first-hit AOVs within
1e-4 (XLA and torch may round a normalization differently). The goldens in
tests/golden/ are JAX wavefront renders at seed 0 (tests/test_golden.py);
the port is held to the same bar, rmse < 1e-3 (measured 0).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mygpuraytracer_tpu.config import RenderOptions as JaxOptions
from mygpuraytracer_tpu.render.pathtrace import make_empty_cache
from mygpuraytracer_tpu.render.pathtrace import render_sample as jax_render_sample
from mygpuraytracer_tpu.scene import builtin as jax_builtin
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import rng
from mygpuraytracer_tpu_torch.ops.trace import intersect_soa, primitives_hit
from mygpuraytracer_tpu_torch.render.camera import generate_camera_rays
from mygpuraytracer_tpu_torch.render import Renderer
from mygpuraytracer_tpu_torch.render.pathtrace import render_sample
from mygpuraytracer_tpu_torch.scene import builtin
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
RES = 64
RMSE_TOL = 1e-3
AOV_TOL = 1e-4

_jit_render_sample = jax.jit(jax_render_sample, static_argnums=(1, 2))


def write_cube_scene(d: pathlib.Path) -> str:
    """Cornell box plus a 12-face cube OBJ (6 quads, fan-triangulated)."""
    v = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    f = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    (d / "cube.obj").write_text(
        "mtllib cube.mtl\n" + "".join(f"v {x} {y} {z}\n" for x, y, z in v)
        + "".join("f " + " ".join(map(str, q)) + "\n" for q in f))
    (d / "cube.mtl").write_text("newmtl cube\nKd 0.8 0.6 0.2\nKs 0.9 0.9 0.9\nNi 1.5\n")
    text = (REPO / "scenes/builtin_cornell.txt").read_text().rstrip()
    text += "\n\nOBJECT 7\nobj\ncube.obj\nTRANS 2 2 0\nROTAT 0 30 0\nSCALE 1.2 1.2 1.2\n"
    (d / "cube.txt").write_text(text)
    return str(d / "cube.txt")


CASES = {
    "cornell": ("cornell", {}),
    "cornellGlass": ("cornellGlass", {}),
    "dof": ("cornell", {"depth_of_field": True, "focal_distance": 11.0}),
    "cubeObj": ("cube", {}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scenes(kind, tmp_path):
    if kind == "cube":
        path = write_cube_scene(tmp_path)
        js, ts = jax_load_scene(path), load_scene(path)
    else:
        js = jax_builtin.BUILTIN_SCENES[kind]()
        ts = builtin.BUILTIN_SCENES[kind]()
    js.set_resolution(RES, RES)
    ts.set_resolution(RES, RES)
    return js, ts


def _np3(v) -> np.ndarray:
    return np.stack([np.asarray(c) for c in v])


@pytest.mark.parametrize("case", list(CASES))
def test_render_sample_matches_jax(case, tmp_path):
    kind, opts = CASES[case]
    js, ts = _scenes(kind, tmp_path)
    jdev, jmeta = jax_build(js)
    tdev, tmeta = build_device_scene(ts, device="cpu")
    for iteration, seed in ((1, 0), (2, 0), (3, 11)):
        jout = _jit_render_sample(jdev, jmeta, JaxOptions(megakernel=False, **opts),
                                  jnp.int32(iteration), jax.random.key(seed),
                                  make_empty_cache(RES * RES))
        tout = render_sample(tdev, tmeta, RenderOptions(**opts), iteration, rng.make_key(seed))
        a, b = _np3(jout.color), _np3([c.numpy() for c in tout.color])
        err = float(np.sqrt(np.mean((a - b) ** 2)))
        assert err < RMSE_TOL, f"{case} iteration {iteration}: rmse {err}"
        for name in ("albedo", "normal"):
            ja, ta = _np3(getattr(jout, name)), _np3([c.numpy() for c in getattr(tout, name)])
            assert np.abs(ja - ta).max() < AOV_TOL, (case, iteration, name)
        assert np.isfinite(b).all() and b.mean() > 0


def test_primitives_hit_matches_intersect_soa(tmp_path):
    """The listed-face test that K1 runs equals the chunked mesh path."""
    _, ts = _scenes("cube", tmp_path)
    dev, meta = build_device_scene(ts, device="cpu")
    U = rng.uniform(rng.iteration_key(rng.make_key(0), 1), (28, RES * RES))
    o, d = generate_camera_rays(dev.camera, meta.resolution, RenderOptions(), U)
    a, b = primitives_hit(meta, o, d), intersect_soa(meta, dev, o, d)
    assert torch.equal(a.t, b.t) and torch.equal(a.is_obj, b.is_obj)
    assert int(a.is_obj.sum()) > 0
    for x, y in zip(a.normal, b.normal):
        assert float((x - y).abs().max()) < 1e-6
    assert torch.equal(a.material_id, b.material_id)


MESH_SCENES = ["cornellShip", "shipTexOnly"]


@pytest.mark.parametrize("name", MESH_SCENES)
def test_render_sample_matches_jax_on_big_meshes(name):
    """The 23,328-face ship, untextured in the Cornell box and textured and
    bump-mapped alone, at 16x16 with the CPU defaults (the chunked
    Moller-Trumbore stream on both sides): the color bit for bit, the
    first-hit AOVs within the module's 1e-4 (measured 9e-6: XLA and torch
    round a normalization differently)."""
    path = str(REPO / f"scenes/{name}.txt")
    js, ts = jax_load_scene(path), load_scene(path)
    js.set_resolution(16, 16)
    ts.set_resolution(16, 16)
    jdev, jmeta = jax_build(js)
    tdev, tmeta = build_device_scene(ts, device="cpu")
    assert tmeta.num_faces > 256 and tmeta.has_textures == (name == "shipTexOnly")
    for iteration, seed in ((1, 0), (2, 5)):
        jout = _jit_render_sample(jdev, jmeta, JaxOptions(megakernel=False),
                                  jnp.int32(iteration), jax.random.key(seed),
                                  make_empty_cache(16 * 16))
        tout = render_sample(tdev, tmeta, RenderOptions(), iteration, rng.make_key(seed))
        np.testing.assert_array_equal(_np3([c.numpy() for c in tout.color]), _np3(jout.color))
        for field in ("albedo", "normal"):
            a = _np3(getattr(jout, field))
            b = _np3([c.numpy() for c in getattr(tout, field)])
            assert np.abs(a - b).max() < AOV_TOL, (name, iteration, field)
        assert _np3([c.numpy() for c in tout.color]).mean() > 0


GOLDEN_CASES = [
    ("cornell_64_32spp", lambda: builtin.cornell_box(resolution=(64, 64)), 32, RenderOptions()),
    ("cornellGlass_64_32spp", lambda: builtin.cornell_glass(resolution=(64, 64)), 32,
     RenderOptions()),
    ("cornellDof_64_16spp", lambda: builtin.cornell_box(resolution=(64, 64)), 16,
     RenderOptions(depth_of_field=True, focal_distance=11.0)),
    ("shipOnly_32_4spp", lambda: _scene_at("shipOnly", 32), 4, RenderOptions()),
    ("shipTexOnly_32_4spp", lambda: _scene_at("shipTexOnly", 32), 4, RenderOptions()),
]


def _scene_at(name, res):
    scene = load_scene(str(REPO / f"scenes/{name}.txt"))
    scene.set_resolution(res, res)
    return scene


@pytest.mark.parametrize("name,maker,spp,opts", GOLDEN_CASES, ids=[c[0] for c in GOLDEN_CASES])
def test_renderer_matches_golden(name, maker, spp, opts):
    golden = np.load(GOLDEN / f"{name}.npy")
    r = Renderer(maker(), opts, seed=0, device="cpu")
    r.render(iterations=spp, batch=min(spp, 8))
    err = float(np.sqrt(np.mean((r.beauty() - golden) ** 2)))
    assert err < RMSE_TOL, f"golden drift: rmse={err}"


def test_rows_tier_render_meets_golden():
    """The textured ship through the rows tier (the plain version of the
    mesh kernel) against the golden that Moller-Trumbore made. Plane form
    and Moller-Trumbore agree up to float edge cases, and a ray that grazes
    an edge takes another path, so the pixel-share rule of chip_smoke.py applies: < 1% of
    pixels off by more than 1e-2, rmse < 1e-3 over the rest."""
    golden = np.load(GOLDEN / "shipTexOnly_32_4spp.npy")
    r = Renderer(_scene_at("shipTexOnly", 32), RenderOptions(mesh_pallas=True, mesh_tier="rows"),
                 seed=0, device="cpu")
    assert r.options.winner_table == "f32"
    r.render(iterations=4, batch=4)
    diff = np.abs(r.beauty() - golden)
    agree = diff.max(axis=-1) <= 1e-2
    assert (~agree).mean() < 0.01, f"share of pixels off by > 1e-2: {(~agree).mean()}"
    assert float(np.sqrt(np.mean(diff[agree] ** 2))) < RMSE_TOL
