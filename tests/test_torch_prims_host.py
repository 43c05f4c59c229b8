"""The wavefront's primitive kernel (csrc/prims_hit.cu) off the card: its
table, its source compiled for the host, and the dispatch around it.

The CUDA kernel has no CPU mode. These tests compile csrc/prims_hit.cu
with the host C++ compiler under the stand-in header of
tests/test_torch_k5_host.py (the _rn intrinsics as plain IEEE operations,
rsqrtf as 1/sqrtf, which is what PyTorch's CPU rsqrt computes), its launch
a loop over blocks and threads, built with -ffp-contract=off. So the
kernel's own arithmetic runs: it must equal ``ops/trace.py::
intersect_primitives_soa`` on CPU tensors bit for bit in every output
field, with torch.sqrt correctly rounded and torch.rsqrt as 1/sqrt, as on
the card and in the stand-in (PyTorch's CPU sqrt is not correctly rounded
on every host: on an AVX-512 one it gives 0.48171672 for the root of
0x3e6d9ec8, whose correct rounding is 0.48171675), on

- the rays of every bounce of a cornellShipTex iteration, cornell's camera
  rays and random rays, a sphere-only scene;
- hand-made rays in a scene of two identical unit cubes (every hit of
  one a tie with the other: the first wins), a rotated cube and a sphere:
  origins inside a box, directions with zero components and origins on a
  slab's plane (0/0 in the slab test), grazing rays along faces and
  tangent to the sphere, and a zero direction;
- a table without cubes or spheres (the miss state).

The table decoded back gives the geoms' transforms and material constants;
``nearest_primitives`` runs the plain function on CPU tensors and launches
nothing; ``intersect_soa`` and a whole wavefront iteration with the host
build's rows in place of the plain function (what the CUDA branch of
``nearest_primitives`` does) give the plain results bit for bit. The card
itself is checked by tests/test_torch_prims_cuda.py and chip_smoke.py.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prims_hit as ph
from mygpuraytracer_tpu_torch.ops import trace
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import Renderer, graphs, pathtrace
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import (PRIM_COLS, PRIM_INTS, PRIM_INV,
                                                          PRIM_INVT, PRIM_MAT, PRIM_TYPE,
                                                          PRIM_XFORM, build_device_scene)
from mygpuraytracer_tpu_torch.scene.structs import GeomType
from test_torch_k5_host import REPO, _host_build

LAUNCH = re.compile(
    r"prims_hit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);",
    re.S)
LOOP = (r"(void)stream; blockDim.x = THREADS; for (int b_ = 0; b_ < blocks; ++b_)"
        r" for (int t_ = 0; t_ < THREADS; ++t_) { blockIdx.x = b_; threadIdx.x = t_;"
        r" prims_hit_kernel(\1); }")

# Two identical unit cubes at the origin (materials 1 and 2), a sphere of
# radius 0.5 at (2, 0, 0), a rotated, scaled cube.
HAND_SCENE = """MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

MATERIAL 1
RGB         0.85 0.35 0.35
SPECEX      3
SPECRGB     0.5 0.5 0.5
REFL        1
REFR        0
REFRIOR     1.5
EMITTANCE   0

MATERIAL 2
RGB         0.35 0.85 0.35
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        1
REFRIOR     1.33
EMITTANCE   0

CAMERA
RES         8 8
FOVY        45
ITERATIONS  4
DEPTH       8
FILE        hand
EYE         0 0 6
LOOKAT      0 0 0
UP          0 1 0

OBJECT 0
cube
material 1
TRANS       0 0 0
ROTAT       0 0 0
SCALE       1 1 1

OBJECT 1
cube
material 2
TRANS       0 0 0
ROTAT       0 0 0
SCALE       1 1 1

OBJECT 2
sphere
material 0
TRANS       2 0 0
ROTAT       0 0 0
SCALE       1 1 1

OBJECT 3
cube
material 1
TRANS       -3 1 0
ROTAT       30 45 0
SCALE       1 2 0.5
"""

SCENES = {"cornell": "scenes/builtin_cornell.txt", "cornellShipTex": "scenes/cornellShipTex.txt",
          "sphere": "scenes/builtin_sphere.txt", "shipTexOnly": "scenes/shipTexOnly.txt"}
FLOATS = ("t", "spec_ex", "refl", "refr", "ior", "emit", "u", "v")
INTS = ("mat_id", "kd", "ks", "ke", "bump")
VECS = ("normal", "color", "spec")


@pytest.fixture(scope="module")
def host_prims(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "prims_hit.cu", LAUNCH, LOOP, "primshost")
    lib.prims_hit.restype, lib.prims_hit.argtypes = _build.SIGNATURES["prims_hit"]
    return lib


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def ieee_roots(monkeypatch):
    """torch.sqrt correctly rounded and torch.rsqrt as 1/sqrt (NumPy's
    roots), as the stand-in computes sqrtf and rsqrtf."""
    def sqrt(x):
        return torch.as_tensor(np.sqrt(x.numpy()))

    def rsqrt(x):
        with np.errstate(divide="ignore"):
            return torch.as_tensor(np.float32(1.0) / np.sqrt(x.numpy()))

    monkeypatch.setattr(torch, "sqrt", sqrt)
    monkeypatch.setattr(torch, "rsqrt", rsqrt)


_LOADED = {}


def scene_file(name, tmp_dir=None):
    if name == "hand":
        path = tmp_dir / "hand.txt"
        path.write_text(HAND_SCENE)
        return str(path)
    return str(REPO / SCENES[name])


def device_scene(name, tmp_dir=None, device="cpu"):
    key = (name, device)
    if key not in _LOADED:
        _LOADED[key] = build_device_scene(load_scene(scene_file(name, tmp_dir)), device=device)
    return _LOADED[key]


def vec(a, device="cpu"):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i], np.float32)).to(device)
                  for i in range(3)))


def random_rays(n, seed, lo=-6.0, hi=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def hand_rays(kind, n=256, seed=5):
    """Rays for the hand-made scene (HAND_SCENE), by ``kind``."""
    rng = np.random.default_rng(seed)
    axes = np.eye(3, dtype=np.float32)
    dirs = np.concatenate([axes, -axes])
    if kind == "inside":  # origins inside the unit cubes
        o = rng.uniform(-0.45, 0.45, size=(n, 3))
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif kind == "axis":  # directions with zero components, origins on slab planes
        o = rng.uniform(-2.0, 2.0, size=(n, 3))
        d = dirs[rng.integers(0, 6, n)]
        plane = rng.integers(0, 3, n)
        side = rng.choice([-0.5, 0.5], n)
        on = rng.random(n) < 0.5
        o[on, plane[on]] = side[on]
        # keep the direction parallel to that plane where the origin is on it
        par = on & (np.abs(d[np.arange(n), plane]) > 0)
        d[par] = np.roll(d[par], 1, axis=1)
    elif kind == "grazing":  # along the cubes' faces and edges, tangent to the sphere
        t = rng.uniform(-0.5, 0.5, n)
        o = np.zeros((n, 3))
        d = np.zeros((n, 3))
        k = np.arange(n) % 4
        o[k == 0] = np.stack([np.full(n, -3.0), np.full(n, 0.5), t], 1)[k == 0]
        d[k == 0] = (1.0, 0.0, 0.0)
        o[k == 1] = np.stack([t, np.full(n, -0.5), np.full(n, 4.0)], 1)[k == 1]
        d[k == 1] = (0.0, 0.0, -1.0)
        o[k == 2] = np.stack([np.full(n, 2.0), np.full(n, 0.5), np.full(n, -3.0)], 1)[k == 2]
        d[k == 2] = (0.0, 0.0, 1.0)
        o[k == 3] = np.stack([np.full(n, -4.0), np.full(n, 0.5), np.full(n, 0.5)], 1)[k == 3]
        d[k == 3] = (1.0, 0.0, 0.0)
    elif kind == "zero_dir":  # no direction at all, and rays from far away
        o, d = random_rays(n, seed, -4.0, 4.0)
        d[::3] = 0.0
        o[1::3] *= 1e6
    else:
        raise ValueError(kind)
    return o.astype(np.float32), d.astype(np.float32)


def recorded_queries(name, res, device="cpu", options=None, seed=3):
    """(o, d) of every scene query of one wavefront iteration of scene
    ``name`` at res x res: the camera rays, then each later bounce's."""
    scene = load_scene(scene_file(name))
    scene.set_resolution(res, res)
    r = Renderer(scene, options or RenderOptions(megakernel=False), seed=seed, device=device)
    seen = []
    orig = pathtrace.intersect_soa

    def record(meta, dev, o, d, *a, **k):
        seen.append((Vec3(*(c.clone() for c in o)), Vec3(*(c.clone() for c in d))))
        return orig(meta, dev, o, d, *a, **k)

    pathtrace.intersect_soa = record
    try:
        with graphs.disabled():  # on CUDA, no capture after the eager iteration
            r.step()
    finally:
        pathtrace.intersect_soa = orig
    return seen


def host_rows(lib, table, o: Vec3, d: Vec3):
    """The host build's (rows_f, rows_i, zero), laid out as ph.prims_hit's."""
    n = o.x.shape[0]
    rows_f = torch.full((ph.OUT_F, n), float("nan"))
    rows_i = torch.full((ph.OUT_I, n), -7, dtype=torch.int32)
    zero = torch.full((1,), float("nan"))
    lanes = (*o, *d)
    err = lib.prims_hit(*(c.data_ptr() for c in lanes), *(c.stride(0) for c in lanes),
                        table.data_ptr(), table.shape[0], rows_f.data_ptr(), rows_i.data_ptr(),
                        zero.data_ptr(), n, None)
    assert err == 0
    return rows_f, rows_i, zero


def decode_primitive_table(table) -> list[dict]:
    """The table's rows back as dicts of GeomStatic's field names (the
    matrices as 3x4 / 3x3 nested lists of floats)."""
    table = table.numpy()
    ints = table.view(np.int32)
    rows = []
    for f, i in zip(table, ints):
        mat = [float(x) for x in f[PRIM_MAT:PRIM_INTS]]
        rows.append(dict(
            type=int(i[PRIM_TYPE]),
            inverse_transform=f[PRIM_INV:PRIM_XFORM].reshape(3, 4).tolist(),
            transform=f[PRIM_XFORM:PRIM_INVT].reshape(3, 4).tolist(),
            inv_transpose=f[PRIM_INVT:PRIM_MAT].reshape(3, 3).tolist(),
            color=tuple(mat[0:3]), spec_color=tuple(mat[3:6]), spec_exponent=mat[6],
            has_reflective=mat[7], has_refractive=mat[8], ior=mat[9], emittance=mat[10],
            **dict(zip(("material_id", "kd", "ks", "ke", "bump"),
                       (int(x) for x in i[PRIM_INTS:PRIM_COLS])))))
    return rows


def assert_running_equal(a, b):
    """Every field of two running states equal bit for bit."""
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    for name in FLOATS + INTS + ("is_obj",):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(bits(x), bits(y)), name
    for name in VECS:
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert torch.equal(bits(x), bits(y)), name


def assert_hits_equal(a, b):
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    for name, x in a._asdict().items():
        y = getattr(b, name)
        pairs = zip(x, y) if isinstance(x, Vec3) else [(x, y)]
        for xi, yi in pairs:
            assert xi.dtype == yi.dtype and torch.equal(bits(xi), bits(yi)), name


@pytest.mark.parametrize("name", ["cornell", "cornellShipTex", "sphere", "hand", "shipTexOnly"])
def test_table_decodes_to_the_geoms(name, tmp_path):
    dev, meta = device_scene(name, tmp_path)
    prims = [g for g in meta.geoms if g.type in (GeomType.CUBE, GeomType.SPHERE)]
    assert dev.prim_table.dtype == torch.float32 and dev.prim_table.is_contiguous()
    assert tuple(dev.prim_table.shape) == (len(prims), PRIM_COLS)
    rows = decode_primitive_table(dev.prim_table)
    f32 = lambda x: float(np.float32(x))
    for g, row in zip(prims, rows):
        assert row["type"] == g.type
        rows3 = lambda m, cols: [[f32(x) for x in r[:cols]] for r in m[:3]]
        assert row["inverse_transform"] == rows3(g.inverse_transform, 4)
        assert row["transform"] == rows3(g.transform, 4)
        assert row["inv_transpose"] == rows3(g.inv_transpose, 3)
        for key in ("color", "spec_color"):
            assert row[key] == tuple(f32(x) for x in getattr(g, key)), key
        for key in ("spec_exponent", "has_reflective", "has_refractive", "ior", "emittance"):
            assert row[key] == f32(getattr(g, key)), key
        for key in ("material_id", "kd", "ks", "ke", "bump"):
            assert row[key] == getattr(g, key), key
    expected = {"cornell": 7, "cornellShipTex": 8, "sphere": 1, "hand": 4, "shipTexOnly": 1}
    assert len(rows) == expected[name]


def test_kernel_layout_constants_match_the_python_side():
    """csrc/prims_hit.cu's table offsets are scene/device_scene.py's PRIM_*,
    and its output row counts ops/prims_hit.py's OUT_F and OUT_I."""
    src = (REPO / "mygpuraytracer_tpu_torch/csrc/prims_hit.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b((?:PRIM|OUT)_[A-Z]+) = (\d+)", src)}
    assert consts == dict(PRIM_TYPE=PRIM_TYPE, PRIM_INV=PRIM_INV, PRIM_XFORM=PRIM_XFORM,
                          PRIM_INVT=PRIM_INVT, PRIM_MAT=PRIM_MAT, PRIM_INTS=PRIM_INTS,
                          PRIM_COLS=PRIM_COLS, OUT_T=0, OUT_N=1, OUT_MAT=4, OUT_F=ph.OUT_F,
                          OUT_I=ph.OUT_I)
    assert re.search(r"\bSPHERE = %d, CUBE = %d;" % (GeomType.SPHERE, GeomType.CUBE), src)
    mat_floats = int(re.search(r"\bMAT_FLOATS = (\d+)", src).group(1))
    assert mat_floats == PRIM_INTS - PRIM_MAT == ph.OUT_F - 4


def _check_host_kernel(lib, meta, dev, o, d):
    plain = trace.intersect_primitives_soa(meta, o, d)
    kernel = trace._Running.from_rows(*host_rows(lib, dev.prim_table, o, d))
    assert_running_equal(kernel, plain)
    return plain


@pytest.mark.parametrize("bounce", range(8))
def test_host_kernel_equals_plain_on_each_bounce(ieee_roots, host_prims, bounce):
    dev, meta = device_scene("cornellShipTex")
    queries = _cornell_ship_tex_queries()
    assert len(queries) == 8
    plain = _check_host_kernel(host_prims, meta, dev, *queries[bounce])
    assert int(torch.isfinite(plain.t).sum()) > 0


_QUERIES = []


def _cornell_ship_tex_queries():
    if not _QUERIES:
        _QUERIES.extend(recorded_queries("cornellShipTex", 12))
    return _QUERIES


@pytest.mark.parametrize("name,rays", [("cornell", "camera"), ("cornell", "random"),
                                       ("sphere", "random"), ("shipTexOnly", "random")])
def test_host_kernel_equals_plain_on_scenes(ieee_roots, host_prims, name, rays):
    dev, meta = device_scene(name)
    if rays == "camera":
        o, d = recorded_queries(name, 16)[0]
    else:
        o, d = (vec(a) for a in random_rays(999, 11))
    plain = _check_host_kernel(host_prims, meta, dev, o, d)
    assert int(torch.isfinite(plain.t).sum()) > 0


def test_host_kernel_without_primitives_writes_the_miss_state(ieee_roots, host_prims):
    dev, meta = device_scene("shipTexOnly")
    meta = dataclasses.replace(meta, geoms=tuple(g for g in meta.geoms
                                                 if g.type == GeomType.OBJ))
    dev = dev._replace(prim_table=dev.prim_table[:0])
    o, d = (vec(a) for a in random_rays(300, 12))
    plain = _check_host_kernel(host_prims, meta, dev, o, d)
    assert torch.isinf(plain.t).all()


@pytest.mark.parametrize("kind", ["inside", "axis", "grazing", "zero_dir"])
def test_host_kernel_equals_plain_on_hand_made_rays(ieee_roots, host_prims, kind, tmp_path):
    dev, meta = device_scene("hand", tmp_path)
    o, d = (vec(a) for a in hand_rays(kind))
    plain = _check_host_kernel(host_prims, meta, dev, o, d)
    if kind == "inside":  # inside both cubes: every ray a tie that the first cube wins
        assert torch.isfinite(plain.t).all() and (plain.mat_id == 1).all()
    if kind == "axis":  # some slab tests meet 0/0
        qo = torch.stack(list(o))
        assert bool(((qo.abs() == 0.5) & (torch.stack(list(d)) == 0)).any())


def test_host_kernel_takes_odd_lane_counts(ieee_roots, host_prims):
    dev, meta = device_scene("cornell")
    for n in (1, 255, 257):
        o, d = (vec(a) for a in random_rays(n, n))
        _check_host_kernel(host_prims, meta, dev, o, d)


def test_host_kernel_reads_strided_and_expanded_rays(ieee_roots, host_prims):
    """The camera's origins are one value expanded (stride 0); a [N, 3]
    array's columns have stride 3."""
    dev, meta = device_scene("cornell")
    o_np, d_np = random_rays(300, 8, 0.0, 9.0)
    d = Vec3(*torch.from_numpy(d_np).unbind(1))
    o = Vec3(*(torch.tensor(float(c)).expand(300) for c in o_np[0]))
    assert d.x.stride(0) == 3 and o.x.stride(0) == 0
    plain = _check_host_kernel(host_prims, meta, dev, o, d)
    assert int(torch.isfinite(plain.t).sum()) > 0


@pytest.mark.parametrize("name", ["cornell", "cornellShipTex", "sphere"])
def test_nearest_primitives_on_cpu_is_the_plain_function(name, monkeypatch):
    dev, meta = device_scene(name)
    o, d = (vec(a) for a in random_rays(500, 2))
    before = ph.LAUNCHES

    def refuse(*a, **k):
        raise AssertionError("the kernel's launcher ran on CPU tensors")

    monkeypatch.setattr(trace, "prims_hit", refuse)
    assert_running_equal(trace.nearest_primitives(meta, dev, o, d),
                         trace.intersect_primitives_soa(meta, o, d))
    assert ph.LAUNCHES == before


def test_launcher_refuses_cpu_and_bad_tensors():
    dev, meta = device_scene("cornell")
    o, d = (vec(a) for a in random_rays(8, 1))
    before = ph.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ph.prims_hit(dev.prim_table, o, d)
    assert ph.LAUNCHES == before


def _with_host_kernel(monkeypatch, lib):
    """nearest_primitives as its CUDA branch, with the host build's rows."""
    def nearest(meta, dev, o, d):
        return trace._Running.from_rows(*host_rows(lib, dev.prim_table, o, d))

    monkeypatch.setattr(trace, "nearest_primitives", nearest)


@pytest.mark.parametrize("name", ["cornellShipTex", "cornellShip"])
@pytest.mark.parametrize("tiers", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_intersect_soa_unchanged_with_kernel_rows(ieee_roots, host_prims, monkeypatch, name, tiers,
                                                  masked):
    scene = load_scene(str(REPO / f"scenes/{name}.txt"))
    dev, meta = build_device_scene(scene, 128, device="cpu")
    o, d = (vec(a) for a in random_rays(300, 9, -4.0, 9.0))
    active = torch.from_numpy(np.random.default_rng(1).random(300) < 0.7) if masked else None
    kw = dict(mesh_pallas=tiers, winner_table="oct", mesh_sort="need",
              active=active)
    plain = trace.intersect_soa(meta, dev, o, d, 128, **kw)
    _with_host_kernel(monkeypatch, host_prims)
    kernel = trace.intersect_soa(meta, dev, o, d, 128, **kw)
    assert_hits_equal(kernel, plain)
    assert int(plain.is_obj.sum()) > 0 and int((plain.hit & ~plain.is_obj).sum()) > 0


@pytest.mark.parametrize("name", ["cornellShipTex", "cornell"])
def test_wavefront_iteration_unchanged_with_kernel_rows(ieee_roots, host_prims, monkeypatch,
                                                        name):
    def accumulator():
        scene = load_scene(str(REPO / SCENES[name]))
        scene.set_resolution(10, 10)
        r = Renderer(scene, RenderOptions(megakernel=False, mesh_pallas=True), seed=4,
                     device="cpu")
        r.step_many(2)
        return np.ascontiguousarray(r.raw_accumulator())

    plain = accumulator()
    _with_host_kernel(monkeypatch, host_prims)
    kernel = accumulator()
    np.testing.assert_array_equal(kernel.view(np.int32), plain.view(np.int32))
    assert np.abs(plain[0:3]).sum() > 0
