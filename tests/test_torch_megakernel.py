"""K1's wrapper, its plain version and its routing.

On the CPU, ``megakernel_accumulate`` runs the plain version, which must
equal the step-by-step wavefront accumulation and ``render_sample``'s
megakernel route bit for bit (same code, same order), including the rule that the albedo and normal AOVs are taken at
iteration 1 only. The CUDA kernel itself runs only on the card: the
``requires_cuda`` case holds it against the plain version there
(chip_smoke.py's bars) and skips here.
"""

import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu.config import RenderOptions as JaxOptions
from mygpuraytracer_tpu.render.megakernel import supports_megakernel as jax_supports
from mygpuraytracer_tpu.scene import load_scene as jax_load_scene
from mygpuraytracer_tpu.scene import builtin as jax_builtin
from mygpuraytracer_tpu.scene.device_scene import build_device_scene as jax_build

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import rng
from mygpuraytracer_tpu_torch.render import Renderer, megakernel
from mygpuraytracer_tpu_torch.render.pathtrace import (accumulate_sample, render_sample,
                                                       wavefront_sample)
from mygpuraytracer_tpu_torch.scene import builtin, load_scene
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _small(kind="cornellGlass", res=24, device="cpu"):
    return build_device_scene(builtin.BUILTIN_SCENES[kind](resolution=(res, res)), device=device)


@pytest.mark.parametrize("start,count", [(1, 3), (3, 2)])
def test_accumulate_equals_plain_and_steps(start, count):
    dev, meta = _small()
    n = meta.resolution[0] * meta.resolution[1]
    key = rng.make_key(4)
    opts = RenderOptions(megakernel=True)
    gen = np.random.default_rng(0)
    init = torch.from_numpy(gen.random((9, n), np.float32))
    acc_k = megakernel.megakernel_accumulate(dev, meta, opts, init.clone(), start, count, key)
    acc_p = megakernel.megakernel_accumulate_reference(dev, meta, opts, init.clone(), start,
                                                       count, key)
    acc_s, acc_r = init.clone(), init.clone()
    for it in range(start, start + count):
        accumulate_sample(acc_s, wavefront_sample(dev, meta, opts, it, key), it)
        accumulate_sample(acc_r, render_sample(dev, meta, opts, it, key), it)  # megakernel route
    assert torch.equal(acc_k, acc_p) and torch.equal(acc_p, acc_s) and torch.equal(acc_s, acc_r)
    if start > 1:  # AOVs are only written at iteration 1
        assert torch.equal(acc_k[3:9], init[3:9])
    else:
        assert not torch.equal(acc_k[3:6], init[3:6])


def test_cpu_path_does_not_count_launches():
    dev, meta = _small(res=8)
    before = megakernel.LAUNCHES
    megakernel.megakernel_accumulate(dev, meta, RenderOptions(megakernel=True),
                                     torch.zeros(9, 64), 1, 1, rng.make_key(0))
    assert megakernel.LAUNCHES == before


def test_renderer_batches_equal_single_steps():
    scene = builtin.cornell_box(resolution=(20, 16))
    a = Renderer(scene, RenderOptions(megakernel=True), seed=2, device="cpu")
    b = Renderer(scene, RenderOptions(megakernel=False), seed=2, device="cpu")
    assert a.use_megakernel and not b.use_megakernel
    a.step_many(3)
    a.step_many(2)
    for _ in range(5):
        b.step()
    assert a.iteration == b.iteration == 5
    assert torch.equal(a.acc, b.acc)


def test_non_cuda_device_raises():
    dev, meta = _small(res=4)
    with pytest.raises(ValueError):
        megakernel.megakernel_accumulate(dev, meta, RenderOptions(megakernel=True),
                                         torch.zeros(9, 16, device="meta"), 1, 1, rng.make_key(0))


def test_scene_record_layout():
    dev, meta = _small()
    rec = megakernel.scene_record(meta, dev.camera).numpy()
    G = meta.num_geoms
    assert rec.dtype == np.float32
    assert rec.shape == (megakernel.HEADER + megakernel.GEOM_STRIDE * G,)
    assert (rec[0], rec[1]) == (G, 0)
    np.testing.assert_array_equal(rec[2:5], dev.camera.position.numpy())
    np.testing.assert_array_equal(rec[14:16], dev.camera.pixel_length.numpy())
    for i, g in enumerate(meta.geoms):
        r = rec[megakernel.HEADER + megakernel.GEOM_STRIDE * i:][:megakernel.GEOM_STRIDE]
        assert (r[0], r[1]) == (g.type, g.material_id)
        np.testing.assert_array_equal(r[14:26].reshape(3, 4),
                                      np.asarray(g.inverse_transform, np.float32)[:3])
        np.testing.assert_array_equal(r[35:38], np.asarray(g.color, np.float32))
        assert r[45] == np.float32(g.emittance)


def _write_cube(d):
    v = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    f = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    (d / "cube.obj").write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                                + "".join("f " + " ".join(map(str, q)) + "\n" for q in f))
    text = (REPO / "scenes/builtin_cornell.txt").read_text().rstrip()
    (d / "cube.txt").write_text(text + "\n\nOBJECT 7\nobj\ncube.obj\nTRANS 2 2 0\n")
    return str(d / "cube.txt")


ROUTES = [
    ("cornell", {}),
    ("cornell", {"antialiasing": False}),  # first-bounce cache active
    ("cornell", {"antialiasing": False, "cache_first_bounce": False}),
    ("cornell", {"depth_of_field": True}),
    ("cornellGlass", {}),
    ("cube", {}),
    ("shipOnly.txt", {}),  # 23328 faces: not listed, so no K1
    ("shipTexOnly.txt", {}),  # textured
]


@pytest.mark.parametrize("scene,opts", ROUTES, ids=[f"{s}-{sorted(o)}" for s, o in ROUTES])
def test_supports_megakernel_matches_jax(scene, opts, tmp_path):
    if scene == "cube":
        path = _write_cube(tmp_path)
        js, ts = jax_load_scene(path), load_scene(path)
    elif scene.endswith(".txt"):
        js, ts = (load(str(REPO / "scenes" / scene)) for load in (jax_load_scene, load_scene))
    else:
        js, ts = jax_builtin.BUILTIN_SCENES[scene](), builtin.BUILTIN_SCENES[scene]()
    for s in (js, ts):
        s.set_resolution(8, 8)
    _, jmeta = jax_build(js)
    _, tmeta = build_device_scene(ts, device="cpu")
    assert megakernel.supports_megakernel(tmeta, RenderOptions(**opts)) == jax_supports(
        jmeta, JaxOptions(**opts))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["cornell", "cornellGlass"])
def test_k1_kernel_matches_plain_on_cuda(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    dev, meta = _small(kind, res=64, device="cuda")
    key = rng.make_key(0)
    opts = RenderOptions(megakernel=True)
    acc_k = torch.zeros((9, 64 * 64), device="cuda")
    acc_p = torch.zeros_like(acc_k)
    before = megakernel.LAUNCHES
    megakernel.megakernel_accumulate(dev, meta, opts, acc_k, 1, 8, key)
    megakernel.megakernel_accumulate_reference(dev, meta, opts, acc_p, 1, 8, key)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    # mean images: under 1% of pixels off by more than 1e-2 (paths that
    # branch the other way under the kernel's rounding), rmse < 1e-3 over the rest
    d = ((acc_k[0:3] - acc_p[0:3]) / 8).abs().amax(dim=0)
    agree = d <= 1e-2
    assert float((~agree).float().mean()) < 0.01
    assert float(d[agree].pow(2).mean().sqrt()) < 1e-3
    # AOVs: under 1% of pixels off by more than 1e-2 (edge pixels whose first
    # hit changes geom under the kernel's rounding; chip_smoke.py's bar)
    off = ((acc_k[3:9] - acc_p[3:9]).abs() > 1e-2).any(dim=0).float().mean()
    assert float(off) < 0.01
