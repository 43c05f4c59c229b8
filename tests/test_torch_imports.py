"""The PyTorch port stands alone: no JAX, no optax, no JAX package, CUDA by
default.

The machine with the GPU has no JAX, so the port and chip_smoke.py must
import with ``jax``, ``optax`` (and the JAX package) blocked.
"""

import inspect
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mygpuraytracer_tpu_torch"
SOURCES = sorted(p.relative_to(REPO).as_posix()
                 for p in [*PORT.rglob("*.py"), *PORT.glob("csrc/*.cu"), *PORT.glob("csrc/*.cuh")]) + ["chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)

_BLOCK_JAX = (
    "import sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['jaxlib'] = None\n"
    "sys.modules['optax'] = None\n"
    "sys.modules['mygpuraytracer_tpu'] = None\n"
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("target", ["port", "chip_smoke"])
def test_imports_with_jax_blocked(target):
    if target == "port":
        body = "".join(f"import {m}\n" for m in MODULES)
    else:
        body = "import chip_smoke\n"
    code = _BLOCK_JAX + body + (
        "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
        "assert 'jax' not in loaded and 'optax' not in loaded\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", SOURCES)
def test_source_names_no_jax(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|optax)\b", text, re.M), \
        f"{path} imports jax or optax"
    assert not re.search(r"mygpuraytracer_tpu\.(?!_torch)|import mygpuraytracer_tpu\b(?!_torch)",
                         text), f"{path} names the JAX package as a module"


def test_scan_covers_the_mesh_path():
    for module in ("mygpuraytracer_tpu_torch.ops.mesh_hit", "mygpuraytracer_tpu_torch.ops.trace",
                   "mygpuraytracer_tpu_torch.scene.native_loader",
                   "mygpuraytracer_tpu_torch.utils.png", "mygpuraytracer_tpu_torch.ops.prng",
                   "mygpuraytracer_tpu_torch.denoise.filter", "mygpuraytracer_tpu_torch.utils.exr",
                   "mygpuraytracer_tpu_torch.utils.image_io",
                   "mygpuraytracer_tpu_torch.apps.denoise",
                   "mygpuraytracer_tpu_torch.ops.compaction",
                   "mygpuraytracer_tpu_torch.ops.intersect",
                   "mygpuraytracer_tpu_torch.utils.timer",
                   "mygpuraytracer_tpu_torch.apps.benchmark",
                   "mygpuraytracer_tpu_torch.train", "mygpuraytracer_tpu_torch.train.ssim",
                   "mygpuraytracer_tpu_torch.train.losses", "mygpuraytracer_tpu_torch.train.dataset",
                   "mygpuraytracer_tpu_torch.train.train", "mygpuraytracer_tpu_torch.train.export",
                   "mygpuraytracer_tpu_torch.train.infer", "mygpuraytracer_tpu_torch.train.find_lr",
                   "mygpuraytracer_tpu_torch.apps.preprocess",
                   "mygpuraytracer_tpu_torch.apps.compare_image",
                   "mygpuraytracer_tpu_torch.apps.visualize",
                   "mygpuraytracer_tpu_torch.apps.train_denoiser",
                   "mygpuraytracer_tpu_torch.parallel", "mygpuraytracer_tpu_torch.parallel.mesh",
                   "mygpuraytracer_tpu_torch.parallel.sharded",
                   "mygpuraytracer_tpu_torch.apps.preview",
                   "mygpuraytracer_tpu_torch.apps.convert_image",
                   "mygpuraytracer_tpu_torch.apps.split_exr",
                   "mygpuraytracer_tpu_torch.utils.platform",
                   "mygpuraytracer_tpu_torch.utils.profiling",
                   "mygpuraytracer_tpu_torch.scene.writer", "mygpuraytracer_tpu_torch.bench"):
        assert module in MODULES
    for path in ("mygpuraytracer_tpu_torch/csrc/mesh_hit.cu",
                 "mygpuraytracer_tpu_torch/csrc/megakernel.cu",
                 "mygpuraytracer_tpu_torch/csrc/bounce.cu", "mygpuraytracer_tpu_torch/csrc/prng.cu",
                 "mygpuraytracer_tpu_torch/csrc/path.cuh", "mygpuraytracer_tpu_torch/csrc/mesh.cuh"):
        assert path in SOURCES


def _default(fn, name):
    return inspect.signature(fn).parameters[name].default


def test_entry_points_default_to_cuda():
    from mygpuraytracer_tpu_torch.apps import raytrace
    from mygpuraytracer_tpu_torch.render import Renderer
    from mygpuraytracer_tpu_torch.render.denoise_fused import load_denoiser
    from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene, camera_params

    assert _default(Renderer.__init__, "device") == "cuda"
    assert _default(build_device_scene, "device") == "cuda"
    assert _default(camera_params, "device") == "cuda"
    assert _default(load_denoiser, "device") == "cuda"
    from mygpuraytracer_tpu_torch.ops import prng

    assert _default(prng.pallas_uniforms, "device") == "cuda"
    assert _default(prng.iteration_uniforms, "device") == "cuda"
    assert raytrace.parse_args(["cornell"]).device == "cuda"
    assert raytrace.parse_args(["cornell"]).megakernel == "auto"
    args = raytrace.parse_args(["scenes/cornellShipTex.txt"])
    assert (args.mesh_tier, args.mesh_sort, args.winner_table) == ("rows", "auto", "auto")
    from mygpuraytracer_tpu_torch.config import RenderOptions
    from mygpuraytracer_tpu_torch.ops.trace import intersect_soa

    assert RenderOptions().mesh_pallas is None  # None: the mesh kernel on CUDA tensors
    assert _default(intersect_soa, "mesh_pallas") is None
    from mygpuraytracer_tpu_torch.apps import denoise
    from mygpuraytracer_tpu_torch.denoise import Device, DeviceBuffer

    assert _default(Device.__init__, "device_type") == "default"  # CUDA, no fallback
    assert _default(DeviceBuffer.__init__, "device") == "cuda"
    assert _default(raytrace.denoise_beauty, "device") == "cuda"
    assert denoise.parse_args(["--ldr", "x.pfm"]).device == "cuda"
    from mygpuraytracer_tpu_torch.apps import benchmark
    from mygpuraytracer_tpu_torch.render.pathtrace import make_empty_cache

    assert _default(benchmark.bench_render, "device") == "cuda"
    assert _default(benchmark.bench_denoise, "device") == "cuda"
    assert _default(make_empty_cache, "device") == "cuda"
    from mygpuraytracer_tpu_torch.apps import preprocess, train_denoiser
    from mygpuraytracer_tpu_torch.train import dataset, find_lr, infer
    from mygpuraytracer_tpu_torch.train.train import train, train_device

    for fn in (train, train_device, find_lr.find_lr, dataset.render_training_pairs,
               infer.Infer.__init__, infer.ssim):
        assert _default(fn, "device") == "cuda", fn
    assert _default(train, "mesh") is None
    assert preprocess.parse_args(["hdr"]).device == "cuda"
    assert train_denoiser.parse_args([]).device == "cuda"
    from mygpuraytracer_tpu_torch import bench
    from mygpuraytracer_tpu_torch.apps import preview
    from mygpuraytracer_tpu_torch.parallel import make_mesh
    from mygpuraytracer_tpu_torch.train.train import make_mesh as train_make_mesh

    assert _default(preview.PreviewSession.__init__, "device") == "cuda"
    assert preview.parse_args(["cornell"]).device == "cuda"
    assert raytrace.parse_args(["cornell"]).multichip == "off"
    for fn in (make_mesh, train_make_mesh):  # devices=None: every visible CUDA device
        assert _default(fn, "devices") is None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()
    if not torch.cuda.is_available():  # the bench's --device defaults to cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main([])


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke check exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is not reachable")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py the check cannot run."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
