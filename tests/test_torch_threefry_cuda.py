"""The wavefront's threefry block (csrc/prng.cu, ``threefry_uniforms``) on
the card against ``ops/rng.py``'s plain threefry.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_threefry_cuda.py
Without a CUDA device every case skips: the kernel has no CPU mode (its
source is held against the plain version on the host by
tests/test_torch_k5_host.py). Tolerance: none, the kernel is integer
arithmetic and one exact conversion.

- The kernel equals ``rng.uniform`` (run on the card's own tensors) bit
  for bit at the wavefront's [28, 640000] and the raygen's [4, 640000], and
  ``rng.uniform_columns`` at the pixel ranges of a pixel-sharded render.
- An iteration counted on the device and read by the kernel inside a CUDA
  graph's replays gives the draws of the int iteration.
- The launches: one an eager wavefront iteration on the host and on the
  device, and one on the device for each graph replay (none on the host).
- A Renderer's cornellShipTex accumulator after iterations 1-3 equals the
  one drawn by the plain threefry in the kernel's place, bit for bit.
"""

import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.ops import prng, rng
from mygpuraytracer_tpu_torch.render import Renderer, graphs
from mygpuraytracer_tpu_torch.scene import load_scene

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 800 * 800
SEEDS = [0, -1, 2**31 - 1]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the threefry kernel has no CPU mode")


def _renderer(res, seed):
    scene = load_scene(str(REPO / "scenes/cornellShipTex.txt"))
    scene.set_resolution(res, res)
    r = Renderer(scene, RenderOptions(megakernel=True), seed=seed, device="cuda")
    assert r.graph_route == "wavefront" and r.options.rng == "threefry"
    return r


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [28, 4])
def test_kernel_equals_plain_at_the_main_path_shapes(seed, k):
    _need_cuda()
    key = rng.iteration_key(rng.make_key(seed), 7)
    before = prng.THREEFRY_LAUNCHES
    got = prng.threefry_uniforms(key, k, N, device="cuda")
    assert prng.THREEFRY_LAUNCHES == before + 1
    assert torch.equal(got, rng.uniform(key, (k, N), "cuda"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("parts", [2, 4, 3])
def test_kernel_equals_plain_on_pixel_ranges(parts):
    """The ranges of a render sharded over ``parts`` devices (equal pieces;
    for 3, a ragged last piece) put together give the whole block."""
    _need_cuda()
    key = rng.iteration_key(rng.make_key(11), 2)
    size = -(-N // parts)
    ranges = [(p0, min(size, N - p0)) for p0 in range(0, N, size)]
    whole = prng.threefry_uniforms(key, 28, N, device="cuda")
    pieces = []
    for p0, count in ranges:
        got = prng.threefry_uniforms(key, 28, N, p0, count, "cuda")
        assert torch.equal(got, rng.uniform_columns(key, 28, N, p0, count, "cuda"))
        pieces.append(got)
    assert torch.equal(torch.cat(pieces, dim=1), whole)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_counted_iteration_in_a_graph_replay_equals_the_int_iteration(seed):
    _need_cuda()
    base = rng.make_key(seed)
    counted = torch.ones((), dtype=torch.int64, device="cuda")
    prng.threefry_uniforms((base, counted), 28, N, device="cuda")  # warm-up, outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prng.threefry_uniforms((base, counted), 28, N, device="cuda")
        sharded = prng.threefry_uniforms((base, counted), 4, N, 1000, 5000, "cuda")
    torch.cuda.synchronize()
    _build.zero_launches_on_device()
    before = prng.THREEFRY_LAUNCHES
    for it in (1, 2, 77, 2**31 - 1, 2**32 + 5):
        counted.fill_(it)
        graph.replay()
        ikey = rng.iteration_key(base, it)
        assert torch.equal(out, prng.threefry_uniforms(ikey, 28, N, device="cuda"))
        assert torch.equal(out, rng.uniform(ikey, (28, N), "cuda"))
        assert torch.equal(sharded, rng.uniform_columns(ikey, 4, N, 1000, 5000, "cuda"))
    assert prng.THREEFRY_LAUNCHES == before + 5  # the by-value launches alone
    assert _build.launches_on_device("threefry") == 5 * 2 + 5


@pytest.mark.requires_cuda
def test_launches_one_per_iteration_and_per_replay():
    _need_cuda()
    r = _renderer(64, 1)
    _build.zero_launches_on_device()
    before = prng.THREEFRY_LAUNCHES
    with graphs.disabled():
        r.step()
    assert prng.THREEFRY_LAUNCHES == before + 1
    assert _build.launches_on_device("threefry") == 1
    r.step_many(2)  # the later iteration's graph captured and replayed
    _build.zero_launches_on_device()
    before = prng.THREEFRY_LAUNCHES
    r.step_many(5)
    assert prng.THREEFRY_LAUNCHES == before
    assert _build.launches_on_device("threefry") == 5


def _plain_threefry(key, k, n, col0=0, count=None, device="cuda"):
    """``prng.threefry_uniforms`` by ``ops/rng.py``'s int64 ops on the same
    device: a counted iteration's key words as tensors there."""
    count = n - col0 if count is None else count
    if isinstance(key[0], tuple):
        key = rng.iteration_key(*key)
    return rng.uniform_columns(key, k, n, col0, count, device)


@pytest.mark.requires_cuda
def test_renderer_accumulator_equals_the_plain_threefry(monkeypatch):
    _need_cuda()

    def accumulator():
        r = _renderer(96, 2)
        r.step_many(3)
        return np.ascontiguousarray(r.raw_accumulator())

    before = prng.THREEFRY_LAUNCHES
    kernel = accumulator()
    assert prng.THREEFRY_LAUNCHES > before
    monkeypatch.setattr(prng, "threefry_uniforms", _plain_threefry)
    plain = accumulator()
    np.testing.assert_array_equal(kernel.view(np.int32), plain.view(np.int32))
    assert np.abs(plain).sum() > 0
