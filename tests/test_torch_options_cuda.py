"""The wavefront's options on the card: the sort and the cache change the
order of the work, never the image.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_options_cuda.py
Without a CUDA device every case skips: the mesh kernel has no CPU mode.

At 64x64, 2 iterations, on CUDA tensors: each sort form's accumulators
equal the unsorted ones bit for bit (``torch.equal``), and the first-bounce
cache's equal the uncached ones, on the Cornell box and on cornellShipTex,
whose every mesh query goes through the mesh kernel (its launches are
counted, and equal with the sort on and off).
"""

import pathlib

import pytest
import torch

from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.render import Renderer
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = 64
ITERS = 2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh kernel has no CPU mode")


def _scene(name):
    if name == "cornell":
        return cornell_box(resolution=(RES, RES))
    scene = load_scene(str(REPO / "scenes" / f"{name}.txt"))
    scene.set_resolution(RES, RES)
    return scene


def _render(name, **opts):
    """The accumulators after ITERS iterations on the card, and the mesh
    kernel's launches counted there (a graph's replays' too)."""
    r = Renderer(_scene(name), RenderOptions(**opts), seed=1, device="cuda")
    _build.zero_launches_on_device()
    r.render(iterations=ITERS)
    torch.cuda.synchronize()
    return r.acc.clone(), _build.launches_on_device("mesh_hit")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["cornell", "cornellShipTex"])
@pytest.mark.parametrize("impl", ["fused", "perm", "argsort"])
def test_sort_bitwise_on_card(name, impl):
    _need_cuda()
    opts = dict(antialiasing=False, depth_of_field=True) if name == "cornell" else {}
    base, base_launches = _render(name, **opts)
    got, launches = _render(name, sort_by_material=True, sort_impl=impl, **opts)
    assert torch.equal(got, base)
    assert launches == base_launches
    if name == "cornellShipTex":
        assert launches > 0  # the mesh kernel answered every mesh query
    assert float(base[0:3].sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["cornell", "cornellShipTex"])
@pytest.mark.parametrize("sort", [False, True])
def test_first_bounce_cache_bitwise_on_card(name, sort):
    _need_cuda()
    cached, cached_launches = _render(name, antialiasing=False, sort_by_material=sort)
    plain, plain_launches = _render(name, antialiasing=False, cache_first_bounce=False,
                                    sort_by_material=sort)
    assert torch.equal(cached, plain)
    if name == "cornellShipTex":
        assert cached_launches == plain_launches - (ITERS - 1)  # one bounce-0 query per reset
