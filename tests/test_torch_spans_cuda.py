"""The Renderer's timer and the port's spans on the card.

Imports torch and the port only, so it runs on a machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans_cuda.py
Without a CUDA device every case skips: CUDA events, the stream's
synchronisations and NVTX exist only there.

``Renderer.render()`` stops the host for no device work of its own: among
the profiler's host events of a call, a synchronisation only inside the
beauty's copy to the host, which ``render`` returns; its timer's CUDA events
then read above 0. Under
``torch.autograd.profiler.emit_nvtx()`` the profiler is active, so
``named_scope`` opens its range, which NVTX carries to Nsight.
"""

import pytest
import torch

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.render import Renderer
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box
from mygpuraytracer_tpu_torch.utils.profiling import named_scope

RES = 64
SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cuCtxSynchronize",
         "cuStreamSynchronize")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA events, stream syncs and NVTX have no CPU mode")


def _within(event, outer) -> bool:
    return (outer.time_range.start <= event.time_range.start
            and event.time_range.end <= outer.time_range.end)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("megakernel", [False, True], ids=["wavefront_graph", "k1"])
def test_render_does_not_synchronise_the_device(megakernel):
    _need_cuda()
    scene = cornell_box()
    scene.set_resolution(RES, RES)
    r = Renderer(scene, RenderOptions(megakernel=megakernel), seed=1, device="cuda")
    r.render(4, batch=2)  # the eager iteration, the graph's capture, the kernels' build
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("test.render"):
            r.render(4, batch=2)
    events = prof.events()
    call = next(e for e in events if e.name == "test.render")
    copies = [e for e in events if e.name == "aten::copy_" and _within(e, call)]
    syncs = [e for e in events if e.name in SYNCS and _within(e, call)]
    assert syncs  # the beauty's copy to the host waits for the stream
    assert all(any(_within(e, c) for c in copies) for e in syncs), [e.name for e in syncs]
    assert r.timer.count == 2 and r.timer.last_ms > 0
    assert r.timer.total_ms >= r.timer.last_ms


@pytest.mark.requires_cuda
def test_render_timer_times_the_device_work():
    """Its events bracket the device's work: a render of 8 iterations reads
    more than one of 1 on the same Renderer."""
    _need_cuda()
    scene = cornell_box()
    scene.set_resolution(256, 256)
    r = Renderer(scene, RenderOptions(), seed=1, device="cuda")
    r.render(2, batch=1)
    r.render(1, batch=1)
    one = r.timer.last_ms
    r.render(8, batch=1)
    assert r.timer.last_ms > one > 0 and r.timer.count == 3


@pytest.mark.requires_cuda
def test_named_scope_is_active_under_emit_nvtx(monkeypatch):
    _need_cuda()
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with named_scope("mygpurt.step.eager"):  # no profiler: no range
        pass
    with torch.autograd.profiler.emit_nvtx():
        assert torch.autograd._profiler_enabled()
        with named_scope("mygpurt.denoise"):
            pass
    assert entered == ["mygpurt.denoise"]
