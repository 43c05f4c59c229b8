"""The port's spans (``utils/profiling.py::named_scope``) on the CPU: the
preview frame's, the app's denoise and its multichip render open exactly
their ``mygpurt.*`` spans, nested as the spans' table states; with no profiler active no span
enters ``record_function``; a ``PhaseTimer`` phase is a span of its name.
The card's side (``Renderer.render`` without a device sync, NVTX) is
``tests/test_torch_spans_cuda.py``."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.apps.raytrace import denoise_beauty, render_multichip
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.parallel import make_mesh
from mygpuraytracer_tpu_torch.render import Renderer, denoise_fused
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box
from mygpuraytracer_tpu_torch.utils.profiling import PhaseTimer, named_scope
from mygpuraytracer_tpu_torch.utils.timer import PerformanceTimer

PREFIX = "mygpurt."


def _renderer(res=16):
    scene = cornell_box()
    scene.set_resolution(res, res)
    return Renderer(scene, RenderOptions(), seed=3, device="cpu")


def _images(res=16):
    rng = np.random.default_rng(5)
    return (rng.random((res, res, 3), dtype=np.float32),
            rng.random((res, res, 3), dtype=np.float32))


def _spans(fn):
    """Run ``fn`` under the profiler (CPU activity); returns each
    ``mygpurt.*`` span as (name, names of its enclosing ``mygpurt.*``
    spans, innermost first)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if not e.name.startswith(PREFIX):
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(PREFIX):
                chain.append(p.name)
            p = p.cpu_parent
        out.append((e.name, tuple(chain)))
    return out


class CountingRecordFunction:
    """Stands in for ``torch.profiler.record_function`` and counts entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def counting(monkeypatch):
    CountingRecordFunction.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", CountingRecordFunction)
    return CountingRecordFunction


def test_render_denoised_opens_the_frame_spans(monkeypatch):
    """One preview frame: the eager step, then the denoise with the U-Net's
    build and its cast to the net's number format inside it (on the CPU the
    net runs in float32 and needs no cast, so the cast is forced here by
    asking for bfloat16, as on CUDA)."""
    r = _renderer()
    monkeypatch.setattr(denoise_fused, "net_dtype", lambda device: torch.bfloat16)
    spans = _spans(lambda: r.render_denoised(iterations=2, batch=2))
    assert sorted(spans) == sorted([
        ("mygpurt.step.eager", ()),
        ("mygpurt.denoise", ()),
        ("mygpurt.denoise.build", ("mygpurt.denoise",)),
        ("mygpurt.denoise.cast", ("mygpurt.denoise",)),
    ])


def test_render_denoised_builds_and_casts_at_the_first_frame_only(monkeypatch):
    """A second frame of the same Renderer reuses the kept net: the denoise
    opens no build and no cast."""
    r = _renderer()
    monkeypatch.setattr(denoise_fused, "net_dtype", lambda device: torch.bfloat16)
    r.render_denoised(iterations=2, batch=2)
    spans = _spans(lambda: r.render_denoised(iterations=1, batch=1))
    assert sorted(spans) == sorted([("mygpurt.step.eager", ()), ("mygpurt.denoise", ())])


def test_step_many_opens_one_eager_span_per_batch():
    r = _renderer(8)
    spans = _spans(lambda: (r.step_many(2), r.step_many(1)))
    assert spans == [("mygpurt.step.eager", ())] * 2


def test_denoise_beauty_opens_the_filter_spans():
    """The app's denoise: ``mygpurt.filter`` around its three phases, the
    network's build inside the filter's commit, and inside the execute the
    upload, the network and the readback (no exposure: LDR)."""
    beauty, albedo = _images()
    spans = _spans(lambda: denoise_beauty(beauty, albedo, "cpu"))
    execute = ("mygpurt.filter.execute", "mygpurt.filter")
    assert sorted(spans) == sorted([
        ("mygpurt.filter", ()),
        ("mygpurt.filter.device", ("mygpurt.filter",)),
        ("mygpurt.filter.init", ("mygpurt.filter",)),
        ("mygpurt.filter.build", ("mygpurt.filter.init", "mygpurt.filter")),
        ("mygpurt.filter.execute", ("mygpurt.filter",)),
        ("mygpurt.filter.upload", execute),
        ("mygpurt.filter.net", execute),
        ("mygpurt.filter.readback", execute),
    ])


@pytest.mark.parametrize("megakernel", [True, False], ids=["k1", "wavefront"])
def test_render_multichip_opens_the_mesh_spans(megakernel):
    """The app's sample mode over four devices: ``mygpurt.multichip`` around
    the scene's copies, one launch span a device and the sum."""
    scene = cornell_box()
    scene.set_resolution(8, 8)
    r = Renderer(scene, RenderOptions(megakernel=megakernel), seed=3, device="cpu")
    mesh = make_mesh(devices=("cpu",) * 4)
    spans = _spans(lambda: render_multichip(r, r.options, 4, "sample", lambda *a: None, mesh))
    inner = ("mygpurt.multichip",)
    assert sorted(spans) == sorted([
        ("mygpurt.multichip", ()),
        ("mygpurt.multichip.replicate", inner),
        *[("mygpurt.multichip.launch", inner)] * 4,
        ("mygpurt.multichip.psum", inner),
    ])


def test_denoise_beauty_keeps_its_timings():
    beauty, albedo = _images()
    out, timings = denoise_beauty(beauty, albedo, "cpu")
    assert out.shape == beauty.shape and out.dtype == np.float32
    assert set(timings) == {"device_init_ms", "filter_init_ms", "denoise_ms", "random_weights"}
    assert all(timings[k] > 0 for k in ("device_init_ms", "filter_init_ms", "denoise_ms"))
    assert timings["random_weights"] is False


def test_no_span_enters_record_function_without_a_profiler(counting):
    assert not torch.autograd._profiler_enabled()
    _renderer().render_denoised(iterations=2, batch=2)
    denoise_beauty(*_images(), "cpu")
    with PhaseTimer().phase("mygpurt.filter.device"):
        pass
    assert counting.entered == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with named_scope("mygpurt.step.eager"):
            pass
    assert counting.entered == 1


def test_phase_timer_phases_are_spans():
    timer = PhaseTimer()

    def run():
        for _ in range(2):
            with timer.phase("mygpurt.filter.execute"):
                pass
        with timer.phase("mygpurt.filter.init", sync=torch.zeros(2)):
            pass

    spans = _spans(run)
    assert collections.Counter(n for n, _ in spans) == {"mygpurt.filter.execute": 2,
                                                        "mygpurt.filter.init": 1}
    assert timer.counts == {"mygpurt.filter.execute": 2, "mygpurt.filter.init": 1}


def test_timer_reads_the_host_clock_on_the_cpu():
    """For a CPU device the timer keeps the host clock: ``end`` returns the
    milliseconds at once."""
    t = PerformanceTimer("cpu")
    t.start()
    ms = t.end()
    assert ms is not None and ms == t.last_ms == t.total_ms and t.count == 1
    r = _renderer(8)
    r.render(2, batch=1)
    assert r.timer.count == 1 and r.timer.last_ms > 0
