"""Profiling and tracing helpers.

The port's counterpart of ``mygpuraytracer_tpu/utils/profiling.py``: the
reference's instrumentation (the cudaEvent timer around the bounce loop,
apps/src/timer.h; OIDN's phase timers; the VTune pause/resume hooks,
oidnDenoise.cpp:11-13) as a ``torch.profiler`` trace exported for Chrome's
trace viewer (chrome://tracing, Perfetto), the port's spans (``named_scope``),
which show in it, and phase timers that synchronise the device before
reading the clock and are spans too.

The port opens its spans where the work happens, each named ``mygpurt.*``:
``mygpurt.step.eager`` (``Renderer._eager``), ``mygpurt.denoise`` and its
``.build`` and ``.cast`` (the fused denoise), ``mygpurt.filter``, its
``.build`` and its phases ``.device``, ``.init`` and ``.execute``
(``apps/raytrace.py::denoise_beauty``, ``Filter._network``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from .timer import _synchronize


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace of the block (host and, on a CUDA
    machine, device activity) and export it as a Chrome trace,
    ``trace_<pid>_<ms>.json``, into ``log_dir`` (default: ``mygpurt_trace``
    in the temporary directory). Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mygpurt_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


_NO_SPAN = contextlib.nullcontext()


def named_scope(name: str):
    """A span: a ``record_function`` range on the profiler's timeline (the
    one its device events are on) while a profiler is active, else nothing:
    the check costs a small fraction of what opening a range costs. Under
    ``torch.autograd.profiler.emit_nvtx()`` the profiler is active and its
    ranges are NVTX ranges, for Nsight."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulating per-phase wall timers with a device sync: the
    reference's deviceInit/filterInit/denoise phase prints
    (main.cpp:184-218). Each phase is a span of its name."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; ``sync`` (a tensor, or a tuple or list of them)
        has its CUDA device synchronised before the clock is read."""
        t0 = time.perf_counter()
        with named_scope(name):
            try:
                yield
            finally:
                if sync is not None:
                    _synchronize(sync)
                ms = (time.perf_counter() - t0) * 1000
                self.phases[name] = self.phases.get(name, 0.0) + ms
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in self.phases.items():
            n = self.counts[name]
            lines.append(f"{name}: {total:.1f} ms total, {total / n:.2f} ms/call ({n}x)")
        return "\n".join(lines)
