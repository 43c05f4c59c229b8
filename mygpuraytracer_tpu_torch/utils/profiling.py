"""Profiling and tracing helpers.

The port's counterpart of ``mygpuraytracer_tpu/utils/profiling.py``: the
reference's instrumentation (the cudaEvent timer around the bounce loop,
apps/src/timer.h; OIDN's phase timers; the VTune pause/resume hooks,
oidnDenoise.cpp:11-13) as a ``torch.profiler`` trace exported for Chrome's
trace viewer (chrome://tracing, Perfetto), named ranges that show in it
(and as NVTX ranges on CUDA, for Nsight), and phase timers that synchronise
the device before reading the clock.
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


@contextlib.contextmanager
def named_scope(name: str):
    """Annotate a region: a ``record_function`` range in the profiler's
    trace, and an NVTX range on a CUDA machine."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class PhaseTimer:
    """Accumulating per-phase wall timers with a device sync: the
    reference's deviceInit/filterInit/denoise phase prints
    (main.cpp:184-218)."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; ``sync`` (a tensor, or a tuple or list of them)
        has its CUDA device synchronised before the clock is read."""
        t0 = time.perf_counter()
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
