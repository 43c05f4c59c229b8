"""Phase timers.

Counterpart of ``mygpuraytracer_tpu/utils/timer.py`` (the reference's
cudaEvent PerformanceTimer, apps/src/timer.h:17-101, and OIDN's chrono
Timer, common/timer.h:11-35): wall-clock times around a region, with the
device synchronised before the clock is read where JAX blocks on an array.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def _synchronize(sync) -> None:
    """Wait for the CUDA devices of the tensors in ``sync`` (a tensor or a
    nested tuple/list of them); CPU tensors need no wait."""
    if isinstance(sync, torch.Tensor):
        if sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
    elif isinstance(sync, (tuple, list)):
        for v in sync:
            _synchronize(v)


class PerformanceTimer:
    """Accumulating wall-clock timer with an explicit device sync: the
    start/end/elapsed surface of apps/src/timer.h and the cumulative
    ``totalTime`` of apps/src/main.cpp:263-264,275."""

    def __init__(self) -> None:
        self._start: float | None = None
        self._last_ms: float = 0.0
        self.total_ms: float = 0.0
        self.count: int = 0

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError("timer already started")
        self._start = time.perf_counter()

    def end(self, sync: object = None) -> float:
        """Stop the timer, first waiting for the devices of ``sync``'s tensors."""
        if self._start is None:
            raise RuntimeError("timer not started")
        if sync is not None:
            _synchronize(sync)
        self._last_ms = (time.perf_counter() - self._start) * 1000.0
        self.total_ms += self._last_ms
        self.count += 1
        self._start = None
        return self._last_ms

    @property
    def last_ms(self) -> float:
        return self._last_ms

    @contextmanager
    def timed(self, sync_fn=None):
        """Time a block; the block may put tensors to wait for in
        ``out["sync"]``."""
        self.start()
        out = {}
        try:
            yield out
        finally:
            self.end(sync=out.get("sync"))


@contextmanager
def timed_ms(results: dict, key: str):
    """Time a block and store milliseconds into ``results[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        results[key] = (time.perf_counter() - t0) * 1000.0
