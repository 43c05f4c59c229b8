"""Phase timers.

Counterpart of ``mygpuraytracer_tpu/utils/timer.py`` (the reference's
cudaEvent PerformanceTimer, apps/src/timer.h:17-101, and OIDN's chrono
Timer, common/timer.h:11-35): times around a region, by CUDA events on a
CUDA device (``PerformanceTimer``) or by the host clock with the device
synchronised before the clock is read where JAX blocks on an array.
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
    """Accumulating timer: the start/end/elapsed surface of apps/src/timer.h
    and the cumulative ``totalTime`` of apps/src/main.cpp:263-264,275.

    For a CUDA ``device`` it records a ``torch.cuda.Event`` on the current
    stream at ``start`` and at ``end``, as timer.h records cudaEvents, and
    never stops the host: a pair's time is read when ``last_ms`` or
    ``total_ms`` is asked for (waiting for its end event then), and
    ``start`` reads the pairs that have finished. Otherwise it reads the host
    clock, ``end`` first waiting for the devices of ``sync``'s tensors."""

    def __init__(self, device=None) -> None:
        device = None if device is None else torch.device(device)
        self._cuda = device if device is not None and device.type == "cuda" else None
        self._start = None
        self._pending: list = []  # (start, end) event pairs not read yet
        self._last_ms: float = 0.0
        self._total_ms: float = 0.0
        self.count: int = 0

    def _mark(self):
        if self._cuda is None:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._cuda))
        return event

    def _read(self, finished_only: bool = False) -> None:
        """Add the pending pairs' times in order; with ``finished_only``,
        only while their end events have run (never waiting)."""
        while self._pending:
            start, end = self._pending[0]
            if finished_only and not end.query():
                return
            self._pending.pop(0)
            end.synchronize()
            self._add(start.elapsed_time(end))

    def _add(self, ms: float) -> None:
        self._last_ms = ms
        self._total_ms += ms

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError("timer already started")
        self._read(finished_only=True)
        self._start = self._mark()

    def end(self, sync: object = None) -> float | None:
        """Stop the timer. On the host clock, first wait for the devices of
        ``sync``'s tensors and return the milliseconds; with events, return
        None (the time is read later)."""
        if self._start is None:
            raise RuntimeError("timer not started")
        start, self._start = self._start, None
        self.count += 1
        if self._cuda is not None:
            self._pending.append((start, self._mark()))
            return None
        if sync is not None:
            _synchronize(sync)
        self._add((time.perf_counter() - start) * 1000.0)
        return self._last_ms

    @property
    def last_ms(self) -> float:
        self._read()
        return self._last_ms

    @property
    def total_ms(self) -> float:
        self._read()
        return self._total_ms

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
