"""The traced run's reduction: ``torch.profiler`` over bounded slices of the
window, reduced at once to counts and times (no trace file is written).

A slice (:class:`Segment`) has a role: ``render`` (a converge job from its
reset through its first traced iterations), ``finish`` (the job's readback
and denoise) or ``frames`` (the window's first preview frames).
From each it keeps:

- the host's wall seconds (synchronised at both ends);
- the seconds in which a device operation ran (the union of the device
  events' intervals), the kernels on the card, and device seconds by name;
- the host's kernel launches and graph launches (``cudaLaunchKernel``,
  ``cudaGraphLaunch`` and their kin, as the profiler's CPU events name them);
- the device's idle gaps, each labelled with what the host was doing at its
  middle: the innermost ``rtbench.*`` span and the innermost host event.

The arithmetic (:func:`reduce_events`) takes plain tuples, so that it can be
tested without a card.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
NOT_KERNELS = ("Memcpy", "Memset")
SPAN = "rtbench."
WALK_BACK = 256  # host events searched back from a gap for the one covering it
NAME_CHARS = 120


def reduce_events(device, host, wall_s: float) -> dict:
    """``device``: (start_us, end_us, name) of each device operation;
    ``host``: (start_us, end_us, name) of each host event. Returns busy_s,
    kernels, device_s (by name), launches, graph_launches, gaps (label ->
    idle seconds) and wall_s."""
    device = sorted(device)
    busy_us, merged = 0.0, []
    for s, e, _ in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    by_name = Counter()
    kernels = 0
    for s, e, name in device:
        by_name[name] += (e - s) * 1e-6
        kernels += not name.startswith(NOT_KERNELS)
    names = Counter(n for _, _, n in host)
    host = sorted(host)
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith(SPAN)]
    lo = min([h[0] for h in host] + [m[0] for m in merged], default=0.0)
    hi = max([h[1] for h in host] + [m[1] for m in merged], default=0.0)
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_label((a + b) / 2, host, starts, spans)] += (b - a) * 1e-6
    return dict(wall_s=wall_s, busy_s=busy_us * 1e-6, kernels=kernels, device_s=by_name,
                launches=sum(names[n] for n in LAUNCH_CALLS),
                graph_launches=sum(names[n] for n in GRAPH_CALLS), gaps=gaps)


def _label(t: float, host, starts, spans) -> str:
    """"<innermost rtbench span>/<innermost host event>" covering time t."""
    span = next((h[2][len(SPAN):] for h in reversed(spans) if h[0] <= t <= h[1]), "-")
    i = bisect.bisect_right(starts, t) - 1
    inner = "-"
    for j in range(i, max(i - WALK_BACK, -1), -1):
        if host[j][1] >= t and not host[j][2].startswith(SPAN):
            inner = host[j][2]
            break
    return f"{span}/{inner}"


class Segment:
    """One profiled slice: ``start()`` ... ``stop()``."""

    def __init__(self, role: str, iterations: int = 0, frames: int = 0):
        self.role, self.iterations, self.frames = role, iterations, frames
        self.stats = None

    def start(self) -> None:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in self._prof.events():
            row = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type != cuda:
                host.append(row)
            elif not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN)):
                device.append(row)  # a span's range on the device is no operation
        del self._prof
        self.stats = reduce_events(device, host, wall)


class Tracer:
    def __init__(self):
        self.segments: list[Segment] = []

    def segment(self, role: str, **kw) -> Segment:
        seg = Segment(role, **kw)
        self.segments.append(seg)
        return seg


class Trace:
    """What the metric readers read: the slices' sums (a converge job's
    ``render`` and ``finish`` slices carry iterations, a ``frames`` slice
    frames), the Renderer's route and the work counts of the configuration.
    A reader returns None where the slices it reads are absent."""

    def __init__(self, segments, route: str | None, pixels: int, work: dict, peaks: dict):
        self.segments = [s for s in segments if s.stats is not None]
        self.route, self.pixels, self.work, self.peaks = route, pixels, work, peaks

    def _sum(self, key, roles=None):
        return sum(s.stats[key] for s in self.segments if roles is None or s.role in roles)

    @property
    def iterations(self) -> int:
        return sum(s.iterations for s in self.segments if s.role == "render")

    @property
    def frames(self) -> int:
        return sum(s.frames for s in self.segments if s.role == "frames")

    def wall_s(self, roles=None) -> float:
        return self._sum("wall_s", roles)

    def busy_s(self, roles=None) -> float:
        return self._sum("busy_s", roles)

    def kernels(self, roles=None) -> int:
        return self._sum("kernels", roles)

    def launches(self, roles=None) -> int:
        return self._sum("launches", roles) + self._sum("graph_launches", roles)

    def device_s(self, part: str, roles=None) -> float:
        """Device seconds of the operations whose name contains ``part``."""
        return sum(t for s in self.segments if roles is None or s.role in roles
                   for n, t in s.stats["device_s"].items() if part in n)

    def breakdown(self) -> dict:
        ops, gaps = Counter(), Counter()
        for s in self.segments:
            ops.update(s.stats["device_s"])
            gaps.update(s.stats["gaps"])
        top = lambda c: [[n[:NAME_CHARS], t] for n, t in c.most_common(10)]
        return dict(device_ops=top(ops), idle_gaps=top(gaps))
