"""The arithmetic of a run: p95, rate and window of both loops on synthetic
timings with a stall, the drag's camera path, the reservoir, the orbit, and
the trace's reduction."""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import pytest

from rtbench import core, trace


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


CONVERGE = core.module("loops", "converge")
FRAMES = core.module("loops", "frames")


class FakeProgram:
    """Jobs or frames that take fixed times on a fake clock; ``stall`` adds
    seconds to one call."""

    pixels = 64

    def __init__(self, clock, step_s, finish_s, stall_at=None, stall_s=0.0):
        self.clock, self.step_s, self.finish_s = clock, step_s, finish_s
        self.stall_at, self.stall_s, self.calls, self.iteration = stall_at, stall_s, 0, 0

    def _spend(self, s):
        self.calls += 1
        self.clock.t += s + (self.stall_s if self.calls == self.stall_at else 0.0)

    def reset(self):
        self.iteration = 0

    def step_many(self, n):
        self.iteration += n
        self._spend(self.step_s * n)

    def finish_job(self):
        self._spend(self.finish_s)
        return dict(iterations=self.iteration, random_weights=False)

    def frame(self, position=None, iterations=1):
        self._spend(self.step_s)
        return dict(random_weights=False, moved_to=position)

    def albedo_on_device(self):
        return "albedo"

    def albedo_to_host(self, rows):
        return rows


class FakeFrames(FRAMES.Frames):
    """The frames loop's camera path over a FakeProgram's frames."""

    def __init__(self, fake, traffic, sign=1.0):
        self.fake, self.traffic, self.n, self.since = fake, traffic, 0, 0
        self.eye, self.look_at = np.array([0, 5, 10.5], np.float32), np.zeros(3, np.float32)
        self.step = sign * traffic["drag_px"] / 800

    def frame(self, position=None, iterations=1):
        return self.fake.frame(position, iterations)

    def albedo_on_device(self):
        return self.fake.albedo_on_device()

    def albedo_to_host(self, rows):
        return rows


def test_p95_matches_inclusive_quantiles_and_sees_a_stall():
    times = [0.010] * 99 + [1.0]
    assert core.p95(times) == pytest.approx(statistics.quantiles(times, n=20,
                                                                 method="inclusive")[18])
    assert core.p95(times) == pytest.approx(0.010)
    times = [0.010] * 90 + [1.0] * 10
    assert core.p95(times) == pytest.approx(1.0)
    assert core.p95([0.5]) == 0.5


def test_converge_window_ends_at_a_job_boundary_and_counts_a_stall(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    prog = FakeProgram(clock, step_s=0.001, finish_s=0.05, stall_at=10, stall_s=2.0)
    prog.spp_per_job = 64
    keep = core.Reservoir(2, np.random.default_rng(0))
    out = CONVERGE.window(prog, dict(batch=16), {}, 3.0, keep)
    job_s = 64 * 0.001 + 0.05
    # the stall lands in the second job (calls 6-10), and counts in the window
    assert out["times"][1] == pytest.approx(job_s + 2.0)
    assert out["elapsed"] >= 3.0 and out["elapsed"] - out["times"][-1] < 3.0
    assert out["elapsed"] == pytest.approx(sum(out["times"]))
    assert out["attempted"] == len(out["times"])
    rate = out["end_to_end"]["msamples_per_s"]
    jobs = len(out["times"])
    assert rate == pytest.approx(64 * 64 * jobs / (jobs * job_s + 2.0) / 1e6)
    assert len(keep.answers()) in (2, 3)
    assert all(a["since"] == 64 and a["position"] is None for a in keep.answers())


def test_still_frames_accumulate_and_time_a_stall(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    traffic = dict(drag_px=0, sweep_frames=1, spp_per_frame=1)
    f = FakeFrames(FakeProgram(clock, step_s=0.01, finish_s=0.0, stall_at=33, stall_s=0.5),
                   traffic)
    FRAMES.warm_up(f, traffic, {})
    keep = core.Reservoir(3, np.random.default_rng(1))
    out = FRAMES.window(f, traffic, {}, 1.0, keep)
    assert out["attempted"] == len(out["times"]) and out["times"][29] == pytest.approx(0.51)
    assert out["end_to_end"]["frame_ms_p95"] == pytest.approx(1e3 * core.p95(out["times"]))
    assert out["end_to_end"]["frames_per_s"] == pytest.approx(len(out["times"]) / out["elapsed"])
    assert keep.last["since"] == 3 + len(out["times"])
    for ans in keep.answers():
        assert ans["position"] is None and ans["moved_to"] is None and ans["albedo"] == "albedo"


def test_drag_moves_before_every_frame_along_a_fixed_sweep(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    traffic = dict(drag_px=8, sweep_frames=4, spp_per_frame=1)
    f = FakeFrames(FakeProgram(clock, step_s=0.125, finish_s=0.0), traffic, sign=-1.0)
    FRAMES.warm_up(f, traffic, {})
    keep = core.Reservoir(2, np.random.default_rng(2))
    out = FRAMES.window(f, traffic, {}, 2.0, keep)
    assert out["attempted"] == 16
    assert [FRAMES.sweep(n, 4) for n in range(18)] == [0, 1, 2, 3, 4, 3, 2, 1, 0, -1, -2, -3,
                                                        -4, -3, -2, -1, 0, 1]
    for ans in keep.answers():
        assert ans["since"] == 1 and np.array_equal(ans["position"], ans["moved_to"])
    assert np.allclose(f.position(8), f.position(0)) and np.allclose(f.position(2), f.position(6))
    assert np.allclose(f.position(10) * [-1, 1, 1], f.position(2))  # the mirror view
    # phi turns by -dx / width a frame (OrbitCamera.orbit), dx = 8 px, sign -1
    p = f.position(1)
    assert math.atan2(p[0], p[2]) == pytest.approx(8 / 800, rel=1e-5)


def test_reservoir_is_uniform_and_keeps_the_last():
    counts = np.zeros(20)
    for s in range(2000):
        r = core.Reservoir(2, np.random.default_rng(s))
        for i in range(20):
            r.offer(r.wants(), i)
        assert 19 in r.answers()
        for i in r.items:
            counts[i] += 1
    assert counts.sum() == 4000 and counts.min() > 120 and counts.max() < 280


def test_orbit_keeps_the_distance_and_height():
    eye, look = np.array([0, 5, 10.5], np.float32), np.array([0, 5, 0], np.float32)
    p = FRAMES.orbit_position(eye, look, 0.05)
    assert p.dtype == np.float32 and p[1] == 5.0
    assert np.linalg.norm(p - look) == pytest.approx(10.5, rel=1e-6)
    assert p[0] == pytest.approx(10.5 * math.sin(0.05), rel=1e-5)
    assert np.allclose(FRAMES.orbit_position(eye, look, 0.0), eye, atol=1e-6)


def test_reduce_events_union_gaps_launches():
    device = [(0.0, 10.0, "k1_kernel"), (5.0, 12.0, "k1_kernel"), (20.0, 30.0, "Memcpy DtoH"),
              (40.0, 50.0, "mesh_hit_kernel")]
    host = [(-5.0, 60.0, "rtbench.step_many"), (12.0, 19.0, "aten::copy_"),
            (13.0, 14.0, "cudaLaunchKernel"), (31.0, 39.0, "cudaGraphLaunch"),
            (45.0, 46.0, "cudaLaunchKernel")]
    s = trace.reduce_events(device, host, wall_s=65e-6)
    assert s["busy_s"] == pytest.approx(32e-6)  # [0,12] + [20,30] + [40,50]
    assert s["kernels"] == 3 and s["launches"] == 2 and s["graph_launches"] == 1
    assert s["device_s"]["k1_kernel"] == pytest.approx(17e-6)
    assert s["gaps"]["step_many/aten::copy_"] == pytest.approx(8e-6)  # 12-20
    assert s["gaps"]["step_many/cudaGraphLaunch"] == pytest.approx(10e-6)  # 30-40
    assert sum(s["gaps"].values()) == pytest.approx(65e-6 - 32e-6)


def test_trace_sums_by_role():
    segs = []
    for role, its, frames, wall, busy, k in (("render", 16, 0, 2.0, 1.5, 100),
                                             ("finish", 0, 0, 0.5, 0.1, 10)):
        seg = trace.Segment(role, iterations=its, frames=frames)
        seg.stats = dict(wall_s=wall, busy_s=busy, kernels=k, launches=k, graph_launches=1,
                         device_s={"k1_kernel<false>": busy / 2}, gaps={"a/b": wall - busy})
        segs.append(seg)
    t = trace.Trace(segs, "k1", 640000, {}, {})
    assert t.iterations == 16 and t.frames == 0
    assert t.wall_s() == 2.5 and t.busy_s(("render",)) == 1.5
    assert t.launches(("render",)) == 101 and t.kernels() == 110
    assert t.device_s("k1_kernel") == pytest.approx(0.8)
    assert t.breakdown()["idle_gaps"] == [["a/b", pytest.approx(0.9)]]
