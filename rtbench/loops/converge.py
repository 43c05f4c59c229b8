"""The raytrace app's job (``apps/raytrace.py:213-240``), one client waiting
for each: ``Renderer.reset()``, ``step_many(batch)`` until ``spp_per_job``
iterations are done, ``beauty()`` and ``albedo_image()`` to the host, then
``denoise_beauty`` (the "RT" Filter on host arrays). The window ends at the
first job boundary at or after ``seconds``; ``msamples_per_s`` is every
sample of every job over the window's wall.

Parameters (``rtbench/traffic/<mix>.json``, under the configuration's
``traffic.<mix>``): ``spp_per_job`` (null: the configuration's ITERATIONS),
``batch``, ``check_answers`` (jobs kept for the check, and the last),
``check_pixels``, ``trace_iterations`` (the traced slice of the first job).

A loop module is what ``run.py`` drives, found by the mix's ``"loop"``:

- ``build(cfg, traffic, draws, device, resolution)``: the system under test;
- ``warm_up(prog, traffic, draws)``: the cell's own shapes, once;
- ``window(prog, traffic, draws, seconds, keep, tracer)``: the traffic for
  ``seconds``; offers each answer to ``keep`` (``core.Reservoir``) and
  profiles bounded slices through ``tracer`` (``trace.Tracer``) if given;
  returns ``attempted`` and ``end_to_end`` (metric name -> value);
- ``numbers(cfg, traffic, draws, answers, device, resolution, control)``:
  the compared numbers (and the control's, if asked), after the window.
"""

from __future__ import annotations

import time

from rtbench import check
from rtbench.program import Program

numbers = check.numbers


def spp(cfg: dict, traffic: dict) -> int:
    return traffic["spp_per_job"] or cfg["ITERATIONS"]


def build(cfg: dict, traffic: dict, draws: dict, device, resolution=None) -> Program:
    prog = Program(cfg, draws["render"], device, resolution)
    prog.spp_per_job = spp(cfg, traffic)
    return prog


def warm_up(prog: Program, traffic: dict, draws: dict) -> None:
    """One job of one batch: K1's or the graph's capture, the Filter's first call."""
    job(prog, traffic["batch"], traffic["batch"])


def job(prog: Program, iterations: int, batch: int, tracer=None, trace_iterations: int = 0):
    """One job; with ``tracer``, its first ``trace_iterations`` iterations
    (from the reset) and its end are profiled slices."""
    seg = tracer.segment("render", iterations=min(trace_iterations, iterations)) if tracer else None
    if seg:
        seg.start()
    prog.reset()
    done = 0
    while done < iterations:
        n = min(batch, iterations - done)
        prog.step_many(n)
        done += n
        if seg and done >= trace_iterations:
            seg.stop()
            seg = None
    end = tracer.segment("finish") if tracer else None
    if end:
        end.start()
    out = prog.finish_job()
    if end:
        end.stop()
    out.update(position=None, since=done)
    return out


def window(prog: Program, traffic: dict, draws: dict, seconds: float, keep, tracer=None) -> dict:
    times = []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = job(prog, prog.spp_per_job, traffic["batch"], tracer if not times else None,
                  traffic.get("trace_iterations", 0))
        now = time.perf_counter()
        times.append(now - t)
        keep.offer(keep.wants(), out)
        if now - t0 >= seconds:
            break
    elapsed = now - t0
    samples = prog.spp_per_job * len(times) * prog.pixels
    return dict(attempted=len(times), times=times, elapsed=elapsed,
                end_to_end=dict(msamples_per_s=samples / elapsed / 1e6))
