"""The raytrace app's ``--multichip sample`` job, one client waiting for
each: ``loops/converge.py``'s job and window (loaded from that file, not
copied) over ``program_mesh.MeshProgram``, whose ``step_many`` is the app's
``render_multichip`` over the configuration's cards. Each job renders its
``spp_per_job`` iterations in one such call (the mix's ``batch`` sizes only
the warm-up job), so the traced render slice is the job's reset, the call
with its launches and its sum, and its finish slice the job's end.

Parameters: those of ``loops/converge.py``; the configuration sets
``trace_iterations`` to the job's iterations, so the first job is traced
whole. ``msamples_per_s`` counts every card's samples.
"""

from __future__ import annotations

from rtbench import check, core
from rtbench.program_mesh import MeshProgram

converge = core.module("loops", "converge")
numbers = check.numbers
# One job of one batch over the mesh: every card's context, K1's load there,
# the copies' first use and the Filter's first call.
warm_up = converge.warm_up


def build(cfg: dict, traffic: dict, draws: dict, device, resolution=None) -> MeshProgram:
    prog = MeshProgram(cfg, draws["render"], device, resolution)
    prog.spp_per_job = converge.spp(cfg, traffic)
    return prog


def window(prog: MeshProgram, traffic: dict, draws: dict, seconds: float, keep,
           tracer=None) -> dict:
    return converge.window(prog, dict(traffic, batch=prog.spp_per_job), draws, seconds, keep,
                           tracer)
