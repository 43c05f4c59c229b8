"""``correct`` comes out false when the timed path is broken underneath: a
run at a tiny size on the CPU, the look for a card skipped, with one fault
planted per case; and the control (the reference one precision below the
configuration's in the program's place) fails a number at that size."""

from __future__ import annotations

import numpy as np
import pytest

from rtbench import check, core
from tiny import tiny_run


def tiny(workload, patch=None, control=False):
    res = 8 if workload.startswith("cornellShipTex") else 12
    return tiny_run(workload, seed=987654321987, seconds=0.3, res=res, iterations=4,
                    patch=patch, control=control)


def state_unchanged(prog):
    """step_many counts its iterations and renders none."""
    r = prog.r

    def step_many(n):
        r.iteration += n
        return r.iteration
    r.step_many = step_many


def half_the_batch(prog):
    """step_many renders half of its iterations; the beauty is the mean
    over those it rendered."""
    r, real = prog.r, prog.r.step_many
    r.step_many = lambda n: real(max(n // 2, 1))


def beauty_altered(prog):
    r, real = prog.r, prog.r.beauty
    r.beauty = lambda: real() * np.float32(1.05)


def denoised_altered(prog):
    real = prog._denoise_beauty

    def denoise(beauty, albedo, device):
        out, timings = real(beauty, albedo, device)
        return out * np.float32(0.8), timings
    prog._denoise_beauty = denoise


def frame_denoised_altered(prog):
    r, real = prog.r, prog.r.render_denoised

    def render_denoised(iterations=None, **kw):
        den, beauty = real(iterations=iterations, **kw)
        return den * np.float32(0.8), beauty
    r.render_denoised = render_denoised


def frame_state_unchanged(prog):
    state_unchanged(prog)


def camera_left_in_place(prog):
    """move_camera zeroes the image and leaves the camera where it was."""
    r = prog.r
    r.move_camera = lambda **kw: r.reset()


WORKLOADS = ["cornell.converge", "cornellShipTex.still", "cornellShipTex.drag"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(in_repo, workload):
    assert tiny(workload)["correct"] is True


@pytest.mark.parametrize("workload,fault", [
    ("cornell.converge", state_unchanged),
    ("cornell.converge", half_the_batch),
    ("cornell.converge", beauty_altered),
    ("cornell.converge", denoised_altered),
    ("cornellShipTex.still", frame_state_unchanged),
    ("cornellShipTex.still", frame_denoised_altered),
    ("cornellShipTex.drag", frame_state_unchanged),
    ("cornellShipTex.drag", frame_denoised_altered),
    ("cornellShipTex.drag", camera_left_in_place),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(in_repo, workload, fault):
    r = tiny(workload, patch=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_a_number(in_repo, workload):
    r = tiny(workload, control=True)
    limits = core.cell(core.manifest(), workload)["limits"]
    ok, checks = check.verdict(r["control"], limits)
    assert ok is False, checks
