"""The four-card Cornell job on the CPU: the raytrace app's
``render_multichip`` in sample mode over ``("cpu",) * 4`` against the
benchmark's plain reference (``rtbench/reference/``), the cell
``cornell4card.converge`` run whole at a tiny size, two faults of the mesh
and the control that its check must catch, and the cell's four per-layer
readers on plain slices.

Tolerances: ``rtbench/check.py``'s per-channel ones (beauty 1e-4 + 1e-3 *
|ref|, albedo 1e-4) at every pixel.
"""

from __future__ import annotations

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.apps import raytrace
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.parallel import make_mesh, mesh as mesh_mod
from mygpuraytracer_tpu_torch.parallel import sharded
from mygpuraytracer_tpu_torch.render import Renderer, megakernel
from mygpuraytracer_tpu_torch.scene import load_scene
from rtbench import check, core, run, trace

REPO = pathlib.Path(__file__).resolve().parent.parent
CELL = "cornell4card.converge"
SEED = 2**31 + 77
RES = 12
NEW_FILES = ["program_mesh.py", "loops/converge_mesh.py", "metrics/idle_share.mesh.py",
             "metrics/k1_cards_overlap.py", "metrics/peer_copy_ms_per_job.py",
             "metrics/mesh_render_mfu.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "mygpuraytracer_tpu"}


@pytest.fixture(autouse=True)
def _in_repo(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.chdir(REPO)


def _config():
    return core.cell(core.manifest(), CELL)["config"]


def _renderer(cfg, seed, megakernel_on=True):
    scene = load_scene(cfg["scene"])
    scene.set_resolution(RES, RES)
    scene.state.trace_depth = cfg["DEPTH"]
    options = RenderOptions(**dict(cfg["options"], megakernel=megakernel_on))
    return Renderer(scene, options, seed=seed, device="cpu")


def _tiny(**kw):
    return run.run_cell(CELL, SEED, 0.2, False, device="cpu", resolution=(RES, RES),
                        overrides=dict(ITERATIONS=8, host_threads=2), **kw)


# ---- the app's function ---------------------------------------------------------------


@pytest.mark.parametrize("megakernel_on", [True, False], ids=["k1", "wavefront"])
def test_sample_mode_over_four_devices_matches_the_reference(megakernel_on):
    cfg = _config()
    r = _renderer(cfg, 9, megakernel_on)
    logged = []
    done = raytrace.render_multichip(r, r.options, 8, "sample", logged.append,
                                     mesh=make_mesh(devices=("cpu",) * 4))
    assert done == 8 and r.iteration == 8
    assert logged == ["multichip sample-parallel: 8 iterations over 4 devices"]
    ref = check.Reference(cfg, "cpu", (RES, RES))
    pixels = np.arange(RES * RES)
    rb, ra = ref.render(pixels, 8, 9)
    got = check.render_numbers(r.beauty(), r.albedo_image(), rb, ra, pixels)
    assert got["beauty_bad_share"] == 0 and got["albedo_bad_share"] == 0, got


def test_a_one_device_mesh_keeps_the_sequential_path():
    r = _renderer(_config(), 9)
    logged = []
    assert raytrace.render_multichip(r, r.options, 8, "sample", logged.append,
                                     mesh=make_mesh(devices=("cpu",))) == 0
    assert r.iteration == 0
    assert logged == ["multichip: single device visible; using the sequential path"]


def test_the_default_mesh_off_cuda_is_the_renderers_device():
    r = _renderer(_config(), 9)
    logged = []
    assert raytrace.render_multichip(r, r.options, 4, "pixels", logged.append) == 0
    assert "single device visible" in logged[0]


# ---- the cell -------------------------------------------------------------------------


def test_the_cell_at_a_tiny_size_is_correct():
    r = _tiny()
    line = run.result_line(r)
    assert line["correct"] is True and line["attempted"] >= 1, line["checks"]
    assert set(line["metrics"]) == {"msamples_per_s", "setup_s"}
    assert all(c["value"] == 0 for c in line["checks"].values()), line["checks"]


def test_the_cell_runs_the_apps_function(monkeypatch):
    calls = []
    real = raytrace.render_multichip

    def counting(r, options, iterations, mode, log, mesh=None):
        calls.append((iterations, mode, mesh.size))
        return real(r, options, iterations, mode, log, mesh)

    monkeypatch.setattr(raytrace, "render_multichip", counting)
    r = _tiny()
    assert r["correct"] is True
    assert calls[0] == (16, "sample", 4)  # the warm-up job, one batch
    assert set(calls[1:]) == {(8, "sample", 4)} and len(calls) - 1 == r["attempted"]


def test_a_program_without_the_apps_function_fails_at_once(monkeypatch):
    monkeypatch.delattr(raytrace, "render_multichip")
    with pytest.raises(ImportError):
        _tiny()


def test_the_program_renders_a_job_from_a_reset_and_whole_over_the_mesh():
    from rtbench.program_mesh import MeshProgram

    prog = MeshProgram(dict(_config(), ITERATIONS=8), 5, "cpu", (8, 8))
    assert prog.mesh.size == 4
    with pytest.raises(ValueError, match="do not split"):
        prog.step_many(6)
    prog.reset()
    prog.step_many(4)
    with pytest.raises(ValueError, match="reset"):
        prog.step_many(4)


def one_card_left_out(monkeypatch):
    """The sum drops the last device's share."""
    real = mesh_mod.psum
    monkeypatch.setattr(sharded, "psum", lambda tensors, mesh: real(
        list(tensors[:-1]) + [torch.zeros_like(tensors[-1])], mesh))


def every_card_from_iteration_1(monkeypatch):
    """Every device renders iterations 1 .. spp / D."""
    real = megakernel.accumulate
    monkeypatch.setattr(megakernel, "accumulate", lambda dev, meta, options, acc, start, n, key,
                        **kw: real(dev, meta, options, acc, 1, n, key, **kw))


@pytest.mark.parametrize("fault", [one_card_left_out, every_card_from_iteration_1],
                         ids=lambda f: f.__name__)
def test_a_mesh_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = _tiny()
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["beauty_bad_share"]["value"] > r["checks"]["beauty_bad_share"]["limit"]


def test_the_control_fails_a_number():
    r = _tiny(control=True)
    ok, checks = check.verdict(r["control"], core.cell(core.manifest(), CELL)["limits"])
    assert ok is False, checks


@pytest.mark.parametrize("path", NEW_FILES)
def test_the_new_benchmark_files_import_no_jax(path):
    tree = ast.parse((REPO / "rtbench" / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    assert not FORBIDDEN & names
    if path.startswith("metrics/"):
        assert not names  # a reader reads the Trace alone


# ---- the readers ----------------------------------------------------------------------

PEAKS = {"fp32": 67e12}
WORK = {"render_flops_per_sample": 3610.7, "unet_flops_per_frame": 1.0}
K1 = "void (anonymous namespace)::k1_kernel<false, false>(float const*, float*, int*)"


def _segment(role, device, wall_s, iterations=0):
    """A slice whose stats are reduced from plain (start_us, end_us, name)."""
    seg = trace.Segment(role, iterations=iterations)
    host = [(0.0, wall_s * 1e6, "rtbench.render_multichip")]
    seg.stats = trace.reduce_events(device, host, wall_s)
    return seg


def _trace(*segments, pixels=640000):
    return trace.Trace(list(segments), "k1", pixels, WORK, PEAKS)


def reader(name):
    return core.module("metrics", name).read


def test_four_overlapping_k1_intervals_read_four_cards():
    render = _segment("render", [(0.0, 1e6, K1)] * 4, 1.0, iterations=4096)
    assert reader("k1_cards_overlap")(_trace(render)) == pytest.approx(4.0)
    assert reader("idle_share.mesh")(_trace(render)) == pytest.approx(0.0)


def test_serialised_k1_intervals_read_one_card():
    device = [(q * 0.25e6, (q + 1) * 0.25e6, K1) for q in range(4)]
    render = _segment("render", device, 1.0, iterations=4096)
    assert reader("k1_cards_overlap")(_trace(render)) == pytest.approx(1.0)
    assert reader("idle_share.mesh")(_trace(render)) == pytest.approx(0.75)


def test_one_busy_card_of_four_reads_three_quarters_idle():
    render = _segment("render", [(0.0, 0.8e6, K1)], 0.8, iterations=4096)
    finish = _segment("finish", [(0.0, 0.2e6, "Memcpy DtoH (Device -> Pageable)")], 0.2)
    t = _trace(render, finish)
    assert reader("idle_share.mesh")(t) == pytest.approx(0.75)
    assert t.busy_s(("render", "finish")) == pytest.approx(1.0)  # the union reads it busy


def test_peer_copies_per_job_and_the_mesh_share_of_the_peak():
    device = [(0.0, 0.5e6, K1), (0.5e6, 0.5003e6, "Memcpy PtoP (Device -> Device)"),
              (0.5003e6, 0.5005e6, "Memcpy PtoP (Device -> Device)"),
              (0.5005e6, 0.5009e6, "Memcpy DtoD (Device -> Device)")]
    render = _segment("render", device, 0.6, iterations=4096)
    finish = _segment("finish", [], 0.4)
    t = _trace(render, finish, pixels=100)
    assert reader("peer_copy_ms_per_job")(t) == pytest.approx(0.5)
    assert reader("mesh_render_mfu")(t) == pytest.approx(
        100.0 * 3610.7 * 4096 * 100 / 1.0 / (4 * 67e12))


@pytest.mark.parametrize("name", ["idle_share.mesh", "k1_cards_overlap", "peer_copy_ms_per_job",
                                  "mesh_render_mfu"])
def test_a_reader_finds_nothing_without_its_slices(name):
    frames = trace.Segment("frames", frames=4)
    frames.stats = trace.reduce_events([(0.0, 1e3, K1)], [], 0.01)
    assert reader(name)(_trace()) is None
    assert reader(name)(_trace(frames)) is None


def test_the_manifest_names_the_cell_and_its_readers():
    man = core.manifest()
    entry = next(w for w in man["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 4 and entry["config"] == "cornell4card"
    spec = core.cell(man, CELL)
    assert spec["traffic"]["loop"] == "converge_mesh"
    assert spec["config"]["ITERATIONS"] == 4096 and spec["config"]["cards"] == 4
    assert {m["name"] for m in spec["end_to_end"]} == {"msamples_per_s", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {
        "idle_share.mesh", "k1_cards_overlap", "peer_copy_ms_per_job", "mesh_render_mfu"}
    assert os.path.isfile(REPO / "rtbench" / "limits" / f"{CELL}.json")
