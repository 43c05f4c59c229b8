"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from rtbench import core

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return core.manifest(os.path.join(REPO, core.MANIFEST))


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    assert all(not p.endswith("_torch") and not p.startswith("/") and ".." not in p
               for p in man["paths"])
    assert 1 <= len(man["command"]) <= 32 and all(one_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_a_full_check_fits_with_24_cells(man):
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries(man):
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in man[sec]]
    assert all(NAME.match(n) for n in names)
    for sec in ("configs", "workloads"):
        assert len({e["name"] for e in man[sec]}) == len(man[sec])
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(man["paths"][0] + "/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(man["workloads"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert next(m for m in man["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_each_metric_moves_one_end_to_end_metric_its_cells_report(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = [w["name"] for w in man["workloads"]]
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and core.reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        reported = [m["name"] for m in man["end_to_end"] if core.reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(core.reports(m, cell) for m in man["per_layer"])


def test_rooflines_and_peak_shares_are_percent(man):
    for m in man["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in man["per_layer"]
               if any(r["name"].endswith("_roofline") and r["moves"] == m["moves"]
                      for r in man["per_layer"]))


def test_at_most_a_quarter_of_cells_take_four_chips(man):
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


CELLS = ["cornell.converge", "cornellShipTex.converge", "cornellShipTex.still",
         "cornellShipTex.drag"]


def test_the_cells_are_these(man):
    assert [w["name"] for w in man["workloads"]] == CELLS


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(man, workload):
    spec = core.cell(man, workload)
    entry = spec["entry"]
    assert spec["config"]["scene"] and os.path.isfile(os.path.join(REPO, spec["config"]["scene"]))
    loop = spec["loop"]
    assert os.path.isfile(os.path.join(core.ROOT, "loops", f"{spec['traffic']['loop']}.py"))
    assert all(callable(getattr(loop, f)) for f in ("build", "warm_up", "window", "numbers"))
    assert set(spec["limits"]) == {"beauty_bad_share", "albedo_bad_share", "denoise_rel_rmse"}
    for m in spec["per_layer"]:
        assert callable(m["read"])
        assert os.path.isfile(os.path.join(core.ROOT, "metrics", f"{m['name']}.py"))
    assert any(c["name"] == entry["config"] and c["file"] ==
               f"rtbench/configs/{entry['config']}.json" for c in man["configs"])


def test_a_cell_is_found_from_files_alone(man, tmp_path, monkeypatch):
    """A new traffic mix of an existing loop, its limits and a metric reader,
    placed as files, are picked up by name through the manifest."""
    root = tmp_path / "rtbench"
    for sub in ("configs", "traffic", "limits", "metrics", "loops"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "cornell.json").write_text(
        (open(os.path.join(core.ROOT, "configs", "cornell.json")).read()))
    (root / "loops" / "frames.py").write_text(
        open(os.path.join(core.ROOT, "loops", "frames.py")).read())
    (root / "traffic" / "swing.json").write_text(json.dumps(
        dict(loop="frames", spp_per_frame=1, drag_px=40, sweep_frames=8,
             check_answers=3, check_pixels=64)))
    (root / "limits" / "cornell.swing.json").write_text(json.dumps(
        dict(beauty_bad_share=1, albedo_bad_share=1, denoise_rel_rmse=1)))
    (root / "metrics" / "moves_per_frame.py").write_text("def read(t):\n    return 0.25\n")
    monkeypatch.setattr(core, "ROOT", str(root))
    new = dict(man, workloads=man["workloads"] + [
        dict(name="cornell.swing", config="cornell", traffic="swing", chips=1, why="x")],
        per_layer=[dict(name="moves_per_frame", unit="moves/frame", better="lower",
                        source="host_clock", layer="Renderer", moves="frames_per_s",
                        workloads=["cornell.swing"])])
    new["end_to_end"] = [dict(m, workloads=m.get("workloads", []) + ["cornell.swing"])
                         if m["name"] in ("frames_per_s", "frame_ms_p95") else m
                         for m in man["end_to_end"]]
    spec = core.cell(new, "cornell.swing")
    assert spec["traffic"]["drag_px"] == 40 and spec["loop"].sweep(9, 8) == 7
    assert [m["read"](None) for m in spec["per_layer"]] == [0.25]
    assert {m["name"] for m in spec["end_to_end"]} == {"frames_per_s", "frame_ms_p95", "setup_s"}


DUMMY_LOOP = """
class Sut:
    pixels, route, closed = 16, None, False

    def close(self):
        Sut.closed = True


def build(cfg, traffic, draws, device, resolution=None):
    return Sut()


def warm_up(sut, traffic, draws):
    sut.warm = True


def window(sut, traffic, draws, seconds, keep, tracer=None):
    n = traffic["answers"]
    for i in range(n):
        keep.offer(keep.wants(), dict(answer=i * traffic["step"]))
    return dict(attempted=n, times=[0.25] * n, end_to_end=dict(answers_per_s=n / (0.25 * n)))


def numbers(cfg, traffic, draws, answers, device, resolution=None, control=False):
    wrong = sum(a["answer"] % traffic["step"] != 0 for a in answers)
    return dict(wrong_answers=float(wrong)), None
"""


def test_a_new_loop_is_only_files(man, tmp_path, monkeypatch):
    """A loop that is only ``rtbench/loops/<loop>.py``, named by a new traffic
    file, is built, warmed up, driven and checked by run.py, unchanged."""
    from rtbench import run

    root = tmp_path / "rtbench"
    for sub in ("configs", "traffic", "limits", "loops"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "counter.json").write_text(json.dumps(dict(scene="none")))
    (root / "traffic" / "tally.json").write_text(json.dumps(
        dict(loop="tally", answers=10, step=3, check_answers=2)))
    (root / "limits" / "counter.tally.json").write_text(json.dumps(dict(wrong_answers=0)))
    (root / "loops" / "tally.py").write_text(DUMMY_LOOP)
    monkeypatch.setattr(core, "ROOT", str(root))
    new = dict(man, workloads=[dict(name="counter.tally", config="counter", traffic="tally",
                                    chips=1, why="x")],
               end_to_end=[dict(name="answers_per_s", unit="answers/s", better="higher",
                                bound=0.01, source="host_clock"),
                           next(m for m in man["end_to_end"] if m["name"] == "setup_s")],
               per_layer=[])
    r = run.run_cell("counter.tally", 5, 1.0, False, device="cpu", man=new)
    line = run.result_line(r)
    assert line["correct"] is True and line["attempted"] == 10
    assert line["metrics"]["answers_per_s"]["value"] == 4.0 and "setup_s" in line["metrics"]
    assert line["checks"] == {"wrong_answers": {"value": 0.0, "limit": 0}}
