"""A whole run at a tiny size on the CPU (the port's plain versions), the
last line's schema, no CPU fallback from the command, and a run on the card
(``requires_cuda``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from rtbench import run
from tiny import tiny_run


@pytest.mark.parametrize("workload", ["cornell.converge", "cornellShipTex.still",
                                      "cornellShipTex.drag"])
def test_last_line_schema(in_repo, workload):
    r = tiny_run(workload, res=8 if "Ship" in workload else 12)
    line = run.result_line(r)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    assert "setup_s" in line["metrics"]
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    json.loads(json.dumps(line))


def test_no_cpu_fallback(in_repo, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cornell.converge", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_command_without_a_card_exits_non_zero(in_repo):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "cornell.converge",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    from rtbench import core

    mods = ["mygpuraytracer_tpu_torch", "mygpuraytracer_tpu_torch.render", "jaxtyping", "torch"]
    assert core.forbidden_modules(mods) == []
    assert core.forbidden_modules(mods + ["jax.numpy", "mygpuraytracer_tpu.ops"]) == [
        "jax.numpy", "mygpuraytracer_tpu.ops"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_card_run_prints_a_correct_line(card, in_repo, trace):
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "cornell.converge",
                        "--seed", "123456789012", "--seconds", "2", "--trace", trace],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    if trace == "1":
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["metrics"]["k1_roofline"]["value"] <= 100
