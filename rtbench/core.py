"""The manifest, the files of a cell found by name, and the statistics every
run uses.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` reads:

- ``rtbench/configs/<config>.json``: the configuration as it is run;
- ``rtbench/traffic/<traffic>.json``: the traffic mix, parameters of the
  loop it names (``"loop"``);
- ``rtbench/loops/<loop>.py``: the loop, which builds the system under
  test, warms it up, drives the window and computes the numbers that
  decide ``correct`` (see ``loops/converge.py`` for the interface);
- ``rtbench/limits/<cell>.json``: the limits of its correctness numbers;
- ``rtbench/metrics/<metric>.py``: one reader per per-layer metric.

A later cell, configuration, mix, loop or metric is new files and new
entries of the manifest; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MANIFEST = "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "mygpuraytracer_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: str = MANIFEST) -> dict:
    return load_json(path)


def cell(man: dict, workload: str, overrides: dict | None = None) -> dict:
    """The manifest's entry of ``workload`` with its files loaded: the
    configuration, the traffic mix (the configuration's own values for that
    mix laid over the mix's) and its loop, the limits, and the per-layer
    metrics that the cell reports, each with its reader. ``overrides`` are
    laid over the configuration's keys (the tests' small sizes)."""
    entry = next((w for w in man["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {MANIFEST}")
    cfg = load_json(os.path.join(ROOT, "configs", f"{entry['config']}.json"))
    cfg.update(overrides or {})
    traffic = load_json(os.path.join(ROOT, "traffic", f"{entry['traffic']}.json"))
    traffic = {**traffic, **cfg.get("traffic", {}).get(entry["traffic"], {})}
    limits = load_json(os.path.join(ROOT, "limits", f"{workload}.json"))
    return dict(entry=entry, config=cfg, traffic=traffic, loop=module("loops", traffic["loop"]),
                limits=limits,
                end_to_end=[m for m in man["end_to_end"] if reports(m, workload)],
                per_layer=[dict(m, read=module("metrics", m["name"]).read)
                           for m in man["per_layer"] if reports(m, workload)])


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def module(kind: str, name: str):
    """``rtbench/<kind>/<name>.py`` loaded as a module: a loop, or a metric
    reader (``read(trace) -> float | None``)."""
    path = os.path.join(ROOT, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p95(values) -> float:
    """The 95th percentile, linearly interpolated between order statistics
    (``statistics.quantiles(..., n=20, method="inclusive")``'s 19th cut)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])


class Reservoir:
    """``k`` answers drawn uniformly from a stream of unknown length, and
    the last one: what the check compares once the window has closed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen, self.last = k, rng, [], 0, None

    def wants(self) -> int | None:
        """The slot the next answer would take (None: dropped unless last)."""
        if len(self.items) < self.k:
            return len(self.items)
        j = int(self.rng.integers(0, self.seen + 1))
        return j if j < self.k else None

    def offer(self, slot: int | None, item) -> None:
        if slot is not None:
            if slot == len(self.items):
                self.items.append(item)
            else:
                self.items[slot] = item
        self.last = item
        self.seen += 1

    def answers(self) -> list:
        out = list(self.items)
        if self.last is not None and all(self.last is not it for it in out):
            out.append(self.last)
        return out


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)
