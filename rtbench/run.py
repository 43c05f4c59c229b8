"""The benchmark of the PyTorch + CUDA port on one NVIDIA card.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs the cell ``<config>.<traffic>`` of ``BENCHMARK.json`` (from the root of
a checkout) and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number with
its limit, which also end standard error.

The cell's traffic mix names its loop (``rtbench/loops/<loop>.py``), which
builds the system under test and warms up its shapes: with the imports and
the kernels' builds, that is ``setup_s``. The loop then drives the window
for ``--seconds``; the program is freed, and what it produced is checked
against the plain reference. Without a CUDA card, or with JAX or the JAX
package loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtbench import check, core, trace, work  # noqa: E402

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def host_threads(cfg: dict) -> None:
    """torch's CPU threads as the configuration states them (``host_threads``;
    absent: torch's default)."""
    if cfg.get("host_threads"):
        torch.set_num_threads(int(cfg["host_threads"]))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             resolution=None, man=None, patch=None, overrides=None,
             control: bool = False) -> dict:
    """One run of a cell; returns the result line's fields, and ``values``
    (every reading of the check) and the loop's per-answer ``times``.
    ``resolution``, ``overrides`` (keys laid over the configuration's) and
    ``patch`` (a callable given the system under test, which may break it)
    serve the tests; ``device`` "cpu" runs the port's plain versions there.
    ``control`` adds the control's readings on the same answers
    (``result["control"]``)."""
    spec = core.cell(man or core.manifest(), workload, overrides)
    cfg, traffic, loop = spec["config"], spec["traffic"], spec["loop"]
    host_threads(cfg)
    draws = check.seeds(seed)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sut = loop.build(cfg, traffic, draws, device, resolution)
    if patch is not None:
        patch(sut)
    loop.warm_up(sut, traffic, draws)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    keep = core.Reservoir(traffic["check_answers"], draws["keep"])
    tracer = trace.Tracer() if traced else None
    out = loop.window(sut, traffic, draws, seconds, keep, tracer)
    answers = keep.answers()
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    dev = dict(platform="gpu" if on_card else "cpu", kind=name,
               count=torch.cuda.device_count() if on_card else 1,
               memory_peak_bytes=int(torch.cuda.max_memory_allocated()) if on_card else 0,
               power_limit_w=power_limit_w() if on_card else None)
    route, pixels = getattr(sut, "route", None), sut.pixels
    sut.close()
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    e2e = dict(out["end_to_end"], setup_s=setup_s)
    result = dict(attempted=out["attempted"], failed=0, device=dev, times=out["times"])
    if traced:
        t = trace.Trace(tracer.segments, route, pixels, work.counts(cfg, resolution),
                        work.peaks(name))
        metrics = {}
        for m in spec["per_layer"]:
            v = m["read"](t)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        dev.update(busy_s=t.busy_s(), window_s=t.wall_s())
        result["breakdown"] = t.breakdown()
    else:
        metrics = {m["name"]: dict(value=float(e2e[m["name"]]), unit=m["unit"])
                   for m in spec["end_to_end"]}
    result["metrics"] = metrics

    values, ctrl = loop.numbers(cfg, traffic, draws, answers, device, resolution, control)
    ok, checks = check.verdict(values, spec["limits"])
    ok = ok and out["attempted"] > 0 and not any(a.get("random_weights") for a in answers)
    result.update(correct=bool(ok), checks=checks, values=values)
    if control:
        result["control"] = ctrl
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = core.manifest()
    chips = next(w["chips"] for w in man["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return EXIT_NO_CARD
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), man=man)
    loaded = core.forbidden_modules(sys.modules)
    if loaded:
        print(f"rtbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result_line(result)))
    return 0


def result_line(result: dict) -> dict:
    """The last line's object: its keys in order, ``checks`` last."""
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                   "breakdown") if k in result}
    line["checks"] = result["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
