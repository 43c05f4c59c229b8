"""Training-log visualizer (training/visualize.py equivalent, minus the
matplotlib dependency): renders loss/LR curves from a result dir's log.jsonl
to the terminal, or to a standalone SVG with --svg. The port's copy of
``mygpuraytracer_tpu/apps/visualize.py``: the same text and SVG.

Usage: python -m mygpuraytracer_tpu_torch.apps.visualize RESULT_DIR [--key loss] [--svg out.svg]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def read_log(result_dir: str):
    path = os.path.join(result_dir, "log.jsonl")
    records = []
    with open(path) as f:
        for line in f:
            records.append(json.loads(line))
    return records


def ascii_plot(xs, ys, width=72, height=16, label=""):
    if not ys:
        return "(no data)"
    lo, hi = min(ys), max(ys)
    span = (hi - lo) or 1.0
    grid = [[" "] * width for _ in range(height)]
    n = len(ys)
    for i, y in enumerate(ys):
        col = int(i * (width - 1) / max(n - 1, 1))
        row = height - 1 - int((y - lo) / span * (height - 1))
        grid[row][col] = "*"
    lines = ["".join(row) for row in grid]
    return (
        f"{label}  max={hi:.4g}  min={lo:.4g}\n"
        + "\n".join(lines)
        + f"\nepoch {xs[0]} .. {xs[-1]}"
    )


def svg_plot(xs, ys, path, label=""):
    w, h, pad = 640, 240, 32
    lo, hi = min(ys), max(ys)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{pad + i * (w - 2 * pad) / max(len(ys) - 1, 1):.1f},"
        f"{h - pad - (y - lo) / span * (h - 2 * pad):.1f}"
        for i, y in enumerate(ys)
    )
    with open(path, "w") as f:
        f.write(
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}">'
            f'<rect width="{w}" height="{h}" fill="white"/>'
            f'<polyline points="{pts}" fill="none" stroke="#1f77b4" stroke-width="1.5"/>'
            f'<text x="{pad}" y="{pad - 10}" font-size="12">{label} '
            f"(min {lo:.4g}, max {hi:.4g})</text></svg>"
        )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="visualize training logs")
    p.add_argument("result_dir")
    p.add_argument("--key", default="loss", help="record field to plot")
    p.add_argument("--svg", help="write an SVG to this path instead of ASCII")
    args = p.parse_args(argv)

    records = read_log(args.result_dir)
    xs = [r["epoch"] for r in records]
    ys = [r[args.key] for r in records]
    if args.svg:
        svg_plot(xs, ys, args.svg, label=args.key)
        print(f"wrote {args.svg}")
    else:
        print(ascii_plot(xs, ys, label=args.key))
    return 0


if __name__ == "__main__":
    sys.exit(main())
