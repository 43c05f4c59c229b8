"""The readings that the correctness limits are set from, on the card.

    python3 rtbench/calibrate.py --workload <cell> --seeds 12 --control 3 --seconds 2

runs the cell's set-up, a short window and the check once per seed in one
process (seeds 1000 + i), and prints one JSON line per seed with the
numbers of ``check.py`` (``values``); for the first ``--control`` seeds also
the control's readings on the same answers (``control``: the reference in
the program's place one precision below the configuration's). The limits
in ``rtbench/limits/<cell>.json`` lie between the program's largest reading
and the control's smallest, as PERF.md sets out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return run.EXIT_NO_CARD
    for i in range(args.seeds):
        seed = args.first + i
        r = run.run_cell(args.workload, seed, args.seconds, False, control=i < args.control)
        print(json.dumps(dict(workload=args.workload, seed=seed, attempted=r["attempted"],
                              correct=r["correct"], values=r["values"],
                              control=r.get("control"), metrics=r["metrics"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
