"""Image comparison CLI (training/compare_image.py equivalent).

Usage: python -m mygpuraytracer_tpu_torch.apps.compare_image A B [--metric psnr ssim rmse]
Exit code 0 when the metrics print; 1 on a shape mismatch; with
--threshold METRIC VALUE, 2 when the metric is worse than the bound
(rmse/mse: above; psnr/ssim: below). The port of
``mygpuraytracer_tpu/apps/compare_image.py``; ``--device`` (default cuda)
is where SSIM runs, the other metrics run in numpy.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="compare two images")
    p.add_argument("image_a")
    p.add_argument("image_b")
    p.add_argument("--metric", nargs="+", default=["psnr", "rmse"],
                   choices=["mse", "rmse", "psnr", "ssim"])
    p.add_argument("--threshold", nargs=2, metavar=("METRIC", "VALUE"), default=None)
    p.add_argument("--device", default="cuda", help="torch device of SSIM (default cuda)")
    args = p.parse_args(argv)

    from ..train.infer import METRICS
    from ..utils.image_io import load_image

    a = load_image(args.image_a)
    b = load_image(args.image_b)
    if a.shape != b.shape:
        print(f"error: shape mismatch {a.shape} vs {b.shape}", file=sys.stderr)
        return 1

    def metric_value(m):
        return METRICS[m](a, b, device=args.device) if m == "ssim" else METRICS[m](a, b)

    values = {}
    for m in args.metric:
        values[m] = metric_value(m)
        print(f"{m} = {values[m]:.6g}")

    if args.threshold:
        metric, bound = args.threshold[0], float(args.threshold[1])
        v = values.get(metric) or metric_value(metric)
        higher_is_better = metric in ("psnr", "ssim")
        ok = v >= bound if higher_is_better else v <= bound
        if not ok:
            print(f"FAIL: {metric} {v:.6g} vs bound {bound}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
