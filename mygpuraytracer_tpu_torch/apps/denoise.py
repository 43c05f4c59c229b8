"""Standalone denoise CLI, the oidnDenoise app (apps/oidnDenoise.cpp).

Usage:
    python -m mygpuraytracer_tpu_torch.apps.denoise --ldr color.pfm --alb albedo.pfm -o out.pfm

The flags of ``mygpuraytracer_tpu/apps/denoise.py``, which mirror the
reference (oidnDenoise.cpp:24-37):
    -f RT|RTLightmap, --hdr / --ldr / --srgb / --dir, --alb FILE, --nrm FILE,
    --clean_aux, --prefilter_aux, --is SCALE, -w WEIGHTS.tza, --maxmem MB,
    -o OUT, -r REF, --threshold, --half, --inplace, --bench N,
    --threads / --affinity (accepted, no-ops), -v VERBOSE,
and ``--device`` (default cuda; ``cpu`` on request) in place of the JAX
app's ``--platform``. Reference compare uses the reference thresholds
(oidnDenoise.cpp:362): 1e-4 (f32) by default, 1e-2 when --half processes
images as Half3; differing pixels exit with 2.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AI denoiser, PyTorch + CUDA (oidnDenoise parity)")
    p.add_argument("-f", "--filter", default="RT", choices=["RT", "RTLightmap"])
    p.add_argument("--hdr", dest="color_hdr", metavar="FILE", help="HDR color image")
    p.add_argument("--ldr", dest="color_ldr", metavar="FILE", help="LDR color image")
    p.add_argument("--srgb", action="store_true")
    p.add_argument("--dir", dest="directional", metavar="FILE",
                   help="directional lightmap image (RTLightmap)")
    p.add_argument("--alb", metavar="FILE", help="albedo image")
    p.add_argument("--nrm", metavar="FILE", help="normal image")
    p.add_argument("--clean_aux", action="store_true",
                   help="aux inputs are already noise-free (oidnDenoise parity: "
                        "flag only, no prefiltering)")
    p.add_argument("--prefilter_aux", action="store_true",
                   help="denoise albedo/normal with the rt_alb/rt_nrm prefilter "
                        "nets first, then run the main filter with cleanAux "
                        "(calb/cnrm weights) — the pipeline the cleanAux weights "
                        "are trained for (training/infer.py:46-52,71-78)")
    p.add_argument("--is", dest="input_scale", type=float, default=float("nan"))
    p.add_argument("-w", "--weights", metavar="FILE", help="custom weights .tza")
    p.add_argument("--maxmem", type=int, default=3000)
    p.add_argument("-o", "--output", metavar="FILE")
    p.add_argument("-r", "--ref", metavar="FILE", help="reference output to compare")
    p.add_argument("--threshold", type=float, default=None,
                   help="max relative error vs --ref (default 1e-4, 1e-2 with --half)")
    p.add_argument("--half", action="store_true",
                   help="feed the filter Half3 (float16) images")
    p.add_argument("--inplace", action="store_true",
                   help="use the input color buffer as the output buffer "
                        "(oidnDenoise.cpp:24-37; tiled execution routes "
                        "through a temp + final copy, unet.cpp:455-460)")
    p.add_argument("--bench", type=int, default=0, metavar="N")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--affinity", type=int, default=1)
    p.add_argument("-v", "--verbose", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..denoise import Device, OidnError
    from ..utils.image_io import compare_images, load_image, save_image

    color_path = args.color_hdr or args.color_ldr or args.directional
    hdr = args.color_hdr is not None
    directional = args.directional is not None

    device = Device(args.device)
    device.set("numThreads", args.threads)
    device.set("setAffinity", bool(args.affinity))
    device.set("verbose", args.verbose)
    device.commit()

    t0 = time.perf_counter()
    f = device.new_filter(args.filter)

    as_dtype = (lambda a: a.astype(np.float16)) if args.half else (lambda a: a)
    color = as_dtype(load_image(color_path)) if color_path else None
    shape = None
    if color is not None:
        f.set_image("color", color)
        shape = color.shape
    def prefilter(image: np.ndarray, kind: str) -> np.ndarray:
        """Denoise an aux feature with its own net (rt_alb / rt_nrm) via an
        aux-only RT filter (weight table core/unet.cpp:311-336)."""
        pf = device.new_filter("RT")
        pf.set_image(kind, image)
        out = np.zeros_like(image)
        pf.set_image("output", out)
        pf.commit()
        pf.execute()
        return out

    if args.alb:
        alb = as_dtype(load_image(args.alb))
        if args.prefilter_aux:
            alb = prefilter(alb, "albedo")
        f.set_image("albedo", alb)
        shape = shape or alb.shape
    if args.nrm:
        nrm = as_dtype(load_image(args.nrm))
        if args.prefilter_aux:
            nrm = prefilter(nrm, "normal")
        f.set_image("normal", nrm)
        shape = shape or nrm.shape
    if shape is None:
        print("error: no input image", file=sys.stderr)
        return 1

    if args.inplace:
        # output buffer IS the primary input buffer (oidnDenoise.cpp:264-266:
        # `if (inplace) output = input`); the Filter detects the aliasing and
        # uses the tiled outputTemp/outputCopy path when needed.
        output = f.images["color"] if f.images["color"] is not None else (
            f.images["albedo"] if f.images["albedo"] is not None
            else f.images["normal"]
        )
    else:
        output = np.zeros(shape, np.float16 if args.half else np.float32)
    f.set_image("output", output)
    if args.filter == "RT":
        f.set("hdr", hdr)
        f.set("srgb", args.srgb)
        f.set("cleanAux", args.clean_aux or args.prefilter_aux)
    else:
        f.set("directional", directional)
    f.set("maxMemoryMB", args.maxmem)
    f.set("inputScale", args.input_scale)
    if args.weights:
        with open(args.weights, "rb") as fh:
            f.set_data("weights", fh.read())

    cancelled = {"flag": False}
    signal.signal(signal.SIGINT, lambda *a: cancelled.update(flag=True))

    def monitor(p):
        print(f"\rDenoising {int(p * 100)}%", end="", flush=True)
        return not cancelled["flag"]

    f.set_progress_monitor_function(monitor)
    try:
        f.commit()
    except OidnError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"  filter init: {1000 * (time.perf_counter() - t0):.1f} ms")
    if f.using_random_weights:
        print("warning: no trained weights found — using random init", file=sys.stderr)

    t0 = time.perf_counter()
    try:
        f.execute()
    except OidnError as e:
        print(f"\nerror: {e}", file=sys.stderr)
        return 1
    print(f"\n  denoise: {1000 * (time.perf_counter() - t0):.1f} ms")

    if args.output:
        save_image(args.output, output)

    if args.ref:
        ref = load_image(args.ref)
        threshold = args.threshold
        if threshold is None:
            threshold = 1e-2 if args.half else 1e-4
        n_err, max_err = compare_images(
            np.asarray(output, np.float32), ref, threshold)
        print(f"  compare: {n_err} pixels differ, max rel error {max_err:.3e}")
        if n_err:
            if args.output:
                save_image(args.output + ".debug.pfm", np.abs(output - ref))
            return 2

    if args.bench:
        for _ in range(args.bench):
            f.execute()
        t0 = time.perf_counter()
        for _ in range(args.bench):
            f.execute()
        ms = 1000 * (time.perf_counter() - t0) / args.bench
        print(f"  bench: {ms:.2f} msec/image")
    return 0


if __name__ == "__main__":
    sys.exit(main())
