"""Benchmark suite: oidnBenchmark's denoise matrix and the renderer's configs.

Counterpart of ``mygpuraytracer_tpu/apps/benchmark.py``:

    python -m mygpuraytracer_tpu_torch.apps.benchmark [--mode render|denoise|all]
        [--runs N] [--scene-dir DIR] [--json] [--device cuda|cpu]

Denoise matrix (apps/oidnBenchmark.cpp:97-210): RT hdr/ldr + albedo + normal
at 1920x1080, 3840x2160, 1280x720; RTLightmap hdr at 2048^2, 4096^2,
1024^2: random images from seed 0, host arrays in and out, one warm-up
execute and ``--runs`` timed ones, ms per image.

Render matrix: the BASELINE.md configs (cornell 16 spp, cornellGlass,
sphere, cornell with DoF + first-bounce cache + material sort on the
wavefront, the OBJ mesh): two warm-up iterations, then batches of ``spp``
until ``MIN_SECONDS`` have passed or ``MAX_BATCHES`` ran, Msamples/s. On CUDA the configs
run through the megakernel (K1) where the scene allows it. A scene file
that ``--scene-dir`` lacks falls back to the builtin of the same name;
one with no builtin (cornellObj) is skipped. ``--scene-dir`` defaults to
the repo's ``scenes/``, which holds none of these files, so the builtins
run; point it at the reference's scene directory to run its files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

DEFAULT_SCENE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")

MIN_SECONDS = 1.5  # the render loop's least timed span
MAX_BATCHES = 16  # ... unless this many batches of spp ran first

DENOISE_MATRIX = [
    ("RT.hdr_alb_nrm", "RT", dict(hdr=True), (1920, 1080)),
    ("RT.ldr_alb_nrm", "RT", dict(hdr=False), (1920, 1080)),
    ("RT.hdr_alb_nrm", "RT", dict(hdr=True), (3840, 2160)),
    ("RT.ldr_alb_nrm", "RT", dict(hdr=False), (3840, 2160)),
    ("RT.hdr_alb_nrm", "RT", dict(hdr=True), (1280, 720)),
    ("RT.ldr_alb_nrm", "RT", dict(hdr=False), (1280, 720)),
    ("RTLightmap.hdr", "RTLightmap", dict(), (2048, 2048)),
    ("RTLightmap.hdr", "RTLightmap", dict(), (4096, 4096)),
    ("RTLightmap.hdr", "RTLightmap", dict(), (1024, 1024)),
]


def _synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_denoise(runs: int = 4, sizes=None, json_out=False, device="cuda"):
    """Time the denoise matrix through ``Device(device)``'s filters on host
    arrays (execute copies the result back, so it waits for the device)."""
    from ..denoise import Device

    dev = Device(str(device))
    dev.commit()
    rng = np.random.default_rng(0)
    results = []
    for name, kind, params, (w, h) in DENOISE_MATRIX:
        if sizes and (w, h) not in sizes:
            continue
        f = dev.new_filter(kind)
        f.set_image("color", rng.random((h, w, 3), np.float32))
        if kind == "RT":
            f.set_image("albedo", rng.random((h, w, 3), np.float32))
            f.set_image("normal", rng.random((h, w, 3), np.float32) * 2 - 1)
            for k, v in params.items():
                f.set(k, v)
        f.set_image("output", np.zeros((h, w, 3), np.float32))
        f.set("inputScale", 1.0)
        f.commit()
        f.execute()  # warm-up
        t0 = time.perf_counter()
        for _ in range(runs):
            f.execute()
        ms = 1000 * (time.perf_counter() - t0) / runs
        results.append({"bench": f"{name}.{w}x{h}", "msec_per_image": round(ms, 2)})
        if not json_out:
            print(f"{name:>22s} {w:>4d}x{h:<4d}: {ms:8.2f} msec/image", flush=True)
    return results


RENDER_CONFIGS = [
    # (name, scene, spp, options overrides)
    ("cornell_16spp", "cornell.txt", 16, {}),
    ("cornellGlass_16spp", "cornellGlass.txt", 16, {}),
    ("sphere_16spp", "sphere.txt", 16, {}),
    # The wavefront (megakernel=False): the material sort exists only there.
    ("cornell_dof_cache_sort", "cornell.txt", 16,
     dict(depth_of_field=True, cache_first_bounce=True, sort_by_material=True,
          antialiasing=False, megakernel=False)),
    ("cornellObj_16spp", "cornellObj.txt", 16, {}),
]


def bench_render(scene_dir: str, spp_scale: int = 1, json_out=False, device="cuda"):
    """Msamples/s of each render config on ``device`` (the megakernel where
    the scene allows it on CUDA)."""
    import torch

    from ..config import RenderOptions
    from ..render import Renderer
    from ..scene import load_scene
    from ..scene.builtin import BUILTIN_SCENES

    on_cuda = torch.device(device).type == "cuda"
    results = []
    for name, scene_file, spp, opts in RENDER_CONFIGS:
        path = os.path.join(scene_dir, scene_file)
        if os.path.exists(path):
            scene = load_scene(path)
        else:
            base = scene_file.replace(".txt", "")
            if base not in BUILTIN_SCENES:
                continue
            scene = BUILTIN_SCENES[base]()
        spp *= spp_scale
        r = Renderer(scene, RenderOptions(**{"megakernel": on_cuda, **opts}), seed=0,
                     device=device)
        r.step_many(2)
        _synchronize(device)  # warm-up (kernel loads)
        r.reset()
        # Batches until MIN_SECONDS, so that the per-batch sync does not
        # dominate fast configs.
        total_iters, total_time = 0, 0.0
        while total_time < MIN_SECONDS and total_iters < MAX_BATCHES * spp:
            t0 = time.perf_counter()
            r.step_many(spp)
            _synchronize(device)
            total_time += time.perf_counter() - t0
            total_iters += spp
        w, h = r.meta.resolution
        ms = w * h * total_iters / total_time / 1e6
        results.append({
            "bench": name,
            "msamples_per_sec": round(ms, 2),
            "iters_per_sec": round(total_iters / total_time, 2),
        })
        if not json_out:
            print(f"{name:>24s}: {ms:8.2f} Msamples/s ({total_iters / total_time:6.1f} iters/s)",
                  flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="benchmark suite (PyTorch + CUDA)")
    p.add_argument("--mode", choices=["render", "denoise", "all"], default="all")
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--scene-dir", default=DEFAULT_SCENE_DIR)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    results = []
    if args.mode in ("render", "all"):
        results += bench_render(args.scene_dir, json_out=args.json, device=args.device)
    if args.mode in ("denoise", "all"):
        results += bench_denoise(args.runs, json_out=args.json, device=args.device)
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
