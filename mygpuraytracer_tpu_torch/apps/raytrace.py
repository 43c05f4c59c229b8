"""Headless render CLI (the oidnRayTracer app, apps/src/main.cpp).

Usage:
    python -m mygpuraytracer_tpu_torch.apps.raytrace SCENE [options]

SCENE is a scene .txt file or a builtin name (cornell, cornellGlass,
sphere). Renders on CUDA unless ``--device cpu`` is given, and writes the
four outputs of saveImage (main.cpp:115-165):
    <name>.<timestamp>.<N>samp.png    accumulated beauty / N
    <name>.<timestamp>.<N>albedo.png  first-hit albedo AOV
    <name>.<timestamp>.<N>input.png   denoiser input (normalized beauty)
    <name>.<timestamp>.<N>output.png  denoised beauty
with the reference's horizontal mirror (img.setPixel(width-1-x, ...)), and
with ``--save-normal`` the first-hit normal AOV as <...>normal.png;
``--preview-every N`` rewrites <name>.preview.png every N iterations (the
headless stand-in for the reference's GL window).
Primitive scenes and meshes of at most 256 faces render through the K1
kernel on CUDA; larger meshes, textured and bump-mapped ones included
(e.g. scenes/cornellShipTex.txt), through the wavefront and the mesh tiers'
kernel (``--mesh-tier``, ``--mesh-sort``, ``--winner-table``), as do
``--sort-by-material`` runs under ``--megakernel auto``: the material sort
exists only on the wavefront. The beauty is denoised through the Filter API on the same device (``denoise_beauty``).
``--multichip sample|pixels`` renders over a mesh of every visible CUDA
device (parallel/sharded.py): MC iterations split over the devices with one
psum, or the pixels sharded; with one device visible it logs so and renders
sequentially, as the JAX app does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..parallel.mesh import make_mesh
from ..utils.platform import add_device_flag, resolve_device
from ..utils.profiling import PhaseTimer, named_scope


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="path tracer (PyTorch + CUDA)")
    p.add_argument("scene", help="scene .txt file or builtin name (cornell, sphere, ...)")
    p.add_argument("--iterations", type=int, default=None, help="override scene ITERATIONS")
    p.add_argument("--depth", type=int, default=None, help="override trace depth")
    p.add_argument("--resolution", type=int, nargs=2, default=None, metavar=("W", "H"))
    p.add_argument("--out-dir", default=".", help="output directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=16, help="iterations per kernel launch")
    p.add_argument("--no-denoise", action="store_true", help="disable the AI denoiser")
    p.add_argument("--no-antialias", action="store_true")
    p.add_argument("--depth-of-field", action="store_true")
    p.add_argument("--preview-every", type=int, default=0,
                   help="dump a preview PNG every N iterations (headless 'window')")
    p.add_argument("--save-normal", action="store_true",
                   help="also save the first-hit normal AOV ([-1,1] -> [0,1])")
    p.add_argument("--megakernel", choices=("auto", "on", "off"), default="auto",
                   help="whole-iteration K1 CUDA kernel for supported scenes "
                        "(auto: on for CUDA)")
    p.add_argument("--mesh-tier", choices=("lists", "rows", "rows_dma", "conds"),
                   default="rows",
                   help="mesh tier for meshes of more than 256 faces: the names of the "
                        "JAX package's tiers, all served by one CUDA kernel here")
    p.add_argument("--mesh-sort", choices=("auto", "off", "need", "coherence"),
                   default="auto",
                   help="reorder of the mesh query's rays (auto: 'need' on CUDA for a "
                        "mesh embedded in a room)")
    p.add_argument("--winner-table", choices=("auto", "f32", "f16", "oct"), default="auto",
                   help="the rows tier's winner uv/TBN table (auto: oct on CUDA, f32 on "
                        "the CPU)")
    p.add_argument("--sort-by-material", action="store_true",
                   help="material-sorted wavefront execution (the reference's "
                        "SORT_BY_MATERIAL compile flag, pathtrace.cu:36); the image is "
                        "bitwise the unsorted one")
    p.add_argument("--sort-impl", choices=("fused", "perm", "argsort"), default="fused",
                   help="the sorted bounce's form (render/pathtrace.py _sort_wavefront): "
                        "'fused' = one sort and one gather of the per-lane arrays; "
                        "'perm' (counting sort) and 'argsort' gather every field")
    p.add_argument("--multichip", choices=("off", "sample", "pixels"), default="off",
                   help="render over every visible CUDA device: 'sample' splits the MC "
                        "iterations across the mesh (one psum merge), 'pixels' shards the "
                        "accumulators and the wavefront (device memory N/devices); both match "
                        "the single-device image")
    add_device_flag(p)
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def load_any_scene(name: str):
    from ..scene import load_scene
    from ..scene.builtin import BUILTIN_SCENES

    if os.path.exists(name):
        return load_scene(name)
    if name in BUILTIN_SCENES:
        return BUILTIN_SCENES[name]()
    raise FileNotFoundError(f"scene '{name}' not found (file or builtin)")


def mirror_x(img: np.ndarray) -> np.ndarray:
    """saveImage writes pixel (width-1-x, y) (main.cpp:126)."""
    return np.ascontiguousarray(img[:, ::-1])


def denoise_beauty(beauty: np.ndarray, albedo: np.ndarray, device="cuda"):
    """CPUdenoise equivalent (main.cpp:167-218): RT filter, LDR,
    color + albedo, on ``device``; returns (output, timings dict). The
    span ``mygpurt.filter`` covers it all, its phases ``.device``,
    ``.init`` and ``.execute`` the three parts the timings report."""
    from ..denoise import Device

    timer = PhaseTimer()
    with named_scope("mygpurt.filter"):
        with timer.phase("mygpurt.filter.device"):
            dev = Device(str(device))
            dev.commit()
        with timer.phase("mygpurt.filter.init"):
            f = dev.new_filter("RT")
            f.set_image("color", beauty.astype(np.float32))
            f.set_image("albedo", albedo.astype(np.float32))
            output = np.zeros_like(beauty, np.float32)
            f.set_image("output", output)
            f.commit()
        with timer.phase("mygpurt.filter.execute"):
            f.execute()  # copies the result to the host: waits for the device
    ms = timer.phases
    return output, dict(device_init_ms=ms["mygpurt.filter.device"],
                        filter_init_ms=ms["mygpurt.filter.init"],
                        denoise_ms=ms["mygpurt.filter.execute"],
                        random_weights=f.using_random_weights)


def _render_multichip(r, options, iterations, mode, log) -> int:
    """Render on a mesh over every visible device into ``r``'s accumulator;
    returns the iterations done (a remainder that does not divide the mesh
    falls through to the sequential loop)."""
    import torch

    from ..parallel.mesh import replicate
    from ..parallel.sharded import render_multichip_sample, sharded_render_step

    mesh = make_mesh() if r.device.type == "cuda" else make_mesh(devices=(r.device,))
    n_dev = mesh.size
    if n_dev < 2:
        log("multichip: single device visible; using the sequential path")
        return 0
    if mode == "sample":
        spp = (iterations // n_dev) * n_dev
        if spp == 0:
            return 0
        img, alb, nrm = render_multichip_sample(r.dev, r.meta, options, r.base_key, spp, mesh)
        r.acc = torch.stack([*img, *alb, *nrm]).to(r.device)
        r.iteration = spp
        log(f"multichip sample-parallel: {spp} iterations over {n_dev} devices")
        return spp
    # pixels: shard the accumulators and the wavefront; run every iteration here
    w, h = r.meta.resolution
    if (w * h) % n_dev:
        log(f"multichip pixels: {w}x{h} does not divide {n_dev} devices; "
            "using the sequential path")
        return 0
    step_fn, make_state = sharded_render_step(r.meta, options, mesh)
    image, albedo, cache = make_state()
    devs = replicate(r.dev, mesh)
    for it in range(1, iterations + 1):
        image, albedo, cache = step_fn(devs, image, albedo, cache, it, r.base_key)
    r.acc = torch.cat([acc.to(r.device) for acc in image.base], dim=1)
    r.iteration = iterations
    log(f"multichip pixel-sharded: {iterations} iterations, "
        f"{w * h // n_dev} lanes/device over {n_dev} devices")
    return iterations


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import RenderOptions
    from ..render import Renderer
    from ..utils.png import write_png

    device = resolve_device(args.device)
    scene = load_any_scene(args.scene)
    if args.resolution:
        scene.set_resolution(*args.resolution)
    if args.depth:
        scene.state.trace_depth = args.depth
    iterations = args.iterations if args.iterations is not None else scene.state.iterations
    mega = device.type == "cuda" if args.megakernel == "auto" else args.megakernel == "on"
    if args.sort_by_material and args.megakernel == "auto":
        # The sort exists only on the wavefront: route there, so that the
        # flag measures what it names.
        mega = False
    elif args.sort_by_material and mega:
        print("warning: --sort-by-material has no effect with "
              "--megakernel on (sorting exists only on the wavefront); "
              "timings will measure the unsorted megakernel", file=sys.stderr)
    options = RenderOptions(
        antialiasing=not args.no_antialias, depth_of_field=args.depth_of_field,
        ai_denoise=not args.no_denoise, mesh_tier=args.mesh_tier,
        mesh_sort={"auto": None, "off": False}.get(args.mesh_sort, args.mesh_sort),
        winner_table=args.winner_table, sort_by_material=args.sort_by_material,
        sort_impl=args.sort_impl, megakernel=mega)
    log = (lambda *a: None) if args.quiet else print

    log(f"Loaded scene: {scene.state.image_name} "
        f"{scene.state.camera.resolution[0]}x{scene.state.camera.resolution[1]}, "
        f"{len(scene.geoms)} geoms, {len(scene.materials)} materials")
    r = Renderer(scene, options, seed=args.seed, device=device)
    start_str = time.strftime("%Y-%m-%d_%H-%M-%S")
    os.makedirs(args.out_dir, exist_ok=True)

    t0 = time.perf_counter()
    done = 0
    if args.multichip != "off":
        # r.options, not the local options: the Renderer resolved the auto
        # knobs (winner_table, mesh_sort) from its device.
        done = _render_multichip(r, r.options, iterations, args.multichip, log)
    while done < iterations:
        n = min(args.batch, iterations - done)
        r.step_many(n)
        done += n
        if args.preview_every and done % args.preview_every < n:
            write_png(os.path.join(args.out_dir, f"{scene.state.image_name}.preview.png"),
                      mirror_x(r.beauty()))
        if not args.quiet:
            print(f"\rIteration {done}/{iterations}", end="", flush=True)
    beauty = r.beauty()  # copies to the host: waits for the device
    render_s = time.perf_counter() - t0
    log(f"\ntime: {render_s:.3f}s ({done / render_s:.1f} iters/s, "
        f"{np.prod(beauty.shape[:2]) * done / render_s / 1e6:.1f} Msamples/s)"
        f" on {device}{' (K1)' if r.use_megakernel else ''}")

    albedo = r.albedo_image()
    prefix = os.path.join(args.out_dir, f"{scene.state.image_name}.{start_str}.{done}")
    write_png(f"{prefix}samp.png", mirror_x(beauty))
    write_png(f"{prefix}albedo.png", mirror_x(albedo))
    write_png(f"{prefix}input.png", mirror_x(beauty))
    if args.save_normal:
        write_png(f"{prefix}normal.png", mirror_x(r.normal_image() * 0.5 + 0.5))
    if options.ai_denoise:
        output, tm = denoise_beauty(beauty, albedo, device)
        log(f"Denoise: device={tm['device_init_ms']:.1f}ms "
            f"filter={tm['filter_init_ms']:.1f}ms exec={tm['denoise_ms']:.1f}ms"
            + (" [RANDOM WEIGHTS — provide real .tza for quality]" if tm["random_weights"] else ""))
        write_png(f"{prefix}output.png", mirror_x(output))
    log(f"Saved outputs: {prefix}*.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
