"""End-to-end check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (mygpuraytracer_tpu_torch) on the card
at 800x800, depth 8: the builtin Cornell box through the K1 CUDA kernel;
the 23,328-face spaceship in the Cornell box, textured and bump-mapped
(scenes/cornellShipTex.txt) and plain (scenes/cornellShip.txt), through the
wavefront and the one mesh query's CUDA kernel (the JAX package's K2/K3/K4);
and cornellShip
through the bounce megakernel K5 with the K6 uniforms for its raygen; all
denoised with the U-Net, the Cornell render also through the OIDN-style
Filter API and the two apps that call it; the denoiser's trainer, on
pairs rendered through K1; rendering, the Filter and the trainer over a
mesh of devices; the preview app's session; and the port's bench. Phases,
each printing one line with its elapsed seconds:

1. device      -- the card's name and power limit (nvidia-smi); fails without CUDA
2. build       -- one nvcc per csrc/*.cu, in parallel, into the gitignored build
                  dir; ptxas's registers and spills; the integer instructions
                  of one threefry draw and one Philox call, counted in the
                  SASS (cuobjdump) of probes built with the same flags and
                  headers, and of K6's kernel in the built library
3. k1_parity   -- K1 against its plain PyTorch version on cornell and
                  cornellGlass (800x800, depth 8, 16 iterations, same seed)
4. render      -- K1's main path: Renderer.render_denoised, launch counts
                  read around it; then K1 timed with CUDA events against its
                  bound and the issue-slot view; the counting build's lane
                  use, raygen share, pixel fetches and atomics and tail
                  rounds beside the lane use the plain nesting (one thread a
                  pixel, the bounce loop inside the iteration loop) would
                  have on the same paths, and its live lane-rounds against
                  the plain wavefront's ray-bounces; the sweep of block
                  sizes and resident blocks per SM; the same with depth of
                  field; ptxas's registers and spills of K1 and the loads
                  of the scene record per geom test and per bounce, counted
                  in the SASS of probes read as K5 reads it and as K1 does
5. mesh_parity -- the mesh kernel against its plain version on the bounce-0
                  and bounce-1 queries of cornellShip and cornellShipTex:
                  bitwise on every output (lanes that differ must be proven
                  box-rounding lanes, ops/mesh_hit.py::box_rounding_lanes,
                  and are counted), the winner's extras under the f32 and
                  oct winner tables, the counting build's outputs equal, and
                  per ray necessary visits <= the kernel's <= the clusters
                  entered below t_cap
6. mesh_render -- the mesh main path: render_denoised of cornellShipTex and
                  cornellShip with the kernel's launches counted on the
                  card (depth launches per iteration: each launch adds to
                  a count kept on the device, which a graph's replays move
                  too), kernel against plain-query images (the plain
                  query eager),
                  the oct winner table's image against f32's (recorded);
                  then the kernel timed with CUDA events at each block size
                  of the sweep, with the necessary, plain and kernel visits
                  per live ray and the counting build's tree nodes,
                  traversal lane use and leaf rounds (mesh_time); the
                  wavefront's primitive kernel (csrc/prims_hit.cu) on each
                  of an iteration's 8 bounces, every field bitwise against
                  intersect_primitives_soa, its launches counted on the card
                  (eager and replayed), device ms against its byte bound and
                  the plain version's ms (prims_time); the wavefront's
                  threefry block (csrc/prng.cu) at [28, 640000], bitwise
                  against rng.uniform, its launches counted on the card
                  (eager and replayed), device ms against its INT32 and
                  byte bounds and the plain version's ms (threefry_time);
                  and two
                  iterations under torch.profiler (mesh_profile): device busy
                  share and the kernels that take the device time
7. options     -- the wavefront's render options and the Renderer surface:
                  BASELINE config #3 (cornell_dof_cache_sort: DoF, AA off,
                  the wavefront) with each sort form and with the sort off,
                  bitwise equal, ms per iteration, and one iteration of each
                  under torch.profiler (kernels, device time, the sort's
                  share); cornellShipTex sorted and unsorted under the app's
                  options, bitwise, with K2's launches per iteration equal;
                  the first-bounce cache on and off (AA off) on both scenes,
                  bitwise, with the bounce-0 queries and K2 launches
                  counted (eager: it counts Python calls); the dir AOV's
                  bounds (K1 not launched under megakernel=True) and the
                  directional RTLightmap filter on it; move_camera against
                  a fresh Renderer (K1); the benchmark app
                  (apps/benchmark.py --mode all --json) in a subprocess, 13
                  entries
8. graph      -- the Renderer's CUDA graphs (render/graphs.py) against its
                  eager route (graphs.disabled()), bitwise on the
                  accumulators: cornellShipTex under the app's options, with
                  the first-bounce cache, BASELINE config #3 in each sort form
                  and unsorted (4 iterations each after iteration 1), and
                  cornellShip through K5 (16); per case ms per iteration both
                  ways, capture seconds, graph-pool MiB and, under
                  torch.profiler, kernels, host kernel and graph launches per
                  iteration and the device-busy share; the syncs of one eager
                  iteration (none allowed); step_many(16) after iteration 1
                  with torch.cuda.set_sync_debug_mode("error"); move_camera
                  then 2 iterations against a fresh Renderer, bitwise
9. prng        -- K6 against its plain version bit for bit at [4, N] and
                  [28, N] for three seeds; its values on the 2^-24 grid with
                  U[0,1)'s mean and variance; K6 timed beside torch.rand in
                  turns under three yardsticks: one call at a time (the
                  kernels line's ms and library_ms: the wrapper's host cost
                  included), bursts of back-to-back calls, and the device
                  time of calls queued behind other work (the kernel alone);
                  at [4, N] the host cost per call of the wrapper's pieces
10. k5_parity   -- K5 against its plain version (the wavefront over the plain
                  walk) on the main path's inputs: cornellShip and the
                  open-sky shipOnly at 800x800, depth 8, seed 0, its first 2
                  iterations, under rng "threefry" and "auto"
11. bounce_render -- the K5 main path: Renderer(megakernel, bounce_megakernel,
                  rng="auto").render_denoised of cornellShip with the K5 and
                  K6 launches counted on the card, one each per iteration;
                  one counting launch per iteration
                  (cluster visits, tree nodes, warp traversal iterations,
                  warp bounce rounds, lanes of ended paths: nodes per
                  ray-bounce, the traversal's lane use, the ended paths'
                  share of the bounce rounds' lanes); K5 timed per launch
                  with its bound (the necessary visits' face tests, its own
                  visits' beside it); two iterations under torch.profiler; its
                  image against the wavefront's (mesh kernel, same rng)
                  over 4 iterations
12. denoise    -- the fused denoise (bf16 net) against the float32 net on the
                  card, and the float32 net on the card against the CPU
13. filter     -- the OIDN-style Filter API (denoise/filter.py) on the card:
                  Filter("RT") on the Cornell render's host beauty and albedo,
                  as the raytrace app calls it, against the fused denoise;
                  the single pass against the monitored per-tile path at
                  3840x2160 in float32 (1x2 and 3x4 tiles, in place too);
                  DeviceBuffers against host arrays at 1080p; the denoise
                  matrix of apps/benchmark.py and bench.py's standalone
                  1080p cells timed (filter_matrix: ms per image, tiles,
                  planned scratch and measured peak memory), the 1080p
                  execute under torch.profiler (filter_profile); the oidnDenoise
                  CLI (`python -m mygpuraytracer_tpu_torch.apps.denoise`) on
                  the render's PFMs, plain, in place with --maxmem 0, and
                  with -r against that output
14. app        -- `python -m mygpuraytracer_tpu_torch.apps.raytrace` in a
                  subprocess on cornell and on cornellShipTex, each writing
                  its four PNGs into a temporary directory and denoising
                  through Filter("RT") (its "Denoise: device=... filter=...
                  exec=..." line), and on cornellShipTex with --no-antialias
                  --sort-by-material --save-normal (five PNGs)
15. train      -- the denoiser's training toolkit (train/, the train_denoiser
                  app): a Cornell pair rendered by render_training_pairs at
                  256x256, 8 and 256 spp, through K1 (its launches counted);
                  one float32 step (TF32 off) on the card against the CPU and
                  one bf16 "mixed" step; train_device at the JAX trainer's
                  defaults (rt_ldr_alb's 6 channels, batch 16, 256^2 tiles,
                  bf16, l1_msssim, max_lr 2e-4) for 3 epochs of 32 steps on
                  data/denoise/ and the pair: per epoch the loss (finite,
                  falling), ms per step, images/s, GFLOP per step and share of
                  the bf16 bound, the host's syncs (one per epoch, counted by
                  torch.cuda's sync debug mode), and the peak memory; the
                  host-fed train() (1 epoch of 8 steps) with its device-busy
                  share under torch.profiler; the export loaded into
                  Filter("RT") through set_data("weights") on the noisy pair,
                  scored by the compare_image app against the clean image; and
                  `python -m mygpuraytracer_tpu_torch.apps.train_denoiser` for
                  2 epochs in a subprocess
16. multichip  -- parallel/ over the mesh ("cuda:0", "cuda:0"), the card named
                  twice (the split, the per-device launches and the merge;
                  not scaling): Cornell 800x800, 32 iterations, in sample
                  mode (one K1 launch per device, one psum) against the
                  sequential Renderer (rtol and atol 1e-4) and in pixel mode
                  through K1 against a sequential render of one iteration per
                  launch (bit for bit); pixel mode on cornellShip under
                  bounce_megakernel (K5, 2 iterations) and on cornellShipTex
                  through the wavefront (1 iteration), each bit for bit
                  against its single-device render; the Filter's mesh at 1080p
                  and 4K RT (hdr + alb + nrm) with the default maxMemoryMB and
                  with 256, bit for bit against the single-device execute;
                  the trainer's mesh: float32 steps against the single
                  device's (loss rtol 1e-4; gradients within 1e-5 of the
                  largest for l1, 1e-4 for l1_msssim and on the mesh of the
                  card and the CPU, whose replicas are copies) and train()
                  at TrainConfig's defaults, ms per step beside the single
                  device's; the
                  raytrace app with --multichip sample and pixels, which on
                  one card logs the sequential path
17. preview    -- apps/preview.py's session on Cornell 800x800 through K1:
                  frames over localhost, a camera move that restarts the
                  accumulation (resets, K1 launches counted), a save with the
                  denoise (3 PNGs)
18. bench      -- `python -m mygpuraytracer_tpu_torch.bench` in a subprocess:
                  its last JSON line has every key of bench.py, its
                  Msamples/s and ms values non-null

It prints a JSON line of per-kernel numbers and, last, one JSON object
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
It imports nothing of JAX.

    python3 chip_smoke.py --ab ROOT [ROOT ...] [--pairs N]

times whole-image K1 and K5 launches of the package in each ROOT (a
checkout of this repo; another commit's from ``git archive``, in a
gitignored directory) as the kernels line does, each tree in processes of
its own taken in turns for N rounds, and prints each run, then per tree
the medians, the ratios to the first tree and the SASS instruction counts.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

# ---- K1 and K5 of several trees timed in turns (--ab) --------------------------------
# These run before the port's imports below: ``--time-kernels ROOT`` times
# the package of another checkout, which may lack this tree's modules.


def cuda_ms(fn, repeats: int = 1) -> float:
    """Mean device time of fn() over ``repeats`` calls, by CUDA events."""
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def time_k1(run, acc: torch.Tensor, repeats: int = 5) -> float:
    """K1's median device ms per launch over ``repeats`` launches of
    ``run()`` into zeroed accumulators, after one warm-up."""
    times = []
    for _ in range(repeats + 1):
        acc.zero_()
        times.append(cuda_ms(run))
    return float(np.median(times[1:]))


def host_ms(fn, repeats: int) -> float:
    """Median host time of one call of fn() (it enqueues its work and
    returns), the card idle at the start."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    return float(np.median(times))


def time_kernels(root: str, repeats: int = 9, calls: int = 10) -> int:
    """K1 and K5 of the package in ``root`` as the kernels line times them,
    as whole-image launches: K1 per 16-iteration launch on the Cornell box
    and K5 per launch on cornellShip's iteration-1 rays (800x800, depth 8,
    seed 0). One JSON line: K1 single launches into a zeroed accumulator
    (time_k1), K1 and K5 back to back (``calls`` launches per event pair),
    each the median of ``repeats``, and each wrapper's host ms per call.
    It calls only what every tree since K1's and K5's redesigns has."""
    sys.path.insert(0, os.path.abspath(root))
    import mygpuraytracer_tpu_torch as pkg
    from mygpuraytracer_tpu_torch.config import RenderOptions
    from mygpuraytracer_tpu_torch.ops import prng, rng
    from mygpuraytracer_tpu_torch.render import Renderer, megakernel
    from mygpuraytracer_tpu_torch.render.camera import generate_camera_rays
    from mygpuraytracer_tpu_torch.scene import load_scene
    from mygpuraytracer_tpu_torch.scene.builtin import cornell_box

    device, n, key = torch.device("cuda"), 800 * 800, rng.make_key(0)
    r = Renderer(cornell_box(resolution=(800, 800), depth=8), RenderOptions(megakernel=True),
                 device=device)
    acc = torch.zeros((9, n), device=device)
    record = megakernel.scene_record(r.meta, r.dev.camera)
    k1 = lambda: megakernel.megakernel_accumulate(r.dev, r.meta, r.options, acc, 1, 16, key,
                                                  record=record)
    scene = load_scene(os.path.join(root, "scenes", "cornellShip.txt"))
    scene.set_resolution(800, 800)
    scene.state.trace_depth = 8
    s = Renderer(scene, RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto"),
                 device=device)
    acc5 = torch.zeros((9, n), device=device)
    record5 = megakernel.scene_record(s.meta, s.dev.camera)
    ikey = rng.iteration_key(key, 1)
    U = prng.iteration_uniforms(s.options, ikey, 1, 4, n, device)
    o, d = generate_camera_rays(s.dev.camera, s.meta.resolution, s.options, U)
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z]).contiguous()
    k5 = lambda: megakernel.bounce_launch(s.dev, s.meta, s.options, acc5, rays, 1, ikey, record5)
    burst = lambda fn: float(np.median([cuda_ms(lambda: [fn() for _ in range(calls)])
                                        for _ in range(repeats)])) / calls
    k1(), k5()  # warm-up
    out = {"package": os.path.dirname(pkg.__file__), "k1_single_ms": time_k1(k1, acc, repeats),
           "k1_burst_ms": burst(k1), "k5_burst_ms": burst(k5),
           "k1_host_ms": host_ms(k1, repeats), "k5_host_ms": host_ms(k5, repeats)}
    print(json.dumps(out), flush=True)
    return 0


def kernel_instructions(root: str) -> dict:
    """SASS instructions of the plain whole-image, by-value builds of K1, K5
    and K6 in ``root``'s built libraries (sass_opcodes)."""
    built = os.path.join(root, "mygpuraytracer_tpu_torch", "_build")
    out = {}
    for lib, kernel in (("libmegakernel_", "k1_kernel"), ("libbounce_", "k5_kernel"),
                        ("libprng_", "k6_kernel")):
        path = max((os.path.join(built, f) for f in os.listdir(built) if f.startswith(lib)),
                   key=os.path.getmtime)
        counts = sass_opcodes(path)
        # the plain build: <false> before ranges, <false, false> since, <false,
        # false, false> with K5's words; K6 untemplated before its words
        out[kernel] = sum(counts[plain_build(counts, kernel)].values())
    return out


def plain_build(counts: dict, kernel: str) -> str:
    """The symbol of ``kernel``'s plain build (every template flag false)."""
    names = [k for k in counts if re.search(rf"\d{kernel}(E|I)", k)]
    falses = lambda k: k.count("Lb0E") if "Lb1E" not in k else -1
    return max(names, key=falses)


def ab_main(argv) -> int:
    """``--ab ROOT [ROOT ...] [--pairs N]``: time_kernels of each tree in a
    process of its own, ``N`` rounds in turns (the order reversed every
    other round: a b, b a, ...), then per tree the median of its rounds, the
    median ratio of each tree to the first within a round, the rounds in
    which it was slower, and its kernels' SASS instruction counts."""
    parser = argparse.ArgumentParser(prog="chip_smoke.py --ab")
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--pairs", type=int, default=10)
    args = parser.parse_args(argv)
    roots, pairs = args.roots, args.pairs
    if not torch.cuda.is_available():
        print("chip_smoke --ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    runs = {root: [] for root in roots}
    for rnd in range(pairs):
        for root in (roots if rnd % 2 == 0 else roots[::-1]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels",
                                   root], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"timing {root} failed:\n{proc.stdout}\n{proc.stderr}")
            runs[root].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps({"round": rnd, "root": root, **runs[root][-1]}), flush=True)
    keys = ("k1_single_ms", "k1_burst_ms", "k5_burst_ms", "k1_host_ms", "k5_host_ms")
    base = runs[roots[0]]
    for root in roots:
        ratios = {k: [a[k] / b[k] for a, b in zip(runs[root], base)] for k in keys}
        print(json.dumps({"root": root, "rounds": pairs,
                          "sass_instructions": kernel_instructions(root),
                          **{k: float(np.median([run[k] for run in runs[root]])) for k in keys},
                          **{f"{k}_range": [min(run[k] for run in runs[root]),
                                            max(run[k] for run in runs[root])] for k in keys},
                          **{f"{k}_ratio_to_first": float(np.median(v)) for k, v in ratios.items()},
                          **{f"{k}_rounds_slower": sum(x > 1.0 for x in v)
                             for k, v in ratios.items()}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--time-kernels"]:
    sys.exit(time_kernels(sys.argv[2]))

import mygpuraytracer_tpu_torch as port
from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.denoise import Device, DeviceBuffer
from mygpuraytracer_tpu_torch.denoise.unet import conv_specs, no_tf32
from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import prims_hit as ph
from mygpuraytracer_tpu_torch.ops import prng, rng, trace
from mygpuraytracer_tpu_torch.ops.trace import intersect_soa
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import Renderer, graphs, megakernel, pathtrace
from mygpuraytracer_tpu_torch.render.camera import generate_camera_rays
from mygpuraytracer_tpu_torch.render.denoise_fused import denoise_accumulator, load_denoiser
from mygpuraytracer_tpu_torch.render.pathtrace import num_rng_streams, render_sample
from mygpuraytracer_tpu_torch.render.shade import PathStateSoA, shade_soa
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box, cornell_glass
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene
from mygpuraytracer_tpu_torch.scene.structs import GeomType
from mygpuraytracer_tpu_torch.apps import compare_image
from mygpuraytracer_tpu_torch.apps.preview import PreviewSession, make_server
from mygpuraytracer_tpu_torch.parallel import (make_mesh, render_multichip_sample,
                                               sharded_render_step)
from mygpuraytracer_tpu_torch.parallel.mesh import replicate
from mygpuraytracer_tpu_torch.denoise.unet import params_from_jax
from mygpuraytracer_tpu_torch.train.dataset import render_training_pairs
from mygpuraytracer_tpu_torch.train.export import export_weights
from mygpuraytracer_tpu_torch.train.train import (Optimizer, TrainConfig, build_train_step,
                                                  init_params, onecycle_schedule, train,
                                                  train_device)
from mygpuraytracer_tpu_torch.utils.image_io import save_image

RES = 800
DEPTH = 8
PARITY_ITERS = 16
SEED = 0
# K1 against its plain version: mean images over PARITY_ITERS iterations.
# The kernel contracts multiply-adds into FMAs and its rsqrt rounds
# differently from PyTorch's elementwise kernels, so a few paths branch the
# other way at an edge or a Fresnel choice; such a pixel differs by a whole
# path's contribution / PARITY_ITERS, up to ~1 for a path through the glass
# that reaches the light. Three of them already make ~1e-3 of image rmse (on
# an NVIDIA H100 80GB HBM3 at 700 W, cornellGlass gave 1.042e-3 from 3 of
# 640000 pixels), so the rmse bar applies to the pixels whose paths agree
# (|diff| <= 1e-2), and the diverged ones are bounded by their share.
PARITY_RMSE = 1e-3  # over pixels within 1e-2
PARITY_PIXEL_SHARE = 0.01  # of pixels differing by more than 1e-2
# First-hit albedo/normal AOVs: the same share bar. A primary ray that grazes
# the edge between two geoms can pick the other geom under the kernel's
# rounding, and its pixel's AOVs then differ by O(1) (on an H100: one such
# pixel, 0.63); elsewhere they differ by a few ulps.
# Fused denoise, bf16 net vs the float32 net on the same accumulators: bf16
# keeps 8 significant bits, so each of the 16 convs rounds its inputs to
# ~4e-3 relative; LDR output is in [0, 1].
DENOISE_BF16_MEAN_ABS = 1e-2
DENOISE_BF16_MAX_ABS = 0.25
# Float32 net on the card (cuDNN, TF32 off) vs on the CPU, 64x64 input:
# summation order only (BASELINE.md fp32 bar, max relative error 1e-4).
UNET_F32_MAX_REL = 1e-4
# The Filter API's own paths on the card against each other (single pass
# against monitored, DeviceBuffer against host arrays, the oidnDenoise CLI
# against the in-process Filter): the same convolutions on the same windows,
# so the JAX package's bar for the same comparison, atol 1e-6.
FILTER_PATH_ATOL = 1e-6
# Single pass against monitored: (W, H) and (maxMemoryMB, tile counts the
# plan must give); DeviceBuffer against host arrays: (W, H).
FILTER_PARITY_SIZE = (3840, 2160)
FILTER_PARITY_PLANS = ((3000, (1, 2)), (512, (3, 4)))
FILTER_BUFFER_SIZE = (1920, 1080)
# The denoise matrix of the JAX package's apps/benchmark.py (name, filter,
# params, (W, H)), timed through the Filter with DeviceBuffers, and bench.py's
# standalone 1080p cells (DeviceBuffers; host arrays in and out).
DENOISE_MATRIX = [
    ("RT.hdr_alb_nrm", "RT", dict(hdr=True), (1280, 720)),
    ("RT.ldr_alb_nrm", "RT", dict(hdr=False), (1280, 720)),
    ("RT.hdr_alb_nrm", "RT", dict(hdr=True), (1920, 1080)),
    ("RT.ldr_alb_nrm", "RT", dict(hdr=False), (1920, 1080)),
    ("RT.hdr_alb_nrm", "RT", dict(hdr=True), (3840, 2160)),
    ("RT.ldr_alb_nrm", "RT", dict(hdr=False), (3840, 2160)),
    ("RTLightmap.hdr", "RTLightmap", dict(), (1024, 1024)),
    ("RTLightmap.hdr", "RTLightmap", dict(), (2048, 2048)),
    ("RTLightmap.hdr", "RTLightmap", dict(), (4096, 4096)),
]
MATRIX_RUNS = 4  # timed executes per cell, after one warm-up (apps/benchmark.py's runs)
# H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), for the U-Net's
# bound; an FMA counts as two operations, as in the conv FLOP count below.
BF16_FLOPS_PER_S = 989e12
# Each conv's resolution divisor in the U-Net (denoise/unet.py forward).
UNET_CONV_SCALE = {"enc_conv0": 1, "enc_conv1": 1, "enc_conv2": 2, "enc_conv3": 4,
                   "enc_conv4": 8, "enc_conv5a": 16, "enc_conv5b": 16, "dec_conv4a": 8,
                   "dec_conv4b": 8, "dec_conv3a": 4, "dec_conv3b": 4, "dec_conv2a": 2,
                   "dec_conv2b": 2, "dec_conv1a": 1, "dec_conv1b": 1, "dec_conv0": 1}

# H100 SXM rates (NVIDIA data sheet, Hopper white paper): HBM 3.35 TB/s;
# 128 FP32 lanes and 64 INT32 lanes per SM, 132 SMs, 1.98 GHz boost. The
# counts below are instructions, one per lane: the data sheet's 67 TFLOP/s
# counts an FMA as two operations, and the mesh face and slab tests
# (csrc/mesh.cuh, __fmul_rn/__fadd_rn chains) never fuse, so FP32 runs at
# 128 x 132 x 1.98e9 = 33.5e12 instructions/s and INT32 at 64 x 132 x
# 1.98e9 = 16.7e12/s. (K1's and K5's primitive tests and shade may contract
# a multiply-add pair into one FMA, so for those counts, which are all of
# K1's and a small share of K5's, the bound may be up to 2x high.)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.7e12
# Operations per unit of K1 work, counted from csrc/megakernel.cu (one
# arithmetic, compare or select instruction = 1; sqrt, rsqrt and a division
# = 1; sinf/cosf/powf = 20 each, their polynomial length). The integer
# instructions of one draw are counted by phase build from the SASS of the
# built code (sass_draw_counts): threefry2x32 per draw, Philox4x32-10 per
# call (4 draws).
FP_OPS_PER_DRAW = 1
FP_OPS_RAYGEN = 28
FP_OPS_DOF = 75
FP_OPS_BOX = 140
FP_OPS_SPHERE = 120
FP_OPS_FACE = 40
FP_OPS_SHADE = 120  # diffuse bounce: cosine hemisphere (2 sqrt, sin, cos, 2 normalized crosses)
# The mesh kernel, counted from csrc/mesh.cuh: a face test is A and B (2
# dot products, 10), B's clamp (3), t (2), u and v (2 x (2 dots + 3) = 26)
# and the accept test (6 compares or adds + 4 ands) = 51. The bound counts
# the face tests of the necessary visits only: per ray, the clusters whose
# slab test passes with an entry t below the ray's final t (the plain
# result's t, or t_cap where no face won), which any correct walk tests,
# whatever its order. A walk's own visits, its tree nodes (two slab tests
# each) and its leaf rounds are the design's schedule, printed beside the
# bound, not in it.
FP_OPS_FACE_TEST = 51
MESH_BLOCK_SIZES = (64, 128, 256)  # the mesh kernel's block-size sweep
# K1's sweep: block sizes, and the warps per SM asked (blocks per SM =
# warps / warps per block, at most what the occupancy query allows).
K1_BLOCK_SIZES = (64, 128, 256)
K1_WARPS_PER_SM = (8, 16, 24, 32, 48, 64)
# K1's live lane-rounds (counting build) against the plain wavefront's
# ray-bounces: a path that branches the other way under the kernel's
# rounding (1-3 pixels of 640000 in k1_parity) may bounce a different
# number of times.
K1_LIVE_REL = 1e-4
NECESSARY_CHUNK = 65536  # rays per chunk of the necessary-visit count
# K6 against its plain version: bit for bit (integer arithmetic and one
# exact conversion). Its values: on the 2^-24 grid in [0, 1), mean and
# variance within 5 sigma of U[0,1)'s.
PRNG_SEEDS = (0, 1234567, -(2**31))
# K5 against its plain version: K1's bars (PARITY_RMSE, PARITY_PIXEL_SHARE)
# on the mean over the main path's first K5_PARITY_ITERS iterations, at its
# 800x800. Besides K1's rounding (FMA contraction, rsqrt) the walk visits
# clusters near to far where the plain version goes in ascending id, so a
# face whose t rounds below its own box's entry may be found by one walk
# and not the other (csrc/mesh.cuh; exact-t ties go to the lowest face id
# in both). The plain walk syncs the
# host once per cluster and bounce (~3 s per 800x800 iteration on an H100),
# so its cost grows with iterations, not pixels.
K5_PARITY_ITERS = 2
BOUNCE_ITERS = 16  # the K5 main path: one render_denoised of 16 iterations
BOUNCE_IMAGE_ITERS = 4  # K5 against the wavefront, image of 4 iterations
MESH_SCENES = ("cornellShipTex", "cornellShip")
MESH_ITERS = 16  # the main path: one render_denoised of 16 iterations
MESH_IMAGE_ITERS = 4  # kernel against plain query, image of 4 iterations
PROFILE_ITERS = 2  # iterations under torch.profiler
# Phase options: the wavefront's render options and the Renderer surface.
# BASELINE config #3 (apps/benchmark.py cornell_dof_cache_sort): DoF, the
# cache (which DoF switches off), the sort, AA off, the wavefront.
BASELINE3 = dict(depth_of_field=True, cache_first_bounce=True, sort_by_material=True,
                 antialiasing=False, megakernel=False)
SORT_IMPLS = ("fused", "perm", "argsort")
OPTIONS_ITERS = 16  # cornell_dof_cache_sort, dir_aov, move_camera
OPTIONS_MESH_ITERS = 2  # cornellShipTex with the sort on and off
CACHE_ITERS = 4  # the first-bounce cache on and off
# Phase graph: the Renderer's CUDA graphs against its eager route
# (graphs.disabled()), bitwise, at 800x800 depth 8: iterations 2 ..
# GRAPH_ITERS + 1 timed per case (K5: GRAPH_K5_ITERS), the
# profiled steps' iterations, and step_many under the sync debug mode.
GRAPH_ITERS = 4
GRAPH_K5_ITERS = 16
GRAPH_PROFILE_ITERS = 2
GRAPH_SYNC_ITERS = 16
GRAPH_MOVE = [0.0, 5.0, 9.0]  # move_camera's position (cornellShipTex)
# The host's launches in a profile: kernels one by one, graphs.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
# dir_image's bounds (tests/test_dir_aov.py): normalized mean directions,
# and a direction on more than this share of the Cornell box's pixels.
DIR_NORM_MAX = 1.0 + 1e-5
DIR_COVERAGE = 0.3
BENCH_ENTRIES = 13  # 4 render configs (cornellObj has no builtin) + 9 denoise cells
# Phase train: the training toolkit at the JAX trainer's defaults (TrainConfig:
# rt_ldr_alb's 6 channels, batch 16, 256^2 tiles, bf16 "mixed", l1_msssim,
# max_lr 2e-4), on data/denoise/ plus a Cornell pair rendered through K1.
TRAIN_RES = 256
TRAIN_SPP = (8, 256)  # the pair's noisy and clean samples per pixel
TRAIN_EPOCHS = 3  # train_device, of TrainConfig's 32 steps each
HOST_FED_STEPS = 8  # train(): one epoch of this many steps, then one under the profiler
CLI_EPOCHS = 2  # apps/train_denoiser.py at the script's own TrainConfig
# One float32 step (TF32 off) on the card against the CPU: summation order only.
TRAIN_STEP_RTOL = 1e-4

# Phase multichip: the mesh names the one card twice, so the split, the
# per-device launches and the merge run as on two cards (semantics, not
# scaling). The sample mode against the sequential Renderer: rtol and atol
# 1e-4 (the JAX tests' bar: each device's K1 sums round in their own
# order); every pixel-mode and Filter check bit for bit.
MULTICHIP_DEVICES = ("cuda:0", "cuda:0")
MULTICHIP_ITERS = 32  # Cornell 800x800, depth 8: sample and pixel modes through K1
MULTICHIP_K5_ITERS = 2  # cornellShip under bounce_megakernel, pixel mode
MULTICHIP_WAVEFRONT_ITERS = 1  # cornellShipTex on the wavefront, pixel mode
MULTICHIP_TOL = 1e-4
MULTICHIP_FILTER_SIZES = ((1920, 1080), (3840, 2160))
MULTICHIP_FILTER_MEMORY = (3000, 256)  # the default maxMemoryMB, and one that forces many tiles
# The mesh step's "l1" gradients against the single device's on the card:
# within this share of the largest (the CPU tests' bar,
# tests/test_torch_train_mesh.py).
MESH_GRAD_REL = 1e-5
MULTICHIP_TRAIN_STEPS = 4  # train() on the mesh at TrainConfig's defaults
MULTICHIP_APP_ITERS = 8
# Phase preview: a PreviewSession on Cornell 800x800 (K1, batches of 8).
PREVIEW_ITERS = 64
PREVIEW_BATCH = 8

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))


def phase(name: str, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{time.perf_counter() - T0:8.2f}s] {name} {extra}", flush=True)


# Probes of the per-draw integer work, built with the kernels' flags and
# headers: D draws in a chain, so (count at 16 - count at 8) / 8 is one
# draw's (threefry2x32 as K1 and K5 draw it) or one Philox call's (a new key
# per call, as each K6 thread and each K5 group has) instructions, whatever
# the frame around them.
DRAW_PROBE = r"""
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include "path.cuh"
template <int D>
__global__ void probe_threefry(uint32_t k0, uint32_t k1, float* out, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const Stream s{k0, k1, static_cast<uint64_t>(n), static_cast<uint64_t>(p)};
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < D; ++r) acc += s.uniform(r);
  out[p] = acc;
}
template <int D>
__global__ void probe_philox(uint32_t word, uint32_t* out) {
  const uint32_t p = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0u;
#pragma unroll
  for (int g = 0; g < D; ++g) {
    const Words4 w = counter_group(word + g, g, p);
    acc += w.x + w.y + w.z + w.w;
  }
  out[p] = acc;
}
template __global__ void probe_threefry<8>(uint32_t, uint32_t, float*, int);
template __global__ void probe_threefry<16>(uint32_t, uint32_t, float*, int);
template __global__ void probe_philox<8>(uint32_t, uint32_t*);
template __global__ void probe_philox<16>(uint32_t, uint32_t*);
"""
# SASS opcodes of the integer pipes (ALU and IMAD); conversions (I2F, F2I),
# the uniform datapath (U*), loads, stores and control are not counted.
INT_OPCODES = {"IADD3", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "IMNMX", "IABS",
               "POPC", "FLO", "BREV", "SGXT", "BMSK", "VIADD", "VIMNMX", "IADD", "IMUL", "SHL",
               "SHR", "LOP", "IDP", "ICMP"}
SASS: dict = {}  # per-draw integer instruction counts, filled by phase build


# SASS opcodes that load: global, shared, constant (per thread and uniform),
# generic and local (spills).
LOAD_OPCODES = ("LDG", "LDS", "LDC", "ULDC", "LD", "LDL")


def sass_opcodes(path: str) -> dict:
    """{kernel symbol: Counter of SASS opcodes} from ``cuobjdump -sass`` of
    a built library or cubin."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            counts[name][m.group(1).split(".")[0]] += 1
    return counts


def sass_int_counts(path: str) -> dict:
    """{kernel symbol: (integer instructions, all instructions)}."""
    return {k: (sum(v[op] for op in INT_OPCODES), sum(v.values()))
            for k, v in sass_opcodes(path).items()}


def loads(ops) -> int:
    return sum(ops[op] for op in LOAD_OPCODES)


def pick(counts: dict, word: str):
    return next(v for k, v in counts.items() if word in k)


def build_probe(source: str, d: str):
    """Compile ``source`` (with the kernels' flags and csrc/ headers) to a
    cubin in ``d``; its path."""
    src, cubin = os.path.join(d, "probe.cu"), os.path.join(d, "probe.cubin")
    with open(src, "w") as f:
        f.write(source)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.find_nvcc(), *flags, "-cubin", "-I", _build.CSRC, "-o", cubin, src],
                   capture_output=True, text=True, check=True, timeout=300)
    return cubin


def sass_draw_counts() -> dict:
    """Integer instructions per draw from the SASS: threefry per draw and
    Philox per call from DRAW_PROBE, and K6's whole kernel per draw from the
    built library (csrc/prng.cu)."""
    with tempfile.TemporaryDirectory() as d:
        probe = sass_int_counts(build_probe(DRAW_PROBE, d))
    per = lambda kind: (pick(probe, f"probe_{kind}ILi16")[0] - pick(probe, f"probe_{kind}ILi8")[0]) / 8
    k6_lib = next(p for p in _build.build() if os.path.basename(p).startswith("libprng_"))
    k6 = sass_int_counts(k6_lib)
    k6_int, k6_all = k6[plain_build(k6, "k6_kernel")]
    k5_lib = next(p for p in _build.build() if os.path.basename(p).startswith("libbounce_"))
    k5 = sass_int_counts(k5_lib)
    return {"threefry_int_per_draw": per("threefry"), "philox_int_per_call": per("philox"),
            "k6_kernel_int": k6_int, "k6_kernel_instructions": k6_all,
            "k6_words_instructions": pick(k6, "k6_kernelILb1E")[1],
            "k5_kernel_instructions": k5[plain_build(k5, "k5_kernel")][1],
            "k5_words_instructions": pick(k5, "k5_kernelILb0ELb0ELb1E")[1]}


# Probes of the scene record's reads, built with the kernels' flags and
# headers: D reads in a chain (a box test, a sphere test, or a material
# read at an index that differs across the warp, as shade's), so (loads at
# 4 - loads at 2) / 2 is one read's load instructions, from the record in
# global memory as K5 reads it (RecScene) or from K1's copy in shared
# memory (SharedScene).
LOAD_PROBE = r"""
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include "megakernel.cu"
template <int KIND, int D, class S>
__device__ __forceinline__ float probe_chain(const S& scene, int p) {
  V3 o = {1e-3f * static_cast<float>(p), 0.5f, 2.0f}, d = {0.1f, 0.2f, -1.0f};
  float acc = 0.0f;
#pragma unroll
  for (int g = 0; g < D; ++g) {
    V3 nrm = {0.0f, 0.0f, 0.0f};
    float t;
    if (KIND == 0) {
      t = box_intersect(scene.geom(g), o, d, nrm);
    } else if (KIND == 1) {
      t = sphere_intersect(scene.geom(g), o, d, nrm);
    } else {
      const Material m = scene.material((g + p) % 8);
      t = m.color.x + m.color.y + m.color.z + m.spec_ex + m.refl + m.refr + m.ior + m.emit;
      nrm = m.spec;
    }
    acc += t + nrm.x + nrm.y + nrm.z;
    o.x += 1e-6f * t;
  }
  return acc;
}
template <int KIND, int D>
__global__ void probe_global(const float* __restrict__ rec, float* out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  out[p] = probe_chain<KIND, D>(RecScene{rec, 8, 0}, p);
}
template <int KIND, int D>
__global__ void probe_shared(const float* __restrict__ rec, int len, float* out) {
  extern __shared__ float4 probe_rec[];
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const int at = shared_slot(k, 8);
    if (at >= 0) reinterpret_cast<float*>(probe_rec)[at] = rec[k];
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  out[p] = probe_chain<KIND, D>(SharedScene{probe_rec, 8, 0}, p);
}
""" + "".join(
    f"template __global__ void probe_global<{k}, {d}>(const float*, float*);\n"
    f"template __global__ void probe_shared<{k}, {d}>(const float*, int, float*);\n"
    for k in range(3) for d in (2, 4))
LOAD_KINDS = ("box", "sphere", "material")


def sass_load_counts() -> dict:
    """Load instructions per scene read from LOAD_PROBE ({"global" /
    "shared": {box, sphere, material}}), and the opcode counts of the load
    instructions in the built K1 (plain and counting builds)."""
    with tempfile.TemporaryDirectory() as d:
        probe = sass_opcodes(build_probe(LOAD_PROBE, d))
    per = lambda where, kind: (loads(pick(probe, f"probe_{where}ILi{kind}ELi4E"))
                               - loads(pick(probe, f"probe_{where}ILi{kind}ELi2E"))) / 2
    out = {where: {name: per(where, k) for k, name in enumerate(LOAD_KINDS)}
           for where in ("global", "shared")}
    k1_lib = next(p for p in _build.build() if os.path.basename(p).startswith("libmegakernel_"))
    k1 = sass_opcodes(k1_lib)
    for build, word in (("k1_kernel", "k1_kernelILb0ELb0E"),
                        ("k1_counting", "k1_kernelILb1ELb0E")):
        ops = pick(k1, word)
        out[build] = {op: ops[op] for op in LOAD_OPCODES if ops[op]}
        out[build]["all"] = sum(ops.values())
    return out


def ptxas_usage(log: str) -> dict:
    """{kernel symbol: {registers, stack, spill_stores, spill_loads}} from
    the ``-Xptxas -v`` messages of a build."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def host_us(fn, calls: int = 500, repeats: int = 3) -> float:
    """Host time per call of fn() in microseconds: the median over
    ``repeats`` of ``calls`` calls timed with the host's clock, the card
    idle at the start; a few hundred launches fit in the stream's queue, so
    the host does not wait for the card."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return float(np.median(times))


def burst_ms(fn, calls: int = 20, repeats: int = 7) -> float:
    """Median over ``repeats`` of the device time of ``calls`` back-to-back
    calls of fn(), per call, by CUDA events: the rate a stream of such calls
    runs at, host launch cost included where it exceeds the kernel's."""
    return float(np.median([cuda_ms(lambda: [fn() for _ in range(calls)])
                            for _ in range(repeats)])) / calls


_BLOCKER: list = []  # bf16 operands of a ~5 ms matmul chain that keeps the card busy


def queued_ms(fn, calls: int = 20, repeats: int = 5) -> float:
    """Device time per call of fn()'s kernels alone: the calls are enqueued
    behind a few ms of matmuls, so by the time the card reaches the first
    event, all of them wait in the stream and run back to back; the median
    over ``repeats`` of the events' time over ``calls``. The host's launch
    cost is out of it as long as enqueueing ``calls`` calls takes less than
    the matmuls (the host time is checked)."""
    if not _BLOCKER:
        _BLOCKER.append(torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16))
    a = _BLOCKER[0]
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        block_start, block_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        block_start.record()
        for _ in range(4):
            a @ a
        block_end.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if host_ms >= block_start.elapsed_time(block_end):
            raise AssertionError(f"enqueueing {calls} calls took {host_ms:.2f} ms, longer than "
                                 "the matmuls that hide it")
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def ray_bounces(dev, meta, options, iterations) -> tuple[int, int, int, torch.Tensor]:
    """(ray-bounces, Philox calls, necessary cluster visits, each path's
    bounces [iterations, N]) that ``iterations`` of this scene execute under
    ``options.rng``: the data-dependent work K1 and K5 do. A ray-bounce is
    one nearest-hit test and one shade of a live path; a path of B bounces
    draws rows 4 .. 3B + 3, i.e. (3B + 3) // 4 Philox groups of 4 rows when
    K5 draws K6's stream. The necessary visits (meshes that take the
    cluster walk, else 0): per ray-bounce, the clusters whose box the ray
    enters below its nearest hit's t."""
    n = meta.resolution[0] * meta.resolution[1]
    key = rng.make_key(SEED)
    walk = meta.has_obj and dev.cluster_tree.shape[0] > 0
    total = calls = necessary = 0
    paths = []
    for it in iterations:
        U = prng.iteration_uniforms(options, rng.iteration_key(key, it), it,
                                    num_rng_streams(meta.trace_depth), n,
                                    dev.camera.position.device)
        o, d = generate_camera_rays(dev.camera, meta.resolution, options, U)
        ones = torch.ones(n, device=o.x.device)
        s = PathStateSoA(o, d, Vec3(ones, ones, ones),
                         torch.full((n,), meta.trace_depth, dtype=torch.int32, device=o.x.device))
        per_path = torch.zeros(n, dtype=torch.int64, device=o.x.device)
        for b in range(meta.trace_depth):
            live = s.remaining > 0
            alive = int(live.sum())
            if alive == 0:
                break
            total += alive
            per_path += live
            h = intersect_soa(meta, dev, s.origin, s.direction)
            if walk:
                rays = torch.stack([*s.origin, *s.direction])[:, live]
                necessary += int(mh.clusters_reached(dev.cluster_bounds, rays, h.t[live],
                                                     NECESSARY_CHUNK).sum())
            s = shade_soa(meta, dev, s, h, U[4 + 3 * b], U[5 + 3 * b], U[6 + 3 * b])
        calls += int(((3 * per_path + 3) // 4).sum())
        paths.append(per_path)
    return total, calls, necessary, torch.stack(paths)


def lockstep_lane_use(paths: torch.Tensor) -> float:
    """The lane use of one thread per pixel with the bounce loop nested in
    the iteration loop, on these paths' bounces [iterations, N]: a warp of
    32 consecutive pixels runs each iteration's bounce rounds until its
    longest path ends, so the lanes are used sum(bounces) / (32 x the sum
    over warps and iterations of the warp's longest path)."""
    warps = torch.nn.functional.pad(paths, (0, (-paths.shape[1]) % 32)).view(paths.shape[0], -1, 32)
    return float(paths.sum()) / float(32 * warps.amax(dim=2).sum())


def k1_counters(dev, meta, options, key, record, iterations: int) -> dict:
    """One counting launch of K1 (``iterations`` from iteration 1, zeroed
    accumulators): its counters, the shares they give, and whether its
    accumulators equal the plain build's."""
    n = meta.resolution[0] * meta.resolution[1]
    acc_plain = torch.zeros((9, n), device="cuda")
    acc_count = torch.zeros((9, n), device="cuda")
    stats = torch.zeros(megakernel.K1_STATS, dtype=torch.int64, device="cuda")
    megakernel.megakernel_accumulate(dev, meta, options, acc_plain, 1, iterations, key,
                                     record=record)
    megakernel.megakernel_accumulate(dev, meta, options, acc_count, 1, iterations, key,
                                     record=record, stats=stats)
    rounds, live, raygens, raygen_rounds, fetches, atomics, tail = stats.tolist()
    return dict(rounds=rounds, live=live, raygens=raygens, raygen_rounds=raygen_rounds,
                fetches=fetches, atomics=atomics, tail=tail, lane_use=live / (32 * rounds),
                raygen_share=raygens / (32 * rounds), raygen_round_share=raygen_rounds / rounds,
                pixels_per_atomic=fetches / atomics, tail_share=tail / rounds,
                counting_build_equal=bool(torch.equal(acc_plain, acc_count)))


def k1_ops(meta, options, samples: int, bounces: int) -> tuple[float, float]:
    """(FP32 ops, INT32 ops) of one K1 launch over ``samples`` pixel-samples
    with ``bounces`` ray-bounces."""
    hit = sum(FP_OPS_BOX if g.type == int(GeomType.CUBE) else
              FP_OPS_SPHERE if g.type == int(GeomType.SPHERE) else 0 for g in meta.geoms)
    hit += FP_OPS_FACE * len(meta.mega_faces)
    draws_per_sample = 1 + (2 if options.antialiasing else 0) + (2 if options.depth_of_field else 0)
    fp = samples * (FP_OPS_RAYGEN + (FP_OPS_DOF if options.depth_of_field else 0)
                    + FP_OPS_PER_DRAW * draws_per_sample)
    fp += bounces * (hit + FP_OPS_SHADE + 3 * FP_OPS_PER_DRAW)
    integer = SASS["threefry_int_per_draw"] * (samples * draws_per_sample + 3 * bounces)
    return float(fp), float(integer)


@contextlib.contextmanager
def patched(module, name: str, fn):
    """Replace ``module.name`` by ``fn`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def counting(module, name: str):
    """Count the calls of ``module.name`` inside the block (a one-item list)."""
    count = [0]
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        count[0] += 1
        return orig(*args, **kwargs)

    with patched(module, name, wrapper):
        yield count


@contextlib.contextmanager
def recording_mesh_queries(keep: int = 2):
    """Keep the inputs of the first ``keep`` mesh-kernel queries the
    wavefront makes: iteration 1's bounce 0 (camera rays) and bounce 1."""
    calls = []
    orig = trace.mesh_hit

    def record(fp, bounds, rays, with_visits=False, **walk):
        if len(calls) < keep:
            calls.append(MeshQuery(fp, bounds, walk["face_gather"], walk["tree"], rays.clone()))
        return orig(fp, bounds, rays, with_visits, **walk)

    with patched(trace, "mesh_hit", record):
        yield calls


def plain_mesh_hit(fp, bounds, rays, with_visits=False, **walk):
    """The mesh query through the plain version, in the kernel's place."""
    return mh.mesh_hit_reference(fp, bounds, rays, with_visits)


def refuse(*args, **kwargs):
    raise AssertionError("the chunked Moller-Trumbore stream ran on the mesh main path")


def mesh_scene(name: str):
    scene = load_scene(os.path.join(HERE, "scenes", f"{name}.txt"))
    scene.set_resolution(RES, RES)
    scene.state.trace_depth = DEPTH
    return scene


def app_options(**changes) -> RenderOptions:
    """The options the app builds on CUDA with its default flags."""
    return dataclasses.replace(RenderOptions(megakernel=True, mesh_sort=None, winner_table="auto"),
                               **changes)


@dataclasses.dataclass
class MeshQuery:
    """One recorded mesh query: the scene's layouts and the rays [7, N]."""

    fp: torch.Tensor
    bounds: torch.Tensor
    face_gather: torch.Tensor
    tree: torch.Tensor
    rays: torch.Tensor

    def kernel(self, **kwargs):
        return mh.mesh_hit(self.fp, self.bounds, self.rays, face_gather=self.face_gather,
                           tree=self.tree, **kwargs)

    def plain(self):
        return mh.mesh_hit_reference(self.fp, self.bounds, self.rays)[0]

    def reached(self, t_limit):
        return mh.clusters_reached(self.bounds, self.rays, t_limit, NECESSARY_CHUNK)


def compare_mesh_outputs(q: MeshQuery, out_k, out_p, visits_k) -> dict:
    """Kernel outputs against the plain version's, per lane. A lane may
    differ only as the box-rounding case (ops/mesh_hit.py::
    box_rounding_lanes), proven and counted; and per ray the kernel's
    visits lie between the necessary ones (entered below its final t) and
    the clusters entered below t_cap."""
    hit_k, hit_p = out_k[4] >= 0, out_p[4] >= 0
    both = hit_k & hit_p
    rel = ((out_k[0] - out_p[0]).abs() / out_p[0].abs())[both]
    differ = (out_k.view(torch.int32) != out_p.view(torch.int32)).any(dim=0)
    proven = mh.box_rounding_lanes(q.fp, q.bounds, q.rays, out_k, out_p)
    final = torch.minimum(mh.final_t(out_k, q.rays), mh.final_t(out_p, q.rays))
    necessary, reachable = q.reached(final), q.reached(q.rays[6])
    return {
        "hit_miss_share": float((hit_k != hit_p).float().mean()),
        "t_max_rel": float(rel.max()) if rel.numel() else 0.0,
        "gid_share": float((out_k[4] != out_p[4]).float().mean()),
        "fid_share": float((out_k[7] != out_p[7]).float().mean()),
        "uv_share": float(((out_k[5] != out_p[5]) | (out_k[6] != out_p[6])).float().mean()),
        "bitwise": bool(torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))),
        "differing_lanes": int(differ.sum()),
        "box_rounding_lanes": int(proven.sum()),
        "bitwise_but_box_rounding": bool(torch.equal(differ, proven)),
        "visits_in_bounds": bool(((necessary <= visits_k) & (visits_k <= reachable)).all()),
    }


def mesh_bound(q: MeshQuery, necessary: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, FP32 ops, bytes) of one mesh query: the
    face tests of its necessary visits (necessary x 128 x FP_OPS_FACE_TEST),
    against each input (rays, face_gather, tree) read once and the [8, N]
    output written once."""
    ops = float(necessary) * 128 * FP_OPS_FACE_TEST
    nbytes = 4 * (q.rays.numel() + q.face_gather.numel() + q.tree.numel()
                  + mh.OUT_ROWS * q.rays.shape[1])
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def time_mesh_query(q: MeshQuery, **labels) -> dict:
    """The kernel (each block size of the sweep) and its plain version
    timed with CUDA events on one recorded query, with its bound and the
    counting build's counters; prints one mesh_time line."""
    sweep = {}
    for threads in MESH_BLOCK_SIZES:
        run = lambda: q.kernel(threads=threads)
        run()  # warm-up
        sweep[threads] = float(np.median([cuda_ms(run) for _ in range(5)]))
    ms = sweep[mh.THREADS]
    out_p = q.plain()  # also the warm-up
    plain_ms = cuda_ms(q.plain)
    stats = torch.zeros(mh.STATS, dtype=torch.int64, device=q.rays.device)
    _, visits = q.kernel(with_visits=True, stats=stats)
    _, visits_p = mh.mesh_hit_reference(q.fp, q.bounds, q.rays, with_visits=True)
    necessary = int(q.reached(mh.final_t(out_p, q.rays)).sum())
    bound_ms, bound_by, ops, nbytes = mesh_bound(q, necessary)
    nodes, walk_iters, leaf_rounds = stats.tolist()
    live = max(int((q.rays[6] > 0).sum()), 1)
    per_live = lambda x: f"{float(x) / live:.3f}"
    phase("mesh_time", **labels, ms=f"{ms:.4f}", threads=mh.THREADS,
          **{f"ms_{t}": f"{v:.4f}" for t, v in sweep.items()}, plain_ms=f"{plain_ms:.1f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, of_bound=f"{bound_ms / ms:.4f}",
          live_rays=live, necessary_per_live_ray=per_live(necessary),
          plain_visits_per_live_ray=per_live(visits_p.sum()),
          kernel_visits_per_live_ray=per_live(visits.sum()),
          nodes_per_live_ray=per_live(nodes), walk_lane_use=f"{nodes / max(32 * walk_iters, 1):.4f}",
          leaf_rounds_per_live_ray=per_live(leaf_rounds),
          holders_per_leaf_round=f"{float(visits.sum()) / max(leaf_rounds, 1):.3f}",
          fp32_ops=f"{ops:.3e}", bytes=int(nbytes), library_ms="none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, sweep=sweep)


PRIMS_FIELDS = ("t", "spec_ex", "refl", "refr", "ior", "emit", "u", "v", "mat_id", "kd", "ks",
                "ke", "bump", "is_obj")


def prims_bytes(o: Vec3, d: Vec3) -> int:
    """The bytes the primitive kernel needs over [N] rays (csrc/prims_hit.cu):
    each ray component that varies by lane read once (an expanded camera
    position is one value), OUT_F floats and OUT_I ints written a lane, and
    the zero word."""
    n = o.x.shape[0]
    varying = sum(c.stride(0) != 0 for c in (*o, *d))
    return 4 * (n * (varying + ph.OUT_F + ph.OUT_I) + 1)


def prims_phase(device) -> dict:
    """The primitive kernel (csrc/prims_hit.cu) on cornellShipTex at the
    main path's shape: its launches counted on the card over an eager
    iteration and over four graph replays of the main path (DEPTH each; the
    kernels line reports the replays' count), and on each bounce's rays of
    one iteration, every field of its hit bit for bit against
    ``intersect_primitives_soa``'s, its device ms per launch (queued, alone)
    against its byte bound and the plain version's ms by CUDA events (eager:
    ~1,660 launches). One prims_time line a bounce; returns the kernels
    line's numbers (means over the bounces)."""
    r = Renderer(mesh_scene("cornellShipTex"), app_options(), seed=SEED, device=device)
    queries = []
    orig = pathtrace.intersect_soa
    # an expanded camera position kept as it is, so the kernel reads it as on the main path
    keep = lambda c: c if c.stride(0) == 0 else c.clone()

    def record(meta, dev, o, d, *args, **kwargs):
        queries.append((Vec3(*map(keep, o)), Vec3(*map(keep, d))))
        return orig(meta, dev, o, d, *args, **kwargs)

    _build.zero_launches_on_device()
    with patched(pathtrace, "intersect_soa", record), graphs.disabled():
        r.step()
    eager = _build.launches_on_device("prims_hit")
    r.step_many(2)  # the later iteration's graph: captured, replayed
    _build.zero_launches_on_device()
    launches_before = ph.LAUNCHES
    r.step_many(4)
    replayed = _build.launches_on_device("prims_hit")
    if not (eager == DEPTH and replayed == 4 * DEPTH and ph.LAUNCHES == launches_before
            and len(queries) == DEPTH):
        raise AssertionError(f"prims_hit launches: eager {eager}, four replays {replayed}, "
                             f"host {ph.LAUNCHES - launches_before}, queries {len(queries)}")
    meta, table = r.meta, r.dev.prim_table
    times = []
    for bounce, (o, d) in enumerate(queries):
        run = lambda: ph.prims_hit(table, o, d)
        plain = lambda: trace.intersect_primitives_soa(meta, o, d)
        k, p = trace._Running.from_rows(*run()), plain()
        bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
        for name in PRIMS_FIELDS:
            if not torch.equal(bits(getattr(k, name)), bits(getattr(p, name))):
                raise AssertionError(f"prims_hit differs from the plain version in {name}")
        for name in ("normal", "color", "spec"):
            if not all(torch.equal(bits(a), bits(b)) for a, b in zip(getattr(k, name),
                                                                     getattr(p, name))):
                raise AssertionError(f"prims_hit differs from the plain version in {name}")
        n, nbytes = o.x.shape[0], prims_bytes(o, d)
        ms = queued_ms(run)
        plain_ms = float(np.median([cuda_ms(plain) for _ in range(3)]))
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        hits = int(torch.isfinite(p.t).sum())
        phase("prims_time", scene="cornellShipTex", bounce=bounce, lanes=n, hit_lanes=hits,
              prims=int(table.shape[0]), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
              bound_ms=f"{bound_ms:.4f}", bound_by="bytes", of_bound=f"{bound_ms / ms:.4f}",
              bytes=nbytes, equal=True, library_ms="none")
        times.append((ms, plain_ms, bound_ms))
    ms, plain_ms, bound_ms = (float(np.mean(col)) for col in zip(*times))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                launches=replayed)


def threefry_phase(device) -> dict:
    """The threefry block's kernel (csrc/prng.cu, ``threefry_uniforms``) at
    the wavefront's [4 + 3 * DEPTH, RES * RES]: its launches over an eager
    cornellShipTex iteration (one from the host, one counted on the card)
    and over four graph replays of the main path (four on the card, none
    from the host; the kernels line reports these), its block bit for bit
    against ``rng.uniform``'s (the plain int64 ops, on the card), its
    device ms per launch (queued, alone) against its bounds, and the plain
    version's ms by CUDA events: the byte bound (the float32 block written
    once) and the instruction-slot bound (the SASS's threefry instructions
    a draw at one warp instruction per clock per SM sub-partition,
    FP32_OPS_PER_S lane instructions/s; nvcc sends part of the adds to the
    FMA pipe as IMAD, so the 64-lane INT32 rate, reported beside it, is no
    floor: the kernel ran at ~110% of it). One threefry_time line; returns the kernels
    line's numbers."""
    r = Renderer(mesh_scene("cornellShipTex"), app_options(), seed=SEED, device=device)
    _build.zero_launches_on_device()
    before = prng.THREEFRY_LAUNCHES
    with graphs.disabled():
        r.step()
    eager = (prng.THREEFRY_LAUNCHES - before, _build.launches_on_device("threefry"))
    r.step_many(2)  # the later iteration's graph: captured, replayed
    _build.zero_launches_on_device()
    before = prng.THREEFRY_LAUNCHES
    r.step_many(4)
    replayed = _build.launches_on_device("threefry")
    if eager != (1, 1) or replayed != 4 or prng.THREEFRY_LAUNCHES != before:
        raise AssertionError(f"threefry launches: eager (host, card) {eager}, four replays "
                             f"{replayed}, host {prng.THREEFRY_LAUNCHES - before}")
    k, n = num_rng_streams(DEPTH), RES * RES
    key = rng.iteration_key(r.base_key, 2)
    run = lambda: prng.threefry_uniforms(key, k, n, device=device)
    plain = lambda: rng.uniform(key, (k, n), device)
    if not torch.equal(run(), plain()):
        raise AssertionError("threefry_uniforms differs from rng.uniform")
    ms = queued_ms(run)
    plain_ms = float(np.median([cuda_ms(plain) for _ in range(3)]))
    int_ops = k * n * SASS["threefry_int_per_draw"]
    slot_ms, bytes_ms = 1e3 * int_ops / FP32_OPS_PER_S, 1e3 * 4 * k * n / HBM_BYTES_PER_S
    bound_ms, bound_by = max((slot_ms, "instruction slots"), (bytes_ms, "bytes"))
    phase("threefry_time", shape=f"{k}x{n}", ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.3f}",
          slot_bound_ms=f"{slot_ms:.5f}", bytes_bound_ms=f"{bytes_ms:.5f}",
          int32_pipe_ms=f"{1e3 * int_ops / INT32_OPS_PER_S:.5f}",
          bound_by=bound_by, of_bound=f"{bound_ms / ms:.4f}", int32_ops=f"{int_ops:.4e}",
          bytes=4 * k * n, equal=True, eager_launches=eager, replay_launches=replayed,
          library_ms="none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                launches=replayed)


def compare_images(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a - b)
    agree = d.max(axis=-1) <= 1e-2
    return {"rmse": float(np.sqrt(np.mean(d ** 2))),
            "rmse_agreeing": float(np.sqrt(np.mean(d[agree] ** 2))) if agree.any() else 0.0,
            "max_abs": float(d.max()), "share_gt_1e-2": float(np.mean(~agree))}


def new_filter(dev: Device, kind: str, images: dict, output, f32: bool = False, **params):
    """A committed filter on the card over ``images`` (name -> host array
    or DeviceBuffer); ``f32`` runs the net in float32 in place of bf16."""
    f = dev.new_filter(kind)
    if f32:
        f._network_dtype = lambda: torch.float32
    for name, img in images.items():
        f.set_image(name, img)
    f.set_image("output", output)
    for k, v in params.items():
        f.set(k, v)
    f.commit()
    return f


def filter_output(dev: Device, kind: str, images: dict, monitored=False, inplace=False,
                  **params) -> np.ndarray:
    """Denoise copies of host ``images`` once; the output on the host.
    ``inplace``: the output is the color array."""
    copies = {n: img.copy() for n, img in images.items()}
    h, w = copies["color"].shape[:2]
    out = copies["color"] if inplace else np.zeros((h, w, 3), np.float32)
    f = new_filter(dev, kind, copies, out, **params)
    if monitored:
        f.set_progress_monitor_function(lambda p: True)
    f.execute()
    return out


def unet_flops(h: int, w: int, in_ch: int) -> int:
    """Multiply-add FLOPs (2 per FMA) of the U-Net's 3x3 convs on one
    [h, w] window, both multiples of 16."""
    return sum(2 * 9 * cin * cout * (h // UNET_CONV_SCALE[name]) * (w // UNET_CONV_SCALE[name])
               for name, cin, cout in conv_specs(in_ch))


def time_filter(f, runs: int) -> float:
    """ms per execute: host clock around ``runs`` executes between two
    synchronisations, after one warm-up."""
    f.execute()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(runs):
        f.execute()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / runs


def filter_phase(dev: Device, beauty: np.ndarray, albedo: np.ndarray,
                 fused_bf16: torch.Tensor) -> None:
    """The Filter API on the card: the app's call against the fused
    denoise, the single pass against the monitored path at 4K, DeviceBuffers
    against host arrays, the denoise matrix's times and memory, and the
    oidnDenoise CLI."""
    buf = lambda a: DeviceBuffer(a, dev.torch_device)
    # The raytrace app's call: RT, LDR, color + albedo on the host images.
    app_out = filter_output(dev, "RT", {"color": beauty, "albedo": albedo})
    diff = np.abs(app_out - fused_bf16.cpu().numpy())
    phase("filter", check="app_vs_fused_denoise", max_abs=f"{diff.max():.3e}",
          mean_abs=f"{diff.mean():.3e}", pixels_differing=int((diff.max(axis=-1) > 0).sum()),
          of=diff.shape[0] * diff.shape[1])
    if not (np.isfinite(app_out).all() and diff.mean() < DENOISE_BF16_MEAN_ABS
            and diff.max() < DENOISE_BF16_MAX_ABS):
        raise AssertionError("the Filter's output disagrees with the fused denoise")

    # Single pass against monitored: RT color + albedo + normal, HDR,
    # float32, 4K, at the default budget (1x2 tiles) and at 512 MB (3x4).
    gen = np.random.default_rng(SEED)
    w, h = FILTER_PARITY_SIZE
    images = {"color": (gen.random((h, w, 3), np.float32) * 4).astype(np.float32),
              "albedo": gen.random((h, w, 3), np.float32),
              "normal": (gen.random((h, w, 3), np.float32) * 2 - 1).astype(np.float32)}
    for max_mem, want_tiles in FILTER_PARITY_PLANS:
        kw = dict(f32=True, hdr=True, maxMemoryMB=max_mem)
        single = filter_output(dev, "RT", images, **kw)
        monitored = filter_output(dev, "RT", images, monitored=True, **kw)
        tiles = new_filter(dev, "RT", images, np.zeros((h, w, 3), np.float32), **kw).tile_counts
        d = float(np.abs(single - monitored).max())
        checks = {"single_vs_monitored_max_abs": f"{d:.3e}"}
        ok = d <= FILTER_PATH_ATOL and tiles == want_tiles and np.isfinite(single).all()
        if max_mem == FILTER_PARITY_PLANS[-1][0]:
            for mon in (False, True):
                inplace = filter_output(dev, "RT", images, monitored=mon, inplace=True, **kw)
                d = float(np.abs(inplace - monitored).max())
                checks[f"inplace_{'monitored' if mon else 'single'}_max_abs"] = f"{d:.3e}"
                ok = ok and d <= FILTER_PATH_ATOL
        phase("filter", check="single_pass_vs_monitored", size=f"{w}x{h}", dtype="float32",
              max_mem_mb=max_mem, tiles="x".join(map(str, tiles)), **checks)
        if not ok:
            raise AssertionError(f"the single pass disagrees with the monitored path: {checks}")
    del images, single, monitored, inplace

    # DeviceBuffer against host arrays, 1080p, the card's bf16 net.
    w, h = FILTER_BUFFER_SIZE
    images = {"color": (gen.random((h, w, 3), np.float32) * 4).astype(np.float32),
              "albedo": gen.random((h, w, 3), np.float32),
              "normal": (gen.random((h, w, 3), np.float32) * 2 - 1).astype(np.float32)}
    host = filter_output(dev, "RT", images, hdr=True)
    obuf = buf(np.zeros((h, w, 3), np.float32))
    new_filter(dev, "RT", {n: buf(i) for n, i in images.items()}, obuf,
               hdr=True).execute()
    d = float(np.abs(obuf.numpy() - host).max())
    phase("filter", check="device_buffer_vs_host", size=f"{w}x{h}", max_abs=f"{d:.3e}")
    if d > FILTER_PATH_ATOL:
        raise AssertionError(f"DeviceBuffer and host arrays disagree: {d}")

    # The denoise matrix (apps/benchmark.py's inputs: seed 0, inputScale 1),
    # DeviceBuffers in and out: ms per image, tiles, planned scratch and the
    # measured peak of the caching allocator.
    mgen = np.random.default_rng(0)
    for name, kind, params, (w, h) in DENOISE_MATRIX:
        bufs = {"color": buf(mgen.random((h, w, 3), np.float32))}
        if kind == "RT":
            bufs["albedo"] = buf(mgen.random((h, w, 3), np.float32))
            bufs["normal"] = buf(mgen.random((h, w, 3), np.float32) * 2 - 1)
        f = new_filter(dev, kind, bufs, buf(np.zeros((h, w, 3), np.float32)),
                       inputScale=1.0, **params)
        ms = time_filter(f, MATRIX_RUNS)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        f.execute()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # The bound: the convs on the aligned image once (the tiles' overlap
        # is the plan's, not the function's), or its f32 buffers read and
        # written once, whichever takes longer.
        in_ch = 3 * len(bufs)
        flops = unet_flops(-(-h // 16) * 16, -(-w // 16) * 16, in_ch)
        tile_flops = unet_flops(*f.tile_shape, in_ch) * f.tile_counts[0] * f.tile_counts[1]
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, h * w * (in_ch + 3) * 4 / HBM_BYTES_PER_S
        phase("filter_matrix", bench=f"{name}.{w}x{h}", ms_per_image=f"{ms:.3f}",
              tiles="x".join(map(str, f.tile_counts)), tile=f"{f.tile_shape[0]}x{f.tile_shape[1]}",
              planned_scratch_mib=f"{f.scratch_bytes / 2**20:.1f}",
              peak_mib=f"{peak / 2**20:.1f}",
              peak_above_resident_mib=f"{(peak - resident) / 2**20:.1f}",
              gflop=f"{flops / 1e9:.1f}", tile_gflop=f"{tile_flops / 1e9:.1f}",
              tflop_per_s=f"{tile_flops / ms / 1e9:.1f}",
              bound_ms=f"{1e3 * max(t_ops, t_bytes):.4f}",
              bound_by="operations" if t_ops >= t_bytes else "bytes",
              of_bound=f"{1e3 * max(t_ops, t_bytes) / ms:.4f}")
        del f, bufs

    # bench.py's standalone 1080p cells: RT hdr + alb + nrm, color x 4,
    # inputScale 1; DeviceBuffers (8 runs) and host arrays in and out (2 runs).
    bgen = np.random.default_rng(0)
    w, h = FILTER_BUFFER_SIZE
    host_images = {"color": bgen.random((h, w, 3), np.float32) * 4,
                   "albedo": bgen.random((h, w, 3), np.float32),
                   "normal": bgen.random((h, w, 3), np.float32) * 2 - 1}
    f = new_filter(dev, "RT", {n: buf(i) for n, i in host_images.items()},
                   buf(np.zeros((h, w, 3), np.float32)), hdr=True, inputScale=1.0)
    standalone_ms = time_filter(f, 8)
    # Where that execute's time goes: two executes under the profiler.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(2):
            f.execute()
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t) / 2
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 2e3
    # cuDNN's NCHW <-> NHWC transposes around its convs, the convs
    # themselves, and the rest (bias, ReLU, pooling, upsampling, concat,
    # pack and unpack).
    kind = lambda k: ("layout" if re.search(r"nchwToNhwc|nhwcToNchw", k) else
                      "conv" if re.search(r"conv|fprop|implicit_gemm|xmma|cutlass", k, re.I)
                      else "other")
    split = collections.Counter()
    for e in on_card:
        split[kind(e.key)] += e.self_device_time_total / 2e3
    phase("filter_profile", bench="RT.hdr_alb_nrm.1920x1080", wall_ms=f"{prof_wall_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}", device_busy_share=f"{busy_ms / prof_wall_ms:.3f}",
          conv_ms=f"{split['conv']:.3f}", layout_transpose_ms=f"{split['layout']:.3f}",
          other_ms=f"{split['other']:.3f}", kernels=sum(e.count for e in on_card) // 2)
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"    device {e.self_device_time_total / 2e3:9.3f} ms/execute "
              f"x{e.count // 2:4d}  {e.key[:90]}", flush=True)
    f = new_filter(dev, "RT", host_images, np.zeros((h, w, 3), np.float32), hdr=True,
                   inputScale=1.0)
    hostio_ms = time_filter(f, 2)
    phase("filter_matrix", denoise_standalone_1080p_ms=f"{standalone_ms:.3f}",
          denoise_standalone_1080p_hostio_ms=f"{hostio_ms:.3f}")

    # The oidnDenoise CLI on the render's beauty and albedo.
    from mygpuraytracer_tpu_torch.utils.image_io import load_image, write_pfm

    with tempfile.TemporaryDirectory() as tmp:
        write_pfm(os.path.join(tmp, "beauty.pfm"), beauty)
        write_pfm(os.path.join(tmp, "albedo.pfm"), albedo)
        common = [sys.executable, "-m", "mygpuraytracer_tpu_torch.apps.denoise",
                  "--device", str(dev.torch_device), "--ldr", os.path.join(tmp, "beauty.pfm"),
                  "--alb", os.path.join(tmp, "albedo.pfm")]
        inplace_pfm = os.path.join(tmp, "inplace.pfm")
        runs = {"plain": ["-o", os.path.join(tmp, "out.pfm")],
                "inplace": ["--inplace", "--maxmem", "0", "-o", inplace_pfm],
                "ref": ["--inplace", "--maxmem", "0", "-r", inplace_pfm]}
        for label, extra in runs.items():
            proc = subprocess.run(common + extra, capture_output=True, text=True, timeout=300,
                                  cwd=HERE)
            lines = [ln.strip().split("\r")[-1] for ln in proc.stdout.strip().splitlines()]
            fields = {"rc": proc.returncode, "out": repr(" | ".join(lines[-3:]))}
            if label == "plain" and proc.returncode == 0:
                d_cli = float(np.abs(load_image(os.path.join(tmp, "out.pfm")) - app_out).max())
                fields["vs_in_process_max_abs"] = f"{d_cli:.3e}"
            phase("filter", check=f"oidn_denoise_cli_{label}", **fields)
            if proc.returncode != 0:
                raise AssertionError(f"oidnDenoise CLI ({label}) failed:\n{proc.stdout}\n"
                                     f"{proc.stderr}")
            if label == "plain" and d_cli > FILTER_PATH_ATOL:
                raise AssertionError(f"the CLI's output differs from the Filter's: {d_cli}")


def timed_iterations(r: Renderer, iters: int) -> float:
    """ms per iteration of ``r.step_many(iters)`` from a reset, by CUDA
    events, after two warm-up iterations (the second captures the graph)
    (the accumulators then hold the timed run's ``iters`` iterations)."""
    r.step_many(2)
    r.reset()
    return cuda_ms(lambda: r.step_many(iters)) / iters


def profiled_step(r: Renderer) -> tuple[list, float]:
    """One more iteration of ``r`` under torch.profiler, recording the
    card's activity only (a smaller trace to reduce than with the CPU's):
    (the kernels that ran on the card, device-busy ms)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        r.step()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        raise AssertionError("the profiler recorded no kernel on the card")
    return on_card, sum(e.self_device_time_total for e in on_card) / 1e3


def device_ms(events, *words) -> float:
    """Device ms of the kernels whose name holds one of ``words``."""
    return sum(e.self_device_time_total for e in events
               if any(w in e.key.lower() for w in words)) / 1e3


@contextlib.contextmanager
def counting_bounce0_queries():
    """Count the wavefront's bounce-0 scene queries (the calls of
    ``intersect_soa`` without an ``active`` mask) inside the block."""
    count = [0]
    orig = pathtrace.intersect_soa

    def wrapper(*args, active=None, **kwargs):
        count[0] += active is None
        return orig(*args, active=active, **kwargs)

    with patched(pathtrace, "intersect_soa", wrapper):
        yield count


def require_equal(case: str, a: torch.Tensor, b: torch.Tensor, **labels) -> None:
    """Fail unless ``a`` and ``b`` are bitwise equal; print the count and the
    largest difference first."""
    if torch.equal(a, b):
        return
    d = (a - b).abs()
    phase("options", case=case, check="bitwise", equal=False, **labels,
          differing=int((a != b).sum()), max_abs=f"{float(d.max()):.3e}")
    raise AssertionError(f"{case}: {labels} differs from the reference run")


def first_bounce_cache_case(device, scene) -> None:
    """The first-bounce cache on and off (AA off) on the Cornell box and
    cornellShipTex: bitwise, one bounce-0 query per reset with it, one per
    iteration without; K2's launches one fewer per later iteration."""
    for name in ("cornell", "cornellShipTex"):
        cache_runs = {}
        for cache in (True, False):
            if name == "cornell":
                r = Renderer(scene(), RenderOptions(antialiasing=False, megakernel=False,
                                                    cache_first_bounce=cache),
                             seed=SEED, device=device)
            else:
                r = Renderer(mesh_scene(name), app_options(antialiasing=False,
                                                            cache_first_bounce=cache),
                             seed=SEED, device=device)
            if r.use_megakernel or r.options.first_bounce_cache_active != cache:
                raise AssertionError(f"first_bounce_cache: unexpected route {r.options}")
            r.step()
            r.reset()
            launches, times = [], []
            with counting_bounce0_queries() as queries:
                for _ in range(CACHE_ITERS):
                    mh.LAUNCHES = 0
                    times.append(cuda_ms(r.step))
                    launches.append(mh.LAUNCHES)
            cache_runs[cache] = (queries[0], launches, times, r.acc.clone())
        require_equal("first_bounce_cache", cache_runs[True][3], cache_runs[False][3], scene=name)
        for cache in (True, False):
            queries, launches, times, _ = cache_runs[cache]
            phase("options", case="first_bounce_cache", scene=name,
                  cache="on" if cache else "off", iterations=CACHE_ITERS,
                  bounce0_queries=queries, k2_launches_per_iter="/".join(map(str, launches)),
                  ms_per_iter_first=f"{times[0]:.1f}",
                  ms_per_iter_later=f"{np.mean(times[1:]):.1f}", bitwise_vs_off=True)
        (q_on, l_on, _, _), (q_off, l_off, _, _) = cache_runs[True], cache_runs[False]
        if (q_on, q_off) != (1, CACHE_ITERS):
            raise AssertionError(f"first_bounce_cache {name}: {q_on} bounce-0 queries with the "
                                 f"cache, {q_off} without, over {CACHE_ITERS} iterations")
        if name == "cornellShipTex" and not (
                l_on[0] == l_off[0] > 0
                and all(a == b - 1 for a, b in zip(l_on[1:], l_off[1:]))):
            raise AssertionError(f"first_bounce_cache: K2 launches {l_on} with the cache, "
                                 f"{l_off} without")


def options_phase(device) -> None:
    """The wavefront's options and the Renderer surface on the card: the
    material sort (each form) and the first-bounce cache bitwise against the
    plain wavefront, the dir AOV within its bounds and through the
    directional RTLightmap filter, move_camera against a fresh Renderer, and
    the benchmark app."""
    # ---- case=cornell_dof_cache_sort: BASELINE config #3 ----
    scene = lambda: cornell_box(resolution=(RES, RES), depth=DEPTH)
    runs = {}
    for impl in (None, *SORT_IMPLS):
        opts = (dict(BASELINE3, sort_by_material=False) if impl is None
                else dict(BASELINE3, sort_impl=impl))
        r = Renderer(scene(), RenderOptions(**opts), seed=SEED, device=device)
        if r.use_megakernel or r.options.first_bounce_cache_active:
            raise AssertionError(f"cornell_dof_cache_sort: unexpected route {r.options}")
        runs[impl] = (timed_iterations(r, OPTIONS_ITERS), r.acc.clone(), *profiled_step(r))
    # The wall share by subtraction drowns in the host's spread (one call can
    # read +-10%); the profiled iteration's kernels and device time do not.
    off_ms, off_acc, off_events, off_busy = runs[None]
    off_kernels = sum(e.count for e in off_events)
    phase("options", case="cornell_dof_cache_sort", sort="off", iterations=OPTIONS_ITERS,
          ms_per_iter=f"{off_ms:.2f}", msamples_per_s=f"{RES * RES / off_ms / 1e3:.3f}",
          cache_active=False, kernels_per_iter=off_kernels,
          device_busy_ms_per_iter=f"{off_busy:.2f}")
    for impl in SORT_IMPLS:
        ms, acc, events, busy = runs[impl]
        require_equal("cornell_dof_cache_sort", acc, off_acc, sort_impl=impl)
        kernels = sum(e.count for e in events)
        phase("options", case="cornell_dof_cache_sort", sort_impl=impl,
              iterations=OPTIONS_ITERS, ms_per_iter=f"{ms:.2f}",
              msamples_per_s=f"{RES * RES / ms / 1e3:.3f}",
              sort_share_wall=f"{1 - off_ms / ms:.3f}", kernels_per_iter=kernels,
              sort_share_kernels=f"{1 - off_kernels / kernels:.3f}",
              device_busy_ms_per_iter=f"{busy:.2f}",
              sort_share_device=f"{1 - off_busy / busy:.3f}",
              sort_kernels_ms=f"{device_ms(events, 'sort', 'radix'):.3f}",
              bitwise_vs_unsorted=True)

    # ---- case=cornellShipTex_sort: the app's resolved options, K2 counted ----
    ship = {}
    for sort in (False, True):
        r = Renderer(mesh_scene("cornellShipTex"), app_options(sort_by_material=sort),
                     seed=SEED, device=device)
        if r.use_megakernel or (r.options.mesh_sort, r.options.winner_table) != ("need", "oct"):
            raise AssertionError(f"cornellShipTex_sort: unexpected route {r.options}")
        with patched(trace, "mesh_intersect_soa", refuse):
            r.step_many(2)  # the warm-up and the capture
            r.reset()
            _build.zero_launches_on_device()
            ms = cuda_ms(lambda: r.step_many(OPTIONS_MESH_ITERS)) / OPTIONS_MESH_ITERS
            ship[sort] = (ms, _build.launches_on_device("mesh_hit") / OPTIONS_MESH_ITERS,
                          r.acc.clone(), r)
    require_equal("cornellShipTex_sort", ship[True][2], ship[False][2], sort_impl="fused")
    if ship[True][1] != ship[False][1] or ship[True][1] <= 0:
        raise AssertionError(f"cornellShipTex_sort: K2 launches per iteration {ship[True][1]} "
                             f"sorted against {ship[False][1]} unsorted")
    for sort in (False, True):
        phase("options", case="cornellShipTex_sort", sort="fused" if sort else "off",
              iterations=OPTIONS_MESH_ITERS, ms_per_iter=f"{ship[sort][0]:.1f}",
              msamples_per_s=f"{RES * RES / ship[sort][0] / 1e3:.3f}",
              k2_launches_per_iter=f"{ship[sort][1]:g}", bitwise_vs_unsorted=True)
    # Where the sort's time goes: one more iteration of each under torch.profiler.
    for sort in (False, True):
        events, busy = profiled_step(ship[sort][3])
        phase("options", case="cornellShipTex_sort", profile="fused" if sort else "off",
              kernels_per_iter=sum(e.count for e in events), device_busy_ms_per_iter=f"{busy:.1f}",
              mesh_kernel_ms_per_iter=f"{device_ms(events, 'mesh_hit'):.2f}",
              sort_kernels_ms_per_iter=f"{device_ms(events, 'sort', 'radix'):.2f}",
              gather_ms_per_iter=f"{device_ms(events, 'gather', 'index'):.2f}")

    # ---- case=first_bounce_cache: AA and DoF off, the cache on and off ----
    # It counts the Python calls of the bounce-0 query, which a graph's
    # replay does not make: eager (graph against eager: phase graph).
    with graphs.disabled():
        first_bounce_cache_case(device, scene)

    # ---- case=dir_aov: the wavefront's dir AOV; the megakernel route skipped ----
    # ---- case=dir_aov: the wavefront's dir AOV; the megakernel route skipped ----
    dir_runs = {}
    for mega in (False, True):
        r = Renderer(scene(), RenderOptions(dir_aov=True, megakernel=mega), seed=SEED,
                     device=device)
        megakernel.LAUNCHES = 0
        t = time.perf_counter()
        r.render(iterations=OPTIONS_ITERS)
        torch.cuda.synchronize()
        dir_runs[mega] = (time.perf_counter() - t, megakernel.LAUNCHES, r)
    r = dir_runs[False][2]
    require_equal("dir_aov", dir_runs[True][2].dir_acc, r.dir_acc, megakernel=True)
    img = r.dir_image()
    norms = np.linalg.norm(img, axis=-1)
    coverage = float((np.abs(img).sum(-1) > 1e-6).mean())
    fdev = Device()
    fdev.commit()
    out = np.zeros_like(img)
    f = new_filter(fdev, "RTLightmap", {"color": img}, out, directional=True)
    filter_ms = time_filter(f, 4)
    phase("options", case="dir_aov", iterations=OPTIONS_ITERS,
          render_s=f"{dir_runs[False][0]:.2f}", k1_launches_megakernel_on=dir_runs[True][1],
          min=f"{img.min():.4f}", max=f"{img.max():.4f}", max_norm=f"{norms.max():.6f}",
          coverage=f"{coverage:.3f}", rtlightmap_dir_ms=f"{filter_ms:.3f}",
          filter_out_finite=bool(np.isfinite(out).all()))
    if not (np.isfinite(img).all() and img.min() >= -1.0 and img.max() <= 1.0
            and norms.max() <= DIR_NORM_MAX and coverage > DIR_COVERAGE
            and dir_runs[True][1] == 0 and np.isfinite(out).all()):
        raise AssertionError("dir_aov: the AOV or its filter is out of bounds")

    # ---- case=move_camera: K1 after a move against a fresh Renderer ----
    position = [0.0, 5.0, 12.0]
    r = Renderer(scene(), RenderOptions(megakernel=True), seed=SEED, device=device)
    r.render(iterations=OPTIONS_ITERS)
    megakernel.LAUNCHES = 0
    r.move_camera(position=position)
    r.render(iterations=OPTIONS_ITERS)
    torch.cuda.synchronize()
    moved_launches = megakernel.LAUNCHES
    moved_scene = scene()
    moved_scene.state.camera.position = np.asarray(position, np.float32)
    moved_scene.state.camera.rebuild()
    fresh = Renderer(moved_scene, RenderOptions(megakernel=True), seed=SEED, device=device)
    fresh.render(iterations=OPTIONS_ITERS)
    require_equal("move_camera", r.acc, fresh.acc)
    phase("options", case="move_camera", position="/".join(f"{x:g}" for x in position),
          iterations=OPTIONS_ITERS, k1_launches=moved_launches, bitwise_vs_fresh=True)
    if not (r.use_megakernel and moved_launches > 0):
        raise AssertionError("move_camera: the moved render did not run through K1")

    # ---- case=benchmark_app: apps/benchmark.py --mode all --json ----
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mygpuraytracer_tpu_torch.apps.benchmark",
                           "--mode", "all", "--json"],
                          capture_output=True, text=True, timeout=600, cwd=HERE)
    bench_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"benchmark app failed:\n{proc.stdout}\n{proc.stderr}")
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    render = {e["bench"]: e["msamples_per_sec"] for e in results if "msamples_per_sec" in e}
    denoise = {e["bench"]: e["msec_per_image"] for e in results if "msec_per_image" in e}
    phase("options", case="benchmark_app", rc=proc.returncode, entries=len(results),
          seconds=f"{bench_s:.1f}", **{f"{k}_msamples_per_s": v for k, v in render.items()})
    phase("options", case="benchmark_app", **{f"{k}_ms": v for k, v in denoise.items()})
    if len(results) != BENCH_ENTRIES or len(render) != 4 or len(denoise) != 9:
        raise AssertionError(f"benchmark app printed {len(results)} entries: {results}")


def graph_pool_mib(r: Renderer) -> float | None:
    """MiB of the caching allocator's segments in ``r``'s graph pool (None:
    this PyTorch's snapshot names no pools)."""
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0] or r._graph_pool is None:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == tuple(r._graph_pool)) / 2**20


def profiled_steps(r: Renderer, iters: int) -> dict:
    """``r.step_many(iters)`` under torch.profiler (the CPU and the card),
    per iteration: wall ms, device-busy ms and share, kernels on the card,
    the host's kernel launches and graph launches."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        r.step_many(iters)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    calls = lambda names: sum(e.count for e in events if e.key in names)
    return dict(wall_ms=wall / iters, busy_ms=busy / iters, busy_share=busy / wall,
                kernels=sum(e.count for e in on_card) / iters,
                host_kernel_launches=calls(LAUNCH_CALLS) / iters,
                host_graph_launches=calls(GRAPH_CALLS) / iters)


def graph_phase(device) -> None:
    """The Renderer's CUDA graphs (render/graphs.py) against its eager
    route (``graphs.disabled()``) at 800x800, depth 8: bitwise on the
    accumulators, ms per iteration, profiled launches and device-busy share,
    capture seconds and graph-pool MiB; the syncs of an eager iteration;
    step_many under the sync debug mode's "error"; move_camera against a
    fresh Renderer."""
    bounce = RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto")
    cases = {"cornellShipTex": (lambda: mesh_scene("cornellShipTex"), app_options(),
                                "wavefront", GRAPH_ITERS),
             "cornellShipTex_cache": (lambda: mesh_scene("cornellShipTex"),
                                      app_options(antialiasing=False), "wavefront", GRAPH_ITERS),
             **{f"baseline3_{impl or 'unsorted'}": (
                 lambda: cornell_box(resolution=(RES, RES), depth=DEPTH),
                 RenderOptions(**(dict(BASELINE3, sort_impl=impl) if impl
                                  else dict(BASELINE3, sort_by_material=False))),
                 "wavefront", GRAPH_ITERS) for impl in (None, *SORT_IMPLS)},
             "shipTexOnly": (lambda: mesh_scene("shipTexOnly"), app_options(), "wavefront",
                             GRAPH_ITERS),
             "cornellShip_k5": (lambda: mesh_scene("cornellShip"), bounce, "k5",
                                GRAPH_K5_ITERS)}
    kept = {}
    for name, (make, opts, route, iters) in cases.items():
        runs = {}
        for label in ("eager", "graph"):
            r = Renderer(make(), opts, seed=SEED, device=device)
            if r.graph_route != route or (name.endswith("cache")
                                          != r.options.first_bounce_cache_active):
                raise AssertionError(f"graph {name}: route {r.graph_route}, {r.options}")
            with graphs.disabled() if label == "eager" else contextlib.nullcontext():
                r.step_many(1 + iters)  # the warm-up, and the graphs the timed run replays
                r.reset()
                r.step()
                ms = cuda_ms(lambda: r.step_many(iters)) / iters
                acc = r.acc.clone()
                prof = profiled_steps(r, iters if route == "k5" else GRAPH_PROFILE_ITERS)
            runs[label] = dict(ms=ms, acc=acc, prof=prof, r=r)
        g, e = runs["graph"], runs["eager"]
        require_equal(f"graph_{name}", g["acc"], e["acc"], route="graph_vs_eager")
        pool = graph_pool_mib(g["r"])
        phase("graph", case=name, route=route, iterations=iters,
              eager_ms_per_iter=f"{e['ms']:.2f}", graph_ms_per_iter=f"{g['ms']:.2f}", speedup=f"{e['ms'] / g['ms']:.2f}",
              bitwise_vs_eager=True, capture_s=f"{g['r'].graph.seconds:.3f}",
              pool_mib="not measured" if pool is None else f"{pool:.1f}")
        for label in ("eager", "graph"):
            p = runs[label]["prof"]
            phase("graph", case=name, profile=label, wall_ms_per_iter=f"{p['wall_ms']:.2f}",
                  device_busy_ms_per_iter=f"{p['busy_ms']:.2f}",
                  device_busy_share=f"{p['busy_share']:.3f}",
                  kernels_per_iter=f"{p['kernels']:.0f}",
                  host_kernel_launches_per_iter=f"{p['host_kernel_launches']:.1f}",
                  host_graph_launches_per_iter=f"{p['host_graph_launches']:.3f}")
        if name in ("cornellShipTex", "cornellShip_k5"):
            kept[name] = g["r"]
        del runs

    # The bounces that now run with no live lane, which the host guard
    # skipped: live lanes per bounce of the open-sky shipTexOnly's
    # iterations 1-2 (eager, counted with a host read per bounce).
    live = []

    def census(meta, dev, state, hit, *u):
        live.append(int((state.remaining > 0).sum()))
        return shade(meta, dev, state, hit, *u)

    r = Renderer(mesh_scene("shipTexOnly"), app_options(), seed=SEED, device=device)
    with graphs.disabled(), patched(pathtrace, "shade_soa", census) as shade:
        r.step_many(2)
    phase("graph", check="live_lanes_per_bounce", scene="shipTexOnly", iterations=2,
          live="/".join(map(str, live)), bounces_with_no_live_lane=live.count(0))

    # The syncs of one eager iteration after the first, listed (the capture
    # would refuse any); then the graphs' step_many after iteration 1 with
    # every sync an error.
    r = Renderer(mesh_scene("cornellShipTex"), app_options(), seed=SEED, device=device)
    with graphs.disabled():
        r.step()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                r.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    # (the mode's own notice on being set is not a sync)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    phase("graph", check="eager_iteration_syncs", scene="cornellShipTex", syncs=len(syncs),
          first=repr(syncs[:3]))
    if syncs:
        raise AssertionError(f"an eager iteration syncs the host: {syncs[:5]}")
    for name in ("cornellShipTex", "cornellShip_k5"):
        r = kept[name]
        r.reset()
        r.step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t = time.perf_counter()
            r.step_many(GRAPH_SYNC_ITERS)
            host_ms = 1e3 * (time.perf_counter() - t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        phase("graph", check="step_many_sync_debug_error", scene=name,
              iterations=GRAPH_SYNC_ITERS, syncs=0,
              host_ms_to_enqueue=f"{host_ms:.2f}", finite=bool(torch.isfinite(r.acc).all()))

    # move_camera, then 2 iterations, against a fresh Renderer at that camera.
    r = kept["cornellShipTex"]
    r.reset()
    r.step_many(3)
    captured, captured_first = r.graph, r.graph_first
    r.move_camera(position=GRAPH_MOVE)
    r.step_many(2)
    moved = mesh_scene("cornellShipTex")
    moved.state.camera.position = np.asarray(GRAPH_MOVE, np.float32)
    moved.state.camera.rebuild()
    fresh = Renderer(moved, app_options(), seed=SEED, device=device)
    fresh.step_many(2)
    require_equal("graph_move_camera", r.acc, fresh.acc)
    phase("graph", check="move_camera", scene="cornellShipTex",
          position="/".join(f"{x:g}" for x in GRAPH_MOVE), iterations=2,
          bitwise_vs_fresh=True, graph_kept=r.graph is captured,
          first_graph_kept=captured_first is not None and r.graph_first is captured_first)


def one_train_step(cfg: TrainConfig, device, x: np.ndarray, y: np.ndarray, params: dict,
                   mesh=None):
    """(loss, the grads reaching Adam) of one update from ``params``."""
    opt = Optimizer(params_from_jax(params).to(device), onecycle_schedule(16, cfg.max_lr))
    step_fn, _ = build_train_step(cfg, opt, mesh)
    loss = float(step_fn(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)))
    return loss, [p.grad for p in opt.params]


def profile_training(label: str, run) -> None:
    """One run of ``run()`` under torch.profiler (the card's activity only):
    wall ms, device-busy ms and share, and the kernels taking most of it,
    per step of HOST_FED_STEPS."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        raise AssertionError(f"the profiler recorded no kernel of {label} on the card")
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    per = lambda ms: f"{ms / HOST_FED_STEPS:.3f}"
    phase("train", step=label, steps=HOST_FED_STEPS, wall_ms_per_step=per(wall_ms),
          device_busy_ms_per_step=per(busy_ms), device_busy_share=f"{busy_ms / wall_ms:.3f}",
          conv_ms_per_step=per(device_ms(on_card, "conv", "cudnn", "xmma", "gemm", "cutlass",
                                         "sm90")),
          memcpy_ms_per_step=per(device_ms(on_card, "memcpy")),
          kernels_per_step=sum(e.count for e in on_card) // HOST_FED_STEPS)
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    device {e.self_device_time_total / 1e3 / HOST_FED_STEPS:8.3f} ms/step "
              f"x{e.count // HOST_FED_STEPS:5d}  {e.key[:90]}", flush=True)


def train_phase(device) -> None:
    """The training toolkit on the card: pairs rendered through K1, one step
    on the card against the CPU, train_device at the defaults (the host's
    syncs counted), the host-fed train() with its device-busy share, the
    export denoising through Filter("RT"), and the train_denoiser CLI; all
    files in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        train_steps(device, tmp)


def train_steps(device, tmp: str) -> None:
    data_dir = os.path.join(HERE, "data", "denoise")

    # 1. A training pair through K1.
    megakernel.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    noisy, clean = render_training_pairs(
        os.path.join(HERE, "scenes", "builtin_cornell.txt"), os.path.join(tmp, "pairs"), "cornell",
        noisy_spp=TRAIN_SPP[0], clean_spp=TRAIN_SPP[1], resolution=TRAIN_RES, seed=SEED,
        device=device)
    pairs_ms = 1e3 * (time.perf_counter() - t)
    launches = megakernel.LAUNCHES
    phase("train", step="render_training_pairs", size=f"{TRAIN_RES}x{TRAIN_RES}",
          spp="/".join(map(str, TRAIN_SPP)), ms=f"{pairs_ms:.1f}", k1_launches=launches,
          noisy_mean=f"{noisy[..., :3].mean():.4f}", clean_mean=f"{clean.mean():.4f}",
          albedo_max=f"{noisy[..., 3:].max():.4f}")
    if launches < 1:
        raise AssertionError("render_training_pairs launched K1 no time")
    if not (noisy.shape == (TRAIN_RES, TRAIN_RES, 6) and np.isfinite(noisy).all()
            and np.isfinite(clean).all() and clean.mean() > 1e-3):
        raise AssertionError("the rendered training pair is not finite or is black")

    # 2. One step on the card against the CPU (float32, TF32 off), and one mixed step.
    g = np.random.default_rng(SEED)
    xb, yb = g.random((4, 64, 64, 6), np.float32), g.random((4, 64, 64, 3), np.float32)
    params0 = init_params(6, SEED)
    cfg32 = TrainConfig(precision="float32", batch_size=4, tile_size=64)
    card_loss, _ = one_train_step(cfg32, device, xb, yb, params0)
    cpu_loss, _ = one_train_step(cfg32, "cpu", xb, yb, params0)
    mixed_loss, mixed_grads = one_train_step(TrainConfig(batch_size=4, tile_size=64), device, xb,
                                             yb, params0)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    phase("train", step="card_vs_cpu", float32_loss_card=f"{card_loss:.7f}",
          float32_loss_cpu=f"{cpu_loss:.7f}", rel=f"{rel:.2e}", mixed_loss=f"{mixed_loss:.7f}")
    if not (rel < TRAIN_STEP_RTOL and np.isfinite(mixed_loss)
            and all(gr.dtype == torch.float32 and bool(torch.isfinite(gr).all())
                    for gr in mixed_grads)):
        raise AssertionError("the card's training step disagrees with the CPU's or is not finite")

    # 3. train_device at the defaults, every host sync counted.
    names = sorted(f[: -len(".input.npy")] for f in os.listdir(data_dir) if f.endswith(".input.npy"))
    x_imgs = np.stack([np.load(os.path.join(data_dir, f"{n}.input.npy")) for n in names] + [noisy])
    y_imgs = np.stack([np.load(os.path.join(data_dir, f"{n}.target.npy")) for n in names] + [clean])
    cfg = TrainConfig(data_dir=data_dir, result_dir=os.path.join(tmp, "device"),
                      num_epochs=TRAIN_EPOCHS)
    records, syncs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # what earlier phases still hold
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params = train_device(cfg, x_imgs.astype(np.float32), y_imgs.astype(np.float32),
                                  log_fn=lambda rec: (records.append(rec), syncs.append(sum(
                                      "synchroniz" in str(w.message) for w in caught))),
                                  device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    peak_mib = (torch.cuda.max_memory_allocated() - resident) / 2**20
    gflop = 3 * cfg.batch_size * unet_flops(cfg.tile_size, cfg.tile_size, cfg.in_channels) / 1e9
    for i, rec in enumerate(records):
        ms = 1e3 * cfg.batch_size / rec["images_per_sec"]
        phase("train", step="train_device", epoch=rec["epoch"], loss=f"{rec['loss']:.6f}",
              lr=f"{rec['lr']:.3e}", ms_per_step=f"{ms:.3f}",
              images_per_s=f"{rec['images_per_sec']:.1f}", gflop_per_step=f"{gflop:.1f}",
              bf16_bound_share=f"{gflop / BF16_FLOPS_PER_S * 1e9 / (ms / 1e3):.4f}",
              host_syncs=syncs[i] - (syncs[i - 1] if i else 0))
    phase("train", step="train_device", peak_above_resident_mib=f"{peak_mib:.0f}",
          resident_mib=f"{resident / 2**20:.0f}", images=len(x_imgs),
          batch=cfg.batch_size, tile=cfg.tile_size, precision=cfg.precision, loss_fn=cfg.loss)
    losses = [r["loss"] for r in records]
    if len(losses) != TRAIN_EPOCHS or not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        raise AssertionError(f"train_device's epoch losses are not finite and falling: {losses}")
    if any(syncs[i] - syncs[i - 1] != 1 for i in range(1, len(syncs))):
        raise AssertionError(f"train_device synced the host other than once per epoch: {syncs}")

    # train_device once more under the profiler (one epoch of HOST_FED_STEPS), then
    # 4. the host-fed train(): one epoch, then one more under the profiler.
    short = dict(data_dir=data_dir, num_epochs=1, steps_per_epoch=HOST_FED_STEPS)
    profile_training("train_device_profile", lambda: train_device(
        TrainConfig(result_dir=os.path.join(tmp, "device_profiled"), **short), x_imgs, y_imgs,
        device=device))
    rec = []
    train(TrainConfig(result_dir=os.path.join(tmp, "host"), **short), log_fn=rec.append,
          device=device)
    profile_training("train_host_fed_profile", lambda: train(
        TrainConfig(result_dir=os.path.join(tmp, "host_profiled"), **short), device=device))
    phase("train", step="train_host_fed", steps=HOST_FED_STEPS,
          ms_per_step=f"{1e3 * cfg.batch_size / rec[0]['images_per_sec']:.3f}",
          images_per_s=f"{rec[0]['images_per_sec']:.1f}", loss=f"{rec[0]['loss']:.6f}")
    if not np.isfinite(rec[0]["loss"]):
        raise AssertionError("train() returned a non-finite loss")

    # 5. The export, loaded by Filter("RT"), on the rendered noisy pair.
    tza = os.path.join(tmp, "rt_ldr_alb.tza")
    export_weights(params, tza)
    fdev = Device()
    fdev.commit()
    f = fdev.new_filter("RT")
    out = np.zeros((TRAIN_RES, TRAIN_RES, 3), np.float32)
    f.set_image("color", np.ascontiguousarray(noisy[..., :3]))
    f.set_image("albedo", np.ascontiguousarray(noisy[..., 3:6]))
    f.set_image("output", out)
    with open(tza, "rb") as fh:
        f.set_data("weights", fh.read())
    f.commit()
    f.execute()
    if not (np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0):
        raise AssertionError("the exported weights' Filter output is not a finite [0,1] image")
    paths = {k: os.path.join(tmp, f"{k}.pfm") for k in ("denoised", "noisy", "clean")}
    save_image(paths["denoised"], out)
    save_image(paths["noisy"], np.clip(noisy[..., :3], 0.0, 1.0))
    save_image(paths["clean"], np.clip(clean, 0.0, 1.0))
    scores = {}
    for k in ("denoised", "noisy"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = compare_image.main([paths[k], paths["clean"], "--metric", "psnr", "ssim"])
        if rc != 0:
            raise AssertionError(f"compare_image exited {rc}")
        scores[k] = dict(line.split(" = ") for line in buf.getvalue().splitlines())
    phase("train", step="export_filter", **{f"{k}_{m}": v for k, d in scores.items()
                                            for m, v in d.items()})

    # 6. The CLI, as a user runs it, at the script's TrainConfig.
    cli_tza = os.path.join(tmp, "cli", "rt_ldr_alb.tza")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mygpuraytracer_tpu_torch.apps.train_denoiser", "rt_ldr_alb",
         data_dir, str(CLI_EPOCHS), "--out", cli_tza, "--result-dir", os.path.join(tmp, "cli_r")],
        capture_output=True, text=True, timeout=600, cwd=HERE)
    phase("train", step="train_denoiser_cli", rc=proc.returncode,
          s=f"{time.perf_counter() - t:.1f}", tza=os.path.isfile(cli_tza),
          out=repr(" | ".join(proc.stdout.strip().splitlines()[-3:])))
    if proc.returncode != 0 or not os.path.isfile(cli_tza):
        raise AssertionError(f"train_denoiser failed:\n{proc.stdout}\n{proc.stderr}")


def synced_s(fn) -> float:
    """Wall seconds of fn(), the card synchronised before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def require_launches(name: str, launches: int) -> None:
    if launches < 1:
        raise AssertionError(f"{name} launched its kernel no time")


def multichip_phase(device) -> None:
    """Multi-device rendering, denoising and training over the mesh
    MULTICHIP_DEVICES: each against its single-device counterpart."""
    mesh = make_mesh(devices=MULTICHIP_DEVICES)
    mega = RenderOptions(megakernel=True)

    # 1. Sample mode through K1: one launch per device, one psum.
    r = Renderer(cornell_box(resolution=(RES, RES), depth=DEPTH), mega, seed=SEED, device=device)
    megakernel.LAUNCHES = 0
    out = {}
    sample_s = synced_s(lambda: out.update(rows=render_multichip_sample(
        r.dev, r.meta, r.options, r.base_key, MULTICHIP_ITERS, mesh)))
    launches = megakernel.LAUNCHES
    require_launches("sample mode (K1)", launches)
    seq_s = synced_s(lambda: r.render(MULTICHIP_ITERS))
    img, alb, nrm = out["rows"]
    got = torch.stack([*img, *alb, *nrm])
    diff = (got - r.acc).abs()
    close = bool(torch.all(diff <= MULTICHIP_TOL + MULTICHIP_TOL * r.acc.abs()))
    phase("multichip", mode="sample", route="k1", iterations=MULTICHIP_ITERS,
          devices=",".join(MULTICHIP_DEVICES), k1_launches=launches, max_abs=f"{diff.max():.3e}",
          aov_equal=torch.equal(got[3:9], r.acc[3:9]), s=f"{sample_s:.4f}",
          sequential_s=f"{seq_s:.4f}")
    if not close:
        raise AssertionError("sample mode disagrees with the sequential render beyond 1e-4")

    # 2. Pixel mode through K1, one iteration per step, against a sequential
    # render of one iteration per launch: bit for bit.
    def pixel_mode(name, scene, options, iters):
        r = Renderer(scene, options, seed=SEED, device=device)
        step_fn, make_state = sharded_render_step(r.meta, r.options, mesh)
        image, albedo, cache = make_state()
        devs = replicate(r.dev, mesh)
        state = {"s": (image, albedo, cache)}

        def steps():
            for it in range(1, iters + 1):
                state["s"] = step_fn(devs, *state["s"], it, r.base_key)

        megakernel.LAUNCHES = megakernel.BOUNCE_LAUNCHES = prng.LAUNCHES = 0
        mh.LAUNCHES = 0
        pixel_s = synced_s(steps)
        counts = dict(k1_launches=megakernel.LAUNCHES, k5_launches=megakernel.BOUNCE_LAUNCHES,
                      k6_launches=prng.LAUNCHES, mesh_launches=mh.LAUNCHES)
        seq_s = synced_s(lambda: [r.step() for _ in range(iters)])
        gathered = torch.cat(state["s"][0].base, dim=1)
        equal = torch.equal(gathered, r.acc)
        phase("multichip", mode="pixels", route=name, iterations=iters,
              lanes_per_device=gathered.shape[1] // mesh.size, bitwise=equal,
              max_abs=f"{(gathered - r.acc).abs().max():.3e}", s=f"{pixel_s:.4f}",
              sequential_s=f"{seq_s:.4f}", **counts)
        if not equal:
            raise AssertionError(f"pixel mode ({name}) is not bitwise the single-device render")
        return counts

    counts = pixel_mode("k1", cornell_box(resolution=(RES, RES), depth=DEPTH), mega,
                        MULTICHIP_ITERS)
    require_launches("pixel mode (K1)", counts["k1_launches"])
    counts = pixel_mode("k5", mesh_scene("cornellShip"),
                        RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto"),
                        MULTICHIP_K5_ITERS)
    require_launches("pixel mode (K5)", counts["k5_launches"])
    counts = pixel_mode("wavefront", mesh_scene("cornellShipTex"),
                        app_options(megakernel=False), MULTICHIP_WAVEFRONT_ITERS)
    require_launches("pixel mode (the mesh kernel)", counts["mesh_launches"])

    # 3. The Filter's mesh against the single-device execute: bit for bit.
    fdev = Device()
    fdev.commit()
    g = np.random.default_rng(SEED)
    for w, h in MULTICHIP_FILTER_SIZES:
        images = {"color": g.random((h, w, 3), np.float32) * 4,
                  "albedo": g.random((h, w, 3), np.float32),
                  "normal": g.random((h, w, 3), np.float32) * 2 - 1}
        bufs = {n: DeviceBuffer(a) for n, a in images.items()}
        for mem in MULTICHIP_FILTER_MEMORY:
            outs, times = [], []
            for m in (None, mesh):
                out = DeviceBuffer(np.zeros((h, w, 3), np.float32))
                f = new_filter(fdev, "RT", bufs, out, hdr=True, maxMemoryMB=mem, mesh=m)
                times.append(time_filter(f, 2))
                outs.append(out.array)
            equal = torch.equal(outs[0], outs[1])
            phase("multichip", check="filter_mesh", size=f"{w}x{h}", maxMemoryMB=mem,
                  tiles="x".join(map(str, f.tile_counts)), bitwise=equal, ms=f"{times[1]:.3f}",
                  single_ms=f"{times[0]:.3f}")
            if not (equal and bool(torch.isfinite(outs[1]).all())):
                raise AssertionError(f"the Filter's mesh is not bitwise the single device at "
                                     f"{w}x{h}, maxMemoryMB {mem}")

    # 4. The trainer on the mesh: float32 steps against the single device's
    # (the loss, and the gradients reaching Adam), then train() at
    # TrainConfig's defaults beside the single device. On the mesh that names
    # the card twice a replica is its master tensor, so a mesh of the card and
    # the CPU also runs, whose replicas are copies: its gradients reach the
    # master only through the copies' backward. The gradients' bars
    # (MESH_GRAD_REL, TRAIN_STEP_RTOL) are per loss and mesh: "l1" on the card
    # alone is held to the CPU tests' 1e-5; l1_msssim's float32 gradients
    # shift with the order of their sums by more than that (JAX's float32
    # SSIM gradient alone lies 1.6e-5 x from float64:
    # tests/test_torch_train_grad_parity.py) and the card against
    # the CPU rounds its convolutions differently, so those take the card-
    # against-CPU bar of the loss, 1e-4. A dropped or mis-scaled shard moves
    # the gradients by a share of themselves.
    g = np.random.default_rng(SEED)
    xb, yb = g.random((4, 64, 64, 6), np.float32), g.random((4, 64, 64, 3), np.float32)
    params0 = init_params(6, SEED)
    card_and_cpu = make_mesh(devices=(MULTICHIP_DEVICES[0], "cpu"))
    for check, loss, m, grad_rel in (
            ("train_step_float32", "l1_msssim", mesh, TRAIN_STEP_RTOL),
            ("train_step_float32_l1", "l1", mesh, MESH_GRAD_REL),
            ("train_step_float32_card_and_cpu", "l1", card_and_cpu, TRAIN_STEP_RTOL)):
        cfg32 = TrainConfig(precision="float32", batch_size=4, tile_size=64, loss=loss)
        single_loss, single_grads = one_train_step(cfg32, device, xb, yb, params0)
        mesh_loss_, mesh_grads = one_train_step(cfg32, device, xb, yb, params0, mesh=m)
        rel = abs(mesh_loss_ - single_loss) / abs(single_loss)
        scale = max(float(gr.abs().max()) for gr in single_grads)
        grad_diff = max(float((a - b).abs().max()) for a, b in zip(mesh_grads, single_grads))
        phase("multichip", check=check, loss_fn=loss, devices=",".join(map(str, m.devices)),
              loss_mesh=f"{mesh_loss_:.7f}", loss_single=f"{single_loss:.7f}", rel=f"{rel:.2e}",
              grad_max_abs_diff=f"{grad_diff:.3e}", of_largest_grad=f"{grad_diff / scale:.2e}",
              grad_bar=grad_rel)
        if not (rel < TRAIN_STEP_RTOL and grad_diff <= grad_rel * scale
                and all(gr.device.type == "cuda" for gr in mesh_grads)):
            raise AssertionError(f"the trainer's mesh step ({check}) disagrees with the single "
                                 "device's")
    data_dir = os.path.join(HERE, "data", "denoise")
    with tempfile.TemporaryDirectory() as tmp:
        per_step = {}
        for label, m in (("single", None), ("mesh", mesh)):
            rec = []
            train(TrainConfig(data_dir=data_dir, result_dir=os.path.join(tmp, label),
                              num_epochs=1, steps_per_epoch=MULTICHIP_TRAIN_STEPS),
                  mesh=m, log_fn=rec.append, device=device)
            per_step[label] = (1e3 * TrainConfig().batch_size / rec[0]["images_per_sec"],
                               rec[0]["loss"])
        phase("multichip", check="train", steps=MULTICHIP_TRAIN_STEPS,
              batch=TrainConfig().batch_size, tile=TrainConfig().tile_size,
              precision=TrainConfig().precision, ms_per_step=f"{per_step['mesh'][0]:.3f}",
              single_ms_per_step=f"{per_step['single'][0]:.3f}",
              loss=f"{per_step['mesh'][1]:.6f}", single_loss=f"{per_step['single'][1]:.6f}")
        if not np.isfinite(per_step["mesh"][1]):
            raise AssertionError("train() on the mesh gave a non-finite loss")

    # 5. The app's --multichip: one card visible, so the sequential path.
    for mode in ("sample", "pixels"):
        with tempfile.TemporaryDirectory() as out_dir:
            proc = subprocess.run(
                [sys.executable, "-m", "mygpuraytracer_tpu_torch.apps.raytrace", "cornell",
                 "--resolution", str(RES), str(RES), "--iterations", str(MULTICHIP_APP_ITERS),
                 "--depth", str(DEPTH), "--no-denoise", "--multichip", mode,
                 "--out-dir", out_dir], capture_output=True, text=True, timeout=600, cwd=HERE)
            sequential = "multichip: single device visible; using the sequential path" in \
                proc.stdout
            phase("multichip", check="app", flag=mode, rc=proc.returncode,
                  pngs=len(os.listdir(out_dir)), sequential_logged=sequential)
            if proc.returncode != 0 or not sequential or len(os.listdir(out_dir)) != 3:
                raise AssertionError(f"the app's --multichip {mode} did not log the sequential "
                                     f"path and write its PNGs:\n{proc.stdout}\n{proc.stderr}")


def preview_phase(device) -> None:
    """The preview app's session on the card: frames over localhost, a
    camera move (a reset that restarts the accumulation) and a save with
    the denoise."""
    import http.client

    from mygpuraytracer_tpu_torch.utils.png import decode_png

    session = PreviewSession(cornell_box(resolution=(RES, RES), depth=DEPTH),
                             RenderOptions(megakernel=True), iterations=PREVIEW_ITERS,
                             batch=PREVIEW_BATCH, seed=SEED, device=device)
    server = make_server(session, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection(*server.server_address, timeout=60)

    def get(path, body=None):
        conn.request("GET" if body is None else "POST", path,
                     None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()

    def state():
        return json.loads(get("/state")[1])

    def wait(pred, what):
        t = time.perf_counter()
        while not pred(state()):
            if time.perf_counter() - t > 120 or not session.thread.is_alive():
                raise AssertionError(f"preview: {what} did not happen (render thread "
                                     f"{'alive' if session.thread.is_alive() else 'dead'})")
            time.sleep(0.01)

    try:
        megakernel.LAUNCHES = 0
        t = time.perf_counter()
        session.start()
        wait(lambda s: s["done"] and s["iteration"] == PREVIEW_ITERS, "the first accumulation")
        first_s = time.perf_counter() - t
        first_launches = megakernel.LAUNCHES
        frames = 0
        for _ in range(3):
            status, png = get("/frame.png")
            frames += status == 200 and decode_png(png).shape == (RES, RES, 3)
        get("/camera", {"orbit": [40, -10]})
        wait(lambda s: s["resets"] == 1 and s["done"] and s["iteration"] == PREVIEW_ITERS,
             "the accumulation after the camera move")
        launches = megakernel.LAUNCHES
        with tempfile.TemporaryDirectory() as out_dir:
            session.out_dir = out_dir
            status, body = get("/save", {"denoise": True})
            saved = json.loads(body)["saved"]
            pngs = [p for p in saved if os.path.isfile(p)]
        st = state()
        phase("preview", scene="cornell", size=f"{RES}x{RES}", iterations=PREVIEW_ITERS,
              batch=PREVIEW_BATCH, frames=frames, resets=st["resets"], k1_launches=launches,
              k1_launches_before_move=first_launches, first_accumulation_s=f"{first_s:.3f}",
              fps=st["fps"], saved=len(pngs))
        require_launches("the preview session (K1)", launches)
        # The move restarted the accumulation from iteration 0: as many
        # launches after it as before.
        if frames != 3 or st["resets"] != 1 or launches != 2 * first_launches or len(pngs) != 3:
            raise AssertionError(f"preview: frames {frames}, resets {st['resets']}, K1 launches "
                                 f"{first_launches} then {launches}, saved {saved}")
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        session.stop()


def bench_phase() -> None:
    """``python -m mygpuraytracer_tpu_torch.bench`` in a subprocess: its
    last JSON line holds every key of the repo's bench.py, its Msamples/s
    and ms values non-null."""
    import ast

    tree = ast.parse(open(os.path.join(HERE, "bench.py")).read())
    keys = next([k.value for k in node.value.keys] for node in ast.walk(tree)
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mygpuraytracer_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=900, cwd=HERE)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    last = json.loads(lines[-1]) if lines else {}
    print("    bench:", lines[-1] if lines else "(no JSON line)", flush=True)
    timed = [k for k in keys if k.endswith(("msamples_per_sec", "_ms", "ms_per_frame"))]
    missing = [k for k in keys if k not in last]
    null = [k for k in timed + ["value"] if last.get(k) is None]
    phase("bench", rc=proc.returncode, s=f"{time.perf_counter() - t:.1f}", lines=len(lines),
          keys=len(last), missing=",".join(missing) or "none", null=",".join(null) or "none")
    if proc.returncode != 0 or missing or null:
        raise AssertionError(f"the port's bench failed or left keys out or null:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("device", card=repr(kind), count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, port=port.__version__)

    # ---- build ---------------------------------------------------------------
    _build.library()
    phase("build", nvcc_s=f"{_build.build_seconds:.1f}" if _build.build_seconds else "cached",
          so=",".join(os.path.basename(p) for p in _build.build()))
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip(), flush=True)
    SASS.update(sass_draw_counts())
    phase("build", sass_threefry_int_per_draw=SASS["threefry_int_per_draw"],
          sass_philox_int_per_call=SASS["philox_int_per_call"],
          sass_philox_int_per_draw=SASS["philox_int_per_call"] / 4,
          sass_k6_kernel_int=SASS["k6_kernel_int"],
          sass_k6_kernel_int_per_draw=SASS["k6_kernel_int"] / 4,
          sass_k6_kernel_instructions=SASS["k6_kernel_instructions"],
          sass_k6_words_instructions=SASS["k6_words_instructions"],
          sass_k5_kernel_instructions=SASS["k5_kernel_instructions"],
          sass_k5_words_instructions=SASS["k5_words_instructions"])

    # ---- k1_parity -------------------------------------------------------------
    options = RenderOptions(megakernel=True)
    key = rng.make_key(SEED)
    parity = {}
    for name, make in (("cornell", cornell_box), ("cornellGlass", cornell_glass)):
        dev, meta = build_device_scene(make(resolution=(RES, RES), depth=DEPTH), device=device)
        n = RES * RES
        acc_k = torch.zeros((9, n), device=device)
        acc_p = torch.zeros((9, n), device=device)
        megakernel.megakernel_accumulate(dev, meta, options, acc_k, 1, PARITY_ITERS, key)
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: megakernel.megakernel_accumulate_reference(
            dev, meta, options, acc_p, 1, PARITY_ITERS, key))
        to_img = lambda rows: rows.reshape(3, RES, RES).permute(1, 2, 0).cpu().numpy()
        mean_k = to_img(acc_k[0:3]) / PARITY_ITERS
        mean_p = to_img(acc_p[0:3]) / PARITY_ITERS
        if not (np.isfinite(mean_k).all() and mean_k.mean() > 1e-3):
            raise AssertionError(f"K1 image of {name} is not finite or is black")
        cmp = compare_images(mean_k, mean_p)
        aov = compare_images(to_img(acc_k[3:6]), to_img(acc_p[3:6])) | {
            "normal_share_gt_1e-2": compare_images(to_img(acc_k[6:9]), to_img(acc_p[6:9]))[
                "share_gt_1e-2"]}
        phase("k1_parity", scene=name, **{k: f"{v:.3e}" for k, v in cmp.items()},
              aov_max_abs=f"{aov['max_abs']:.3e}", albedo_share_gt_1e_2=f"{aov['share_gt_1e-2']:.3e}",
              normal_share_gt_1e_2=f"{aov['normal_share_gt_1e-2']:.3e}", plain_ms=f"{plain_ms:.1f}")
        if cmp["rmse_agreeing"] >= PARITY_RMSE or cmp["share_gt_1e-2"] >= PARITY_PIXEL_SHARE \
                or aov["share_gt_1e-2"] >= PARITY_PIXEL_SHARE \
                or aov["normal_share_gt_1e-2"] >= PARITY_PIXEL_SHARE:
            raise AssertionError(f"K1 disagrees with its plain version on {name}: {cmp}, {aov}")
        parity[name] = dict(cmp, plain_ms=plain_ms, dev=dev, meta=meta)

    # ---- render: the main path, counted ------------------------------------------
    scene = cornell_box(resolution=(RES, RES), depth=DEPTH)
    renderer = Renderer(scene, options, seed=SEED, device=device)
    if not renderer.use_megakernel:
        raise AssertionError("Renderer did not route the Cornell box to K1")
    megakernel.LAUNCHES = 0
    _build.zero_launches_on_device()
    t = time.perf_counter()
    denoised, beauty = renderer.render_denoised(iterations=32, batch=16)
    main_path_s = time.perf_counter() - t
    k1_launches = _build.launches_on_device("k1")  # counted on the card
    if k1_launches < 1 or k1_launches != megakernel.LAUNCHES:
        raise AssertionError(f"the main path launched K1 {k1_launches} times on the card, "
                             f"{megakernel.LAUNCHES} from the host")
    if not (denoised.shape == (RES, RES, 3) and np.isfinite(denoised).all()
            and np.isfinite(beauty).all() and 0.0 <= denoised.min() and denoised.max() <= 1.0):
        raise AssertionError("denoised output is not a finite [0,1] 800x800x3 image")
    phase("render", main_path_s=f"{main_path_s:.2f}", k1_launches=k1_launches,
          beauty_mean=f"{beauty.mean():.4f}", denoised_mean=f"{denoised.mean():.4f}")

    # K1 timed as step_many(16) calls it, iterations 1..16 into zeroed
    # accumulators: its time against its bound, its counters, the sweep,
    # then the same with depth of field.
    dev, meta = parity["cornell"]["dev"], parity["cornell"]["meta"]
    record = megakernel.scene_record(meta, dev.camera)
    acc = torch.zeros((9, RES * RES), device=device)
    samples = RES * RES * PARITY_ITERS
    usage = {k: v for k, v in ptxas_usage(_build.build_log).items() if "k1_kernel" in k}
    lib = _build.library()
    k1 = {}
    for case, opts in (("cornell", options),
                       ("cornell_dof", dataclasses.replace(options, depth_of_field=True))):
        run_k1 = lambda: megakernel.megakernel_accumulate(
            dev, meta, opts, acc, 1, PARITY_ITERS, key, record=record)
        ms = time_k1(run_k1, acc)
        bounces, _, _, paths = ray_bounces(dev, meta, opts, range(1, PARITY_ITERS + 1))
        fp_ops, int_ops = k1_ops(meta, opts, samples, bounces)
        bytes_moved = 2 * acc.numel() * 4 + record.numel() * 4
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = max(fp_ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
        bound = 1e3 * max(t_bytes, t_ops)
        # An SM issues one warp-instruction per clock per sub-partition,
        # whichever pipe it goes to: all FP32 and INT32 instructions over
        # the FP32 rate is the floor the issue slots set.
        issue_ms = 1e3 * (fp_ops + int_ops) / FP32_OPS_PER_S
        counts = k1_counters(dev, meta, opts, key, record, PARITY_ITERS)
        live_rel = abs(counts["live"] - bounces) / bounces
        k1[case] = dict(ms=ms, bound_ms=bound, bound_by="bytes" if t_bytes > t_ops else "operations")
        phase("render", case=case, k1_ms_per_launch=f"{ms:.3f}",
              k1_ms_per_iter=f"{ms / PARITY_ITERS:.3f}",
              msamples_per_s=f"{samples / ms / 1e3:.1f}", ray_bounces=bounces,
              bounces_per_sample=f"{bounces / samples:.3f}", fp32_ops=f"{fp_ops:.3e}",
              int32_ops=f"{int_ops:.3e}", bound_ms=f"{bound:.3f}",
              bound_by=k1[case]["bound_by"], of_bound=f"{bound / ms:.4f}",
              issue_slot_ms=f"{issue_ms:.3f}", of_issue_slot=f"{issue_ms / ms:.4f}",
              launches_per_iter_batch=1)
        phase("render", case=case, counting="k1", warp_rounds=counts["rounds"],
              live_lane_rounds=counts["live"], live_vs_ray_bounces=f"{live_rel:.3e}",
              lane_use=f"{counts['lane_use']:.4f}",
              lockstep_lane_use=f"{lockstep_lane_use(paths):.4f}",
              raygen_lane_rounds=counts["raygens"], raygen_share=f"{counts['raygen_share']:.4f}",
              raygen_warp_rounds=counts["raygen_rounds"],
              raygen_round_share=f"{counts['raygen_round_share']:.4f}",
              pixel_fetches=counts["fetches"], fetch_atomics=counts["atomics"],
              pixels_per_atomic=f"{counts['pixels_per_atomic']:.2f}",
              tail_rounds=counts["tail"], tail_share=f"{counts['tail_share']:.4f}",
              counting_build_equal=counts["counting_build_equal"])
        if live_rel >= K1_LIVE_REL or counts["fetches"] != RES * RES \
                or counts["raygens"] != samples:
            raise AssertionError(f"K1's counters disagree with the plain paths ({bounces} "
                                 f"ray-bounces, {samples} samples): {counts}")
        # The sweep: block sizes, and the resident blocks per SM asked.
        sweep = {}
        for threads in K1_BLOCK_SIZES:
            most = lib.k1_blocks_per_sm(threads, meta.num_geoms, len(meta.mega_faces), 0)
            if most < 1:
                raise AssertionError(f"K1's occupancy query failed: {most}")
            for warps in K1_WARPS_PER_SM:
                per_sm = min(max(warps * 32 // threads, 1), most)
                if (threads, per_sm) in sweep:
                    continue
                sweep[threads, per_sm] = time_k1(lambda: megakernel.megakernel_accumulate(
                    dev, meta, opts, acc, 1, PARITY_ITERS, key, record=record, threads=threads,
                    blocks_per_sm=per_sm), acc, repeats=3)
        best = min(sweep, key=sweep.get)
        phase("render", case=case, sweep="k1", best_threads=best[0], best_blocks_per_sm=best[1],
              best_ms=f"{sweep[best]:.3f}",
              **{f"ms_{t}x{b}_warps{t * b // 32}": f"{v:.3f}" for (t, b), v in sweep.items()})
    k1_ms, bound_ms = k1["cornell"]["ms"], k1["cornell"]["bound_ms"]
    for name, u in usage.items():
        phase("render", ptxas=name, **u)
    sass = sass_load_counts()
    kinds = collections.Counter("box" if g.type == int(GeomType.CUBE) else "sphere"
                                for g in meta.geoms if g.type in (int(GeomType.CUBE),
                                                                  int(GeomType.SPHERE)))
    per_bounce = {where: sum(c * sass[where][k] for k, c in kinds.items()) + meta.num_geoms
                  + sass[where]["material"] for where in ("global", "shared")}
    phase("render", sass_loads_per="test", **{f"{where}_{k}": f"{v:g}"
                                             for where in ("global", "shared")
                                             for k, v in sass[where].items()},
          cornell_per_bounce_global=f"{per_bounce['global']:g}",
          cornell_per_bounce_shared=f"{per_bounce['shared']:g}",
          note="per bounce: the geoms' tests, one type read each, one material read")
    phase("render", sass_k1_kernel=sass["k1_kernel"], sass_k1_counting=sass["k1_counting"])

    # ---- mesh_parity -------------------------------------------------------------
    mesh_calls, mesh_max_abs = {}, 0.0
    for name in MESH_SCENES:
        r = Renderer(mesh_scene(name), app_options(), seed=SEED, device=device)
        dev, meta = r.dev, r.meta
        with recording_mesh_queries() as calls:
            render_sample(dev, meta, r.options, 1, r.base_key)
        calls = calls[:2]  # bounce 0: the camera rays; bounce 1: after one shade
        with_tb = any(g.bump > 0 for g in meta.geoms)
        tables = ({"f32": dev.face_ex_t, "oct": dev.face_ex_o}
                  if meta.has_textures else {"f32": dev.face_ex_t})
        for label, q in zip(("bounce0", "bounce1"), calls):
            out_k, _ = q.kernel()
            out_c, visits_k = q.kernel(with_visits=True)  # the counting build
            out_p = q.plain()
            cmp = compare_mesh_outputs(q, out_k, out_p, visits_k)
            same = (out_k == out_p) | (out_k.isnan() & out_p.isnan())
            mesh_max_abs = max(mesh_max_abs, float(torch.where(
                same, 0.0, (out_k - out_p).abs()).nan_to_num(nan=float("inf")).max()))
            # The winner's texcoord and TBN, from each table the query reads,
            # on the lanes whose outputs are bitwise (all but proven
            # box-rounding ones, whose winner differs).
            agree = (out_k.view(torch.int32) == out_p.view(torch.int32)).all(dim=0)
            extras = [(trace._winner_extras(out_k, tab, meta.has_textures, with_tb),
                       trace._winner_extras(out_p, tab, meta.has_textures, with_tb))
                      for tab in tables.values()]
            extras_equal = all(torch.equal(a[agree], b[agree])
                               for ek, ep in extras for a, b in zip(ek, ep))
            counting_equal = bool(torch.equal(out_c.view(torch.int32), out_k.view(torch.int32)))
            phase("mesh_parity", scene=name, batch=label, rays=q.rays.shape[1],
                  live=int((q.rays[6] > 0).sum()), mesh_winners=int((out_k[4] >= 0).sum()),
                  visits=int(visits_k.sum()), tables="/".join(tables),
                  extras_equal=extras_equal, counting_build_equal=counting_equal,
                  **{k: (f"{v:.3e}" if isinstance(v, float) else v) for k, v in cmp.items()})
            if not (cmp["bitwise_but_box_rounding"] and cmp["visits_in_bounds"]
                    and counting_equal and extras_equal):
                raise AssertionError(f"mesh kernel disagrees with its plain version on {name} "
                                     f"{label}: {cmp}, extras_equal={extras_equal}, "
                                     f"counting_build_equal={counting_equal}")
        mesh_calls[name] = calls

    # ---- mesh_render: the mesh main path, counted ----------------------------------
    mesh_launches = {}
    for name in MESH_SCENES:
        r = Renderer(mesh_scene(name), app_options(), seed=SEED, device=device)
        if r.use_megakernel or (r.options.mesh_sort, r.options.winner_table) != ("need", "oct"):
            raise AssertionError(f"{name}: unexpected route or options {r.options}")
        with counting(trace, "mesh_rows_hit") as queries, \
                patched(trace, "mesh_intersect_soa", refuse):
            mh.LAUNCHES = 0
            _build.zero_launches_on_device()
            t = time.perf_counter()
            denoised, beauty = r.render_denoised(iterations=MESH_ITERS, batch=16)
            wall_s = time.perf_counter() - t
            m_launches = _build.launches_on_device("mesh_hit")
        # Every iteration queries the mesh DEPTH times (bounce 0 and each
        # later bounce, live lanes or not), and every query launches the
        # kernel: the launches counted on the card, iteration 1's and the
        # replays', while the host's launches and the query's Python calls
        # (queries) are iteration 1's and the two captures' (iteration 1's
        # graph, then the later iteration's).
        if not (m_launches == MESH_ITERS * DEPTH and queries[0] == mh.LAUNCHES == 3 * DEPTH):
            raise AssertionError(f"{name}: {m_launches} kernel launches on the card over "
                                 f"{MESH_ITERS} iterations, {mh.LAUNCHES} from the host, "
                                 f"{queries[0]} Python calls of the query")
        if not (denoised.shape == (RES, RES, 3) and np.isfinite(denoised).all()
                and np.isfinite(beauty).all() and beauty.mean() > 1e-3
                and 0.0 <= denoised.min() and denoised.max() <= 1.0):
            raise AssertionError(f"{name}: denoised output is not a finite [0,1] image")
        r.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.render(iterations=MESH_ITERS, batch=16)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t
        mesh_launches[name] = m_launches
        phase("mesh_render", scene=name, main_path_s=f"{wall_s:.2f}",
              mesh_launches=m_launches, mesh_queries=queries[0],
              render_s=f"{render_s:.3f}", ms_per_iter=f"{1e3 * render_s / MESH_ITERS:.1f}",
              msamples_per_s=f"{RES * RES * MESH_ITERS / render_s / 1e6:.2f}",
              beauty_mean=f"{beauty.mean():.4f}", denoised_mean=f"{denoised.mean():.4f}")
    # The same 4 iterations through the kernel and through the plain query,
    # then through the kernel with the f32 winner table instead of oct.
    # The plain query selects with boolean masks (host syncs): eager.
    images = []
    for query, table in ((mh.mesh_hit, "auto"), (plain_mesh_hit, "auto"), (mh.mesh_hit, "f32")):
        r = Renderer(mesh_scene("cornellShipTex"), app_options(winner_table=table), seed=SEED,
                     device=device)
        eager = graphs.disabled() if query is plain_mesh_hit else contextlib.nullcontext()
        with patched(trace, "mesh_hit", query), eager:
            images.append(r.render(iterations=MESH_IMAGE_ITERS, batch=MESH_IMAGE_ITERS))
        if (table == "auto") != (r.options.winner_table == "oct"):
            raise AssertionError(f"winner table {r.options.winner_table} for {table!r}")
    img_cmp = compare_images(images[0], images[1])
    phase("mesh_render", check="kernel_vs_plain_query", iterations=MESH_IMAGE_ITERS,
          equal=bool(np.array_equal(images[0], images[1])),
          **{k: f"{v:.3e}" for k, v in img_cmp.items()})
    if img_cmp["rmse_agreeing"] >= PARITY_RMSE or img_cmp["share_gt_1e-2"] >= PARITY_PIXEL_SHARE:
        raise AssertionError(f"kernel and plain-query images disagree: {img_cmp}")
    table_cmp = compare_images(images[0], images[2])  # recorded only: no bar
    phase("mesh_render", check="oct_vs_f32_winner_table", scene="cornellShipTex",
          iterations=MESH_IMAGE_ITERS, equal=bool(np.array_equal(images[0], images[2])),
          **{k: f"{v:.3e}" for k, v in table_cmp.items()})
    if not np.isfinite(images[2]).all():
        raise AssertionError("the f32 winner table's image is not finite")

    # The kernel timed with CUDA events on the main path's own queries.
    mesh_times = {}
    for name in MESH_SCENES:
        for label, q in zip(("bounce0", "bounce1"), mesh_calls[name]):
            mesh_times[name, label] = time_mesh_query(q, scene=name, batch=label)

    # ---- prims: the wavefront's primitive kernel against its plain version ----------
    prims = prims_phase(device)

    # ---- threefry: the wavefront's uniform block against its plain version ----------
    threefry = threefry_phase(device)

    # ---- mesh_profile: where the mesh main path's device time goes ------------------
    r = Renderer(mesh_scene("cornellShipTex"), app_options(), seed=SEED, device=device)
    r.render(iterations=2)  # warm-up: iteration 1 and the capture
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        r.render(iterations=PROFILE_ITERS, batch=PROFILE_ITERS)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    mesh_ms = sum(e.self_device_time_total for e in on_card if "mesh_hit" in e.key) / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
    phase("mesh_profile", scene="cornellShipTex", iterations=PROFILE_ITERS,
          wall_ms_per_iter=f"{prof_wall_ms / PROFILE_ITERS:.1f}",
          device_busy_ms_per_iter=f"{busy_ms / PROFILE_ITERS:.1f}",
          device_busy_share=f"{busy_ms / prof_wall_ms:.3f}",
          mesh_kernel_ms_per_iter=f"{mesh_ms / PROFILE_ITERS:.2f}",
          kernels_per_iter=sum(e.count for e in on_card) // PROFILE_ITERS)
    for e in top:
        print(f"    device {e.self_device_time_total / 1e3 / PROFILE_ITERS:9.3f} ms/iter "
              f"x{e.count // PROFILE_ITERS:6d}  {e.key[:90]}", flush=True)

    # ---- options: the wavefront's render options and the Renderer surface ---------
    options_phase(device)

    # ---- graph: the Renderer's CUDA graphs against its eager route ----------------
    graph_phase(device)

    # ---- prng: K6 against its plain version ----------------------------------------
    n = RES * RES
    k6_max_abs = 0.0
    for seed in PRNG_SEEDS:
        for k in (4, num_rng_streams(DEPTH)):
            got = prng.pallas_uniforms(seed, k, n, device)
            want = prng.uniforms_reference(seed, k, n, device)
            k6_max_abs = max(k6_max_abs, float((got - want).abs().max()))
            scaled = got.double() * 2**24
            m = got.numel()
            mean, var = float(got.double().mean()), float(got.double().var())
            ok = (bool(torch.equal(got, want)) and float(got.min()) >= 0.0
                  and float(got.max()) < 1.0 and bool(torch.equal(scaled, scaled.round()))
                  and abs(mean - 0.5) < 5 * (1 / 12 / m) ** 0.5
                  and abs(var - 1 / 12) < 5 * ((1 / 80 - 1 / 144) / m) ** 0.5)
            phase("prng", seed=seed, shape=f"{k}x{n}", bitwise=bool(torch.equal(got, want)),
                  mean=f"{mean:.6f}", var=f"{var:.6f}")
            if not ok:
                raise AssertionError(f"K6 at seed {seed}, [{k}, {n}] disagrees with its plain "
                                     "version or is not U[0,1) on the 2^-24 grid")
    k6 = {}
    for k in (4, num_rng_streams(DEPTH)):
        run_k6 = lambda: prng.pallas_uniforms(PRNG_SEEDS[1], k, n, device)
        rand = lambda: torch.rand(k, n, device=device)
        run_k6(), rand()  # warm-up
        # In turns (K6, torch.rand, torch.rand, K6), three yardsticks: one
        # call at a time, timed alone with CUDA events, the wrapper's host
        # cost included (the kernels line's "ms" and "library_ms", as in
        # earlier runs); the rate of a burst of back-to-back calls; the
        # device time of calls queued behind other work (the kernel alone).
        times = {}
        for who, fn in (("k6", run_k6), ("rand", rand), ("rand", rand), ("k6", run_k6)):
            times.setdefault((who, "one"), []).append(
                float(np.median([cuda_ms(fn) for _ in range(7)])))
            times.setdefault((who, "burst"), []).append(burst_ms(fn, repeats=3))
            times.setdefault((who, "device"), []).append(queued_ms(fn, repeats=3))
        med = {key: float(np.median(v)) for key, v in times.items()}
        span = {key: f"{min(v):.5f}-{max(v):.5f}" for key, v in times.items()}
        ms, rand_ms = med["k6", "one"], med["rand", "one"]
        dev_ms, rand_dev_ms = med["k6", "device"], med["rand", "device"]
        if k == 4:  # where the host cost decides: K6's wrapper, piece by piece
            buf = torch.empty((k, n), device=device)
            handle, k6_c = _build.stream_handle(buf.device), _build.library().k6_uniforms
            pieces = {"torch_rand": rand, "k6_wrapper": run_k6,
                      "torch_empty": lambda: torch.empty((k, n), dtype=torch.float32, device=device),
                      "stream_handle": lambda: _build.stream_handle(buf.device),
                      "c_launch": lambda: k6_c(PRNG_SEEDS[1], buf.data_ptr(), k, n, 0, 0, 0, None,
                                               handle)}
            host = {name: [] for name in pieces}
            for _ in range(2):
                for name, fn in pieces.items():
                    host[name].append(host_us(fn))
            phase("prng", shape=f"{k}x{n}", **{f"host_us_{name}": f"{min(v):.2f}-{max(v):.2f}"
                                               for name, v in host.items()})
        plain = lambda: prng.uniforms_reference(PRNG_SEEDS[1], k, n, device)
        plain()
        plain_ms = cuda_ms(plain)
        int_ops = -(-k // 4) * n * SASS["philox_int_per_call"]  # one Philox call per 4 rows
        t_int = int_ops / INT32_OPS_PER_S
        t_bytes = 4 * k * n / HBM_BYTES_PER_S
        k6[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=rand_ms,
                     bound_ms=1e3 * max(t_int, t_bytes),
                     bound_by="operations" if t_int >= t_bytes else "bytes")
        phase("prng", shape=f"{k}x{n}", k6_one_call_ms=f"{ms:.5f}",
              k6_one_call_spread=span["k6", "one"], torch_rand_one_call_ms=f"{rand_ms:.5f}",
              torch_rand_one_call_spread=span["rand", "one"], vs_torch_rand=f"{ms / rand_ms:.3f}",
              k6_burst_ms=f"{med['k6', 'burst']:.5f}", k6_burst_spread=span["k6", "burst"],
              torch_rand_burst_ms=f"{med['rand', 'burst']:.5f}",
              torch_rand_burst_spread=span["rand", "burst"],
              burst_vs_torch_rand=f"{med['k6', 'burst'] / med['rand', 'burst']:.3f}",
              k6_device_ms=f"{dev_ms:.5f}", k6_device_spread=span["k6", "device"],
              torch_rand_device_ms=f"{rand_dev_ms:.5f}",
              torch_rand_device_spread=span["rand", "device"],
              device_vs_torch_rand=f"{dev_ms / rand_dev_ms:.3f}",
              plain_ms=f"{plain_ms:.2f}", int32_ops=f"{int_ops:.3e}", bytes=4 * k * n,
              bound_ms=f"{k6[k]['bound_ms']:.5f}", bound_by=k6[k]["bound_by"],
              of_bound=f"{k6[k]['bound_ms'] / ms:.3f}",
              device_of_bound=f"{k6[k]['bound_ms'] / dev_ms:.3f}")

    # ---- k5_parity: K5 against its plain version on the main path's inputs ------------
    k5_parity = {}
    for name in ("cornellShip", "shipOnly"):
        for mode in ("threefry", "auto"):
            opts = RenderOptions(megakernel=True, bounce_megakernel=True, rng=mode)
            rp = Renderer(mesh_scene(name), opts, seed=SEED, device=device)
            if not (rp.use_megakernel and megakernel._uses_bvh(rp.meta)):
                raise AssertionError(f"Renderer did not route {name} to K5")
            acc_k = torch.zeros((9, n), device=device)
            acc_p = torch.zeros((9, n), device=device)
            megakernel.bvh_bounce_accumulate(rp.dev, rp.meta, opts, acc_k, 1, K5_PARITY_ITERS,
                                             rp.base_key, record=rp.record)
            torch.cuda.synchronize()
            plain_ms = cuda_ms(lambda: megakernel.bvh_bounce_accumulate_reference(
                rp.dev, rp.meta, opts, acc_p, 1, K5_PARITY_ITERS, rp.base_key))
            to_img = lambda rows: rows.reshape(3, RES, RES).permute(1, 2, 0).cpu().numpy()
            mean_k = to_img(acc_k[0:3]) / K5_PARITY_ITERS
            mean_p = to_img(acc_p[0:3]) / K5_PARITY_ITERS
            if not (np.isfinite(mean_k).all() and mean_k.mean() > 1e-3):
                raise AssertionError(f"K5 image of {name} is not finite or is black")
            cmp = compare_images(mean_k, mean_p)
            albedo = compare_images(to_img(acc_k[3:6]), to_img(acc_p[3:6]))
            normal = compare_images(to_img(acc_k[6:9]), to_img(acc_p[6:9]))
            phase("k5_parity", scene=name, rng=mode, res=RES, iterations=K5_PARITY_ITERS,
                  **{k: f"{v:.3e}" for k, v in cmp.items()},
                  equal=bool(np.array_equal(mean_k, mean_p)),
                  aov_max_abs=f"{max(albedo['max_abs'], normal['max_abs']):.3e}",
                  albedo_share_gt_1e_2=f"{albedo['share_gt_1e-2']:.3e}",
                  normal_share_gt_1e_2=f"{normal['share_gt_1e-2']:.3e}",
                  plain_ms_per_iter=f"{plain_ms / K5_PARITY_ITERS:.1f}")
            if cmp["rmse_agreeing"] >= PARITY_RMSE or cmp["share_gt_1e-2"] >= PARITY_PIXEL_SHARE \
                    or albedo["share_gt_1e-2"] >= PARITY_PIXEL_SHARE \
                    or normal["share_gt_1e-2"] >= PARITY_PIXEL_SHARE:
                raise AssertionError(f"K5 disagrees with its plain version on {name} {mode}: "
                                     f"{cmp}, albedo {albedo}, normal {normal}")
            k5_parity[name, mode] = dict(cmp, plain_ms=plain_ms / K5_PARITY_ITERS)

    # ---- bounce_render: the K5 main path, counted ------------------------------------
    bounce_options = RenderOptions(megakernel=True, bounce_megakernel=True, rng="auto")
    r = Renderer(mesh_scene("cornellShip"), bounce_options, seed=SEED, device=device)
    if not (r.use_megakernel and megakernel._uses_bvh(r.meta)):
        raise AssertionError("Renderer did not route cornellShip to K5")
    with patched(trace, "mesh_intersect_soa", refuse):
        _build.zero_launches_on_device()
        t = time.perf_counter()
        denoised, beauty = r.render_denoised(iterations=BOUNCE_ITERS, batch=16)
        wall_s = time.perf_counter() - t
        # counted on the card: iteration 1's launches and the replays'
        k5_launches, k6_launches = (_build.launches_on_device(k) for k in ("k5", "k6"))
    if not k5_launches == k6_launches == BOUNCE_ITERS:
        raise AssertionError(f"the K5 path launched K5 {k5_launches} and K6 {k6_launches} times "
                             f"over {BOUNCE_ITERS} iterations")
    if not (denoised.shape == (RES, RES, 3) and np.isfinite(denoised).all()
            and np.isfinite(beauty).all() and beauty.mean() > 1e-3
            and 0.0 <= denoised.min() and denoised.max() <= 1.0):
        raise AssertionError("cornellShip through K5: denoised output is not a finite [0,1] image")
    r.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r.render(iterations=BOUNCE_ITERS, batch=16)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    phase("bounce_render", scene="cornellShip", main_path_s=f"{wall_s:.2f}",
          k5_launches=k5_launches, k6_launches=k6_launches, render_s=f"{render_s:.3f}",
          ms_per_iter=f"{1e3 * render_s / BOUNCE_ITERS:.2f}",
          msamples_per_s=f"{RES * RES * BOUNCE_ITERS / render_s / 1e6:.2f}",
          beauty_mean=f"{beauty.mean():.4f}", denoised_mean=f"{denoised.mean():.4f}")

    # K5 alone, timed with CUDA events on the main path's own rays.
    dev, meta, record = r.dev, r.meta, r.record
    all_rays = []
    for it in range(1, BOUNCE_ITERS + 1):
        ikey = rng.iteration_key(r.base_key, it)
        U = prng.iteration_uniforms(bounce_options, ikey, it, 4, n, device)
        o, d = generate_camera_rays(dev.camera, meta.resolution, bounce_options, U)
        all_rays.append((it, ikey, torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])))
    # One counting pass: clusters tested per ray, tree nodes, warp traversal
    # iterations, warp bounce rounds, lanes of ended paths over those rounds.
    acc = torch.zeros((9, n), device=device)
    visits = torch.zeros(n, dtype=torch.int32, device=device)
    stats = torch.zeros(megakernel.STATS, dtype=torch.int64, device=device)
    for it, ikey, rays in all_rays:
        megakernel.bounce_launch(dev, meta, bounce_options, acc, rays, it, ikey, record, visits,
                                 stats)
    run_k5 = lambda: [megakernel.bounce_launch(dev, meta, bounce_options, acc, rays, it, ikey,
                                               record) for it, ikey, rays in all_rays]
    # The WORDS build, as the graph route launches it (its one-thread words
    # kernel included), on the same rays, in turns with the by-value build.
    counted = [torch.tensor(it, dtype=torch.int64, device=device) for it, _, _ in all_rays]
    run_words = lambda: [megakernel.bounce_launch(dev, meta, bounce_options, acc, rays, c, None,
                                                  record, base_key=r.base_key)
                         for c, (_, _, rays) in zip(counted, all_rays)]
    run_k5(), run_words()  # warm-up
    turns = [(cuda_ms(run_k5), cuda_ms(run_words)) for _ in range(3)]
    k5_ms = float(np.median([a for a, _ in turns])) / BOUNCE_ITERS
    k5_words_ms = float(np.median([b for _, b in turns])) / BOUNCE_ITERS
    k5_plain_ms = k5_parity["cornellShip", "auto"]["plain_ms"]  # per iteration, the same inputs
    bounces, philox_calls, necessary, _ = ray_bounces(dev, meta, bounce_options,
                                                      range(1, BOUNCE_ITERS + 1))
    fp_k1, _ = k1_ops(meta, bounce_options, 0, bounces)  # raygen runs outside K5
    cluster_visits = int(visits.sum())
    nodes, walk_iters, rounds, ended = stats.tolist()
    int_ops = philox_calls * SASS["philox_int_per_call"]  # rng "auto": K6's stream in-kernel
    k5_bytes = BOUNCE_ITERS * 4 * (6 * n + 2 * 9 * n + record.numel() + dev.face_gather.numel()
                                   + dev.cluster_tree.numel())
    t_bytes = k5_bytes / HBM_BYTES_PER_S

    def k5_bound(face_visits):
        """(ms per launch, what bounds it, FP32 ops) with the face tests of
        ``face_visits`` cluster visits over the 16 launches."""
        fp = fp_k1 + float(face_visits) * 128 * FP_OPS_FACE_TEST
        t_ops = max(fp / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
        return (1e3 * max(t_ops, t_bytes) / BOUNCE_ITERS,
                "operations" if t_ops >= t_bytes else "bytes", fp)

    # The kernels line takes the necessary-visit bound, which no walk's order
    # moves; K5's own-visit bound is printed beside it.
    k5_bound_ms, k5_bound_by, fp_ops = k5_bound(necessary)
    own_bound_ms, _, own_fp_ops = k5_bound(cluster_visits)
    phase("bounce_render", k5_ms_per_launch=f"{k5_ms:.3f}",
          k5_words_ms_per_launch=f"{k5_words_ms:.3f}", plain_ms_per_iter=f"{k5_plain_ms:.1f}",
          ray_bounces=bounces,
          bounces_per_sample=f"{bounces / (n * BOUNCE_ITERS):.3f}", cluster_visits=cluster_visits,
          visits_per_ray_bounce=f"{cluster_visits / max(bounces, 1):.3f}",
          necessary_visits=necessary,
          necessary_per_ray_bounce=f"{necessary / max(bounces, 1):.3f}",
          tree_nodes=nodes, nodes_per_ray_bounce=f"{nodes / max(bounces, 1):.3f}",
          warp_walk_iterations=walk_iters, walk_lane_use=f"{nodes / max(32 * walk_iters, 1):.4f}",
          warp_bounce_rounds=rounds, ended_lanes=ended,
          ended_lane_share=f"{ended / max(32 * rounds, 1):.4f}",
          live_lane_rounds=32 * rounds - ended,
          philox_calls=philox_calls, draws=3 * bounces,
          int32_per_draw=f"{int_ops / max(3 * bounces, 1):.2f}",
          fp32_ops=f"{fp_ops:.3e}", own_visit_fp32_ops=f"{own_fp_ops:.3e}",
          int32_ops=f"{int_ops:.3e}", bytes=k5_bytes,
          bound_ms_per_launch=f"{k5_bound_ms:.4f}", bound_by=k5_bound_by,
          of_bound=f"{k5_bound_ms / k5_ms:.4f}",
          own_visit_bound_ms_per_launch=f"{own_bound_ms:.4f}",
          own_visit_of_bound=f"{own_bound_ms / k5_ms:.4f}")
    if not (0 < cluster_visits <= nodes <= 32 * walk_iters and 0 <= ended < 32 * rounds
            and 32 * rounds - ended >= n * BOUNCE_ITERS):
        raise AssertionError(f"K5's counters disagree: {cluster_visits} visits, {stats.tolist()}")

    # Where the K5 path's device time goes: two iterations under the profiler
    # (replays of the graph that the warm-up captures).
    r.reset()
    r.render(iterations=1 + PROFILE_ITERS, batch=1 + PROFILE_ITERS)  # warm-up
    r.reset()
    r.render(iterations=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        r.render(iterations=PROFILE_ITERS, batch=PROFILE_ITERS)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    k5_prof_ms = sum(e.self_device_time_total for e in on_card if "k5_kernel" in e.key) / 1e3
    phase("bounce_profile", scene="cornellShip", iterations=PROFILE_ITERS,
          wall_ms_per_iter=f"{prof_wall_ms / PROFILE_ITERS:.2f}",
          device_busy_ms_per_iter=f"{busy_ms / PROFILE_ITERS:.2f}",
          device_busy_share=f"{busy_ms / prof_wall_ms:.3f}",
          k5_ms_per_iter=f"{k5_prof_ms / PROFILE_ITERS:.2f}",
          kernels_per_iter=sum(e.count for e in on_card) // PROFILE_ITERS)
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:4]:
        print(f"    device {e.self_device_time_total / 1e3 / PROFILE_ITERS:9.3f} ms/iter "
              f"x{e.count // PROFILE_ITERS:6d}  {e.key[:90]}", flush=True)

    # The same 4 iterations through K5 and through the wavefront (mesh kernel, same rng).
    images = []
    for opts in (bounce_options, app_options(rng="auto")):
        rr = Renderer(mesh_scene("cornellShip"), opts, seed=SEED, device=device)
        if rr.use_megakernel != (opts is bounce_options):
            raise AssertionError(f"unexpected route for {opts}")
        images.append(rr.render(iterations=BOUNCE_IMAGE_ITERS, batch=BOUNCE_IMAGE_ITERS))
    bounce_cmp = compare_images(*images)
    phase("bounce_render", check="k5_vs_wavefront", iterations=BOUNCE_IMAGE_ITERS,
          equal=bool(np.array_equal(*images)), **{k: f"{v:.3e}" for k, v in bounce_cmp.items()})
    if bounce_cmp["rmse_agreeing"] >= PARITY_RMSE \
            or bounce_cmp["share_gt_1e-2"] >= PARITY_PIXEL_SHARE:
        raise AssertionError(f"K5 and wavefront images disagree: {bounce_cmp}")

    # ---- denoise ----------------------------------------------------------------
    net, random_weights = load_denoiser("rt_ldr_alb", device)
    if random_weights:
        raise AssertionError("weights/rt_ldr_alb.tza did not load")
    net16 = copy.deepcopy(net).to(torch.bfloat16)  # the card's number format (net_dtype)
    acc_args = (renderer.acc[0:3], renderer.acc[3:6], renderer.iteration)
    bf16 = denoise_accumulator(*acc_args, net16, (RES, RES))
    f32 = denoise_accumulator(*acc_args, net, (RES, RES), dtype=torch.float32)
    denoise_ms = cuda_ms(lambda: denoise_accumulator(*acc_args, net16, (RES, RES)), repeats=3)
    denoise_f32_ms = cuda_ms(
        lambda: denoise_accumulator(*acc_args, net, (RES, RES), dtype=torch.float32), repeats=3)
    diff = (bf16 - f32).abs()
    x = torch.from_numpy(np.random.default_rng(SEED).random((1, 6, 64, 64), np.float32))
    with torch.inference_mode():
        ref = load_denoiser("rt_ldr_alb", "cpu")[0](x)
    with torch.inference_mode(), no_tf32():
        on_card = net(x.to(device)).cpu()
    rel = float(((on_card - ref).abs() / ref.abs().clamp_min(1e-3)).max())
    phase("denoise", bf16_ms=f"{denoise_ms:.2f}", f32_ms=f"{denoise_f32_ms:.2f}",
          bf16_vs_f32_max_abs=f"{float(diff.max()):.3e}",
          bf16_vs_f32_mean_abs=f"{float(diff.mean()):.3e}", f32_card_vs_cpu_max_rel=f"{rel:.3e}")
    if not (float(diff.mean()) < DENOISE_BF16_MEAN_ABS and float(diff.max()) < DENOISE_BF16_MAX_ABS
            and rel < UNET_F32_MAX_REL and torch.isfinite(bf16).all()):
        raise AssertionError("denoiser outputs disagree beyond the stated tolerances")

    # ---- filter: the OIDN-style Filter API on the card ------------------------------------
    fdev = Device()
    fdev.commit()
    filter_phase(fdev, renderer.beauty(), renderer.albedo_image(), bf16)

    # ---- app ------------------------------------------------------------------------
    app_runs = (("cornell", 32, ()), ("scenes/cornellShipTex.txt", 4, ()),
                ("scenes/cornellShipTex.txt", 2,
                 ("--no-antialias", "--sort-by-material", "--save-normal")))
    for scene_arg, iters, flags in app_runs:
        with tempfile.TemporaryDirectory() as out_dir:
            proc = subprocess.run(
                [sys.executable, "-m", "mygpuraytracer_tpu_torch.apps.raytrace", scene_arg,
                 "--resolution", str(RES), str(RES), "--iterations", str(iters),
                 "--depth", str(DEPTH), "--out-dir", out_dir, *flags],
                capture_output=True, text=True, timeout=600, cwd=HERE)
            pngs = sorted(os.listdir(out_dir))
            tail = proc.stdout.strip().splitlines()[-3:]
            phase("app", scene=scene_arg, flags=",".join(flags) or "none", rc=proc.returncode,
                  pngs=len(pngs), out=repr(" | ".join(tail)))
            if proc.returncode != 0:
                raise AssertionError(f"app failed:\n{proc.stdout}\n{proc.stderr}")
            if not re.search(r"^Denoise: device=[\d.]+ms filter=[\d.]+ms exec=[\d.]+ms$",
                             proc.stdout, re.M):
                raise AssertionError(f"app did not denoise through the Filter:\n{proc.stdout}")
            suffixes = ("samp.png", "albedo.png", "input.png", "output.png")
            if "--save-normal" in flags:
                suffixes += ("normal.png",)
            for suffix in suffixes:
                if sum(p.endswith(suffix) for p in pngs) != 1:
                    raise AssertionError(f"app did not write one *{suffix}: {pngs}")
            if len(pngs) != len(suffixes):
                raise AssertionError(f"app wrote {len(pngs)} PNGs, not {len(suffixes)}: {pngs}")

    # ---- train: the denoiser's training toolkit on the card --------------------------
    train_phase(device)

    # ---- multichip, preview, bench ----------------------------------------------------
    multichip_phase(device)
    preview_phase(device)
    bench_phase()

    kernels = [{
        "name": "k1_megakernel",
        "route": "cuda",
        "source": "mygpuraytracer_tpu_torch/csrc/megakernel.cu",
        "replaces": "mygpuraytracer_tpu/render/megakernel.py:82",
        "launches": k1_launches,
        "max_abs_err": parity["cornell"]["max_abs"],
        "ms": k1_ms,
        "plain_ms": parity["cornell"]["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": k1["cornell"]["bound_by"],
        "library_ms": None,
        "design": "redesigned: persistent lanes with a warp-aggregated pixel queue, a new path "
                  "as soon as one ends, the scene record in shared memory; a pixel range per "
                  "launch (the pixel-sharded render); times of whole-image launches",
    }]
    main_time = mesh_times["cornellShipTex", "bounce1"]
    kernels.append({
        "name": "k2_k3_k4_mesh_hit",
        "route": "cuda",
        "source": "mygpuraytracer_tpu_torch/csrc/mesh_hit.cu",
        "replaces": "mygpuraytracer_tpu/ops/trace.py:1109 (K2 rows), :967 (K3 lists), "
                    ":427 (K4 conds): three TPU schedules of one query",
        "launches": mesh_launches["cornellShipTex"],
        "max_abs_err": mesh_max_abs,
        "ms": main_time["ms"],
        "plain_ms": main_time["plain_ms"],
        "bound_ms": main_time["bound_ms"],
        "bound_by": main_time["bound_by"],
        "library_ms": None,
        "design": "redesigned: per-ray cluster-tree walk, warp-tested leaves (csrc/mesh.cuh)",
    })
    kernels.append({
        "name": "prims_hit",
        "route": "cuda",
        "source": "mygpuraytracer_tpu_torch/csrc/prims_hit.cu",
        "replaces": "none: plain jnp in the JAX package (ops/trace.py intersect_primitives_soa)",
        "launches": prims["launches"],
        "max_abs_err": 0.0,
        **{key_: prims[key_] for key_ in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "design": "one thread a lane over the scene's cube and sphere table, the plain "
                  "version's roundings (_rn intrinsics, IEEE division and sqrt, rsqrtf); "
                  "times per launch at 640,000 lanes, means over one iteration's 8 bounces; "
                  "launches over 4 graph-replayed iterations of the main path",
    })
    kernels.append({
        "name": "threefry_uniforms",
        "route": "cuda",
        "source": "mygpuraytracer_tpu_torch/csrc/prng.cu",
        "replaces": "none: jax.random.uniform in the JAX package (ops/rng.py uniform)",
        "launches": threefry["launches"],
        "max_abs_err": 0.0,
        **{key_: threefry[key_] for key_ in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "design": "one thread a column looping over the rows, coalesced row stores, the key "
                  "by value or fold_in(base, iteration) read from device memory; times per "
                  "launch at [28, 640000]; launches over 4 graph-replayed iterations of the "
                  "main path",
    })
    kernels.append({
        "name": "k5_bounce",
        "route": "cuda",
        "source": "mygpuraytracer_tpu_torch/csrc/bounce.cu",
        "replaces": "mygpuraytracer_tpu/render/megakernel.py:355",
        "launches": k5_launches,
        "max_abs_err": k5_parity["cornellShip", "auto"]["max_abs"],
        "ms": k5_ms,
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound_ms,
        "bound_by": k5_bound_by,
        "library_ms": None,
        "design": "per-ray cluster-tree walk, warp-tested leaves; a pixel range per launch (the "
                  "pixel-sharded render); in the Renderer's graph its words from device memory "
                  "(WORDS build); times of whole-image by-value launches",
    })
    kernels.append({
        "name": "k6_uniforms",
        "route": "cuda",
        "source": "mygpuraytracer_tpu_torch/csrc/prng.cu",
        "replaces": "mygpuraytracer_tpu/ops/prng.py:28",
        "launches": k6_launches,
        "max_abs_err": k6_max_abs,
        **{key_: k6[4][key_] for key_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(ab_main(sys.argv[2:]) if sys.argv[1:2] == ["--ab"] else main())
