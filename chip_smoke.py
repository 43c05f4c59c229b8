"""End-to-end check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three main paths (mygpuraytracer_tpu_torch) on the card
at 800x800, depth 8: the builtin Cornell box through the K1 CUDA kernel;
the 23,328-face spaceship in the Cornell box, textured and bump-mapped
(scenes/cornellShipTex.txt) and plain (scenes/cornellShip.txt), through the
wavefront and the mesh tiers' CUDA kernel (K2/K3/K4); and cornellShip
through the bounce megakernel K5 with the K6 uniforms for its raygen; all
denoised with the U-Net. Phases, each printing one line with its elapsed
seconds:

1. device      -- the card's name and power limit (nvidia-smi); fails without CUDA
2. build       -- one nvcc per csrc/*.cu, in parallel, into the gitignored build dir
3. k1_parity   -- K1 against its plain PyTorch version on cornell and
                  cornellGlass (800x800, depth 8, 16 iterations, same seed)
4. render      -- K1's main path: Renderer.render_denoised, launch counts
                  read around it; then K1 timed with CUDA events
5. mesh_parity -- the mesh kernel against its plain version on the bounce-0
                  and bounce-1 queries of cornellShip and cornellShipTex,
                  under each tier name and winner table
6. mesh_render -- the mesh main path: render_denoised of cornellShipTex and
                  cornellShip with the kernel's launches counted, the lists
                  and conds tiers likewise, kernel against plain-tier images;
                  then the kernel timed with CUDA events (mesh_time) and two
                  iterations under torch.profiler (mesh_profile): device busy
                  share and the kernels that take the device time
7. prng        -- K6 against its plain version bit for bit at [4, N] and
                  [28, N] for three seeds; its values on the 2^-24 grid with
                  U[0,1)'s mean and variance; K6 timed beside torch.rand
8. k5_parity   -- K5 against its plain version (the wavefront over the plain
                  walk) on the main path's inputs: cornellShip and the
                  open-sky shipOnly at 800x800, depth 8, seed 0, its first 2
                  iterations, under rng "threefry" and "auto"
9. bounce_render -- the K5 main path: Renderer(megakernel, bounce_megakernel,
                  rng="auto").render_denoised of cornellShip with the K5 and
                  K6 launches counted; K5 timed per launch with its bound;
                  two iterations under torch.profiler; its image against the
                  wavefront's (mesh kernel, same rng) over 4 iterations
10. denoise    -- the fused denoise (bf16 net) against the float32 net on the
                  card, and the float32 net on the card against the CPU
11. app        -- `python -m mygpuraytracer_tpu_torch.apps.raytrace` in a
                  subprocess on cornell and on cornellShipTex, each writing
                  its four PNGs into a temporary directory

It prints a JSON line of per-kernel numbers and, last, one JSON object
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import mygpuraytracer_tpu_torch as port
from mygpuraytracer_tpu_torch import _build
from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.denoise.unet import no_tf32
from mygpuraytracer_tpu_torch.ops import mesh_hit as mh
from mygpuraytracer_tpu_torch.ops import prng, rng, trace
from mygpuraytracer_tpu_torch.ops.trace import intersect_soa
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import Renderer, megakernel
from mygpuraytracer_tpu_torch.render.camera import generate_camera_rays
from mygpuraytracer_tpu_torch.render.denoise_fused import denoise_accumulator, load_denoiser
from mygpuraytracer_tpu_torch.render.pathtrace import num_rng_streams, render_sample
from mygpuraytracer_tpu_torch.render.shade import PathStateSoA, shade_soa
from mygpuraytracer_tpu_torch.scene import load_scene
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box, cornell_glass
from mygpuraytracer_tpu_torch.scene.device_scene import build_device_scene
from mygpuraytracer_tpu_torch.scene.structs import GeomType

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

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, FP32 67 TFLOP/s
# outside the tensor cores. INT32: 64 lanes per SM against 128 FP32 lanes
# (Hopper white paper), so half the FP32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
# Operations per unit of K1 work, counted from csrc/megakernel.cu (one
# arithmetic, compare or select instruction = 1; sqrt, rsqrt and a division
# = 1; sinf/cosf/powf = 20 each, their polynomial length).
INT_OPS_PER_DRAW = 122  # threefry2x32: 20 x (add, 2 shifts, or, xor) + 6 key adds x 2 + counter and bits
FP_OPS_PER_DRAW = 1
FP_OPS_RAYGEN = 28
FP_OPS_DOF = 75
FP_OPS_BOX = 140
FP_OPS_SPHERE = 120
FP_OPS_FACE = 40
FP_OPS_SHADE = 120  # diffuse bounce: cosine hemisphere (2 sqrt, sin, cos, 2 normalized crosses)
# The mesh kernel, counted from csrc/mesh_hit.cu: a face test is A and B (2
# dot products, 10), B's clamp (3), t (2), u and v (2 x (2 dots + 3) = 26)
# and the accept test (6 compares or adds + 4 ands) = 51. The bound counts
# face tests only; a cluster's slab test (6 subtracts, 6 multiplies, 10
# min/max, 3 compares and an and = 26) is this design's own schedule, and
# its cost for the live rays is printed beside the bound, not in it.
FP_OPS_FACE_TEST = 51
FP_OPS_SLAB = 26
# K6 against its plain version: bit for bit (integer arithmetic and one
# exact conversion). Its values: on the 2^-24 grid in [0, 1), mean and
# variance within 5 sigma of U[0,1)'s.
PRNG_SEEDS = (0, 1234567, -(2**31))
# K5 against its plain version: K1's bars (PARITY_RMSE, PARITY_PIXEL_SHARE)
# on the mean over the main path's first K5_PARITY_ITERS iterations, at its
# 800x800. Besides K1's rounding (FMA contraction, rsqrt) the walk visits
# clusters near to far where the plain version goes in ascending id, so
# among faces at exactly equal t another may win. The plain walk syncs the
# host once per cluster and bounce (~3 s per 800x800 iteration on an H100),
# so its cost grows with iterations, not pixels.
K5_PARITY_ITERS = 2
BOUNCE_ITERS = 16  # the K5 main path: one render_denoised of 16 iterations
BOUNCE_IMAGE_ITERS = 4  # K5 against the wavefront, image of 4 iterations
MESH_SCENES = ("cornellShipTex", "cornellShip")
MESH_ITERS = 16  # the main path: one render_denoised of 16 iterations
MESH_TIER_ITERS = 2  # the lists and conds tiers' own main-path runs
MESH_IMAGE_ITERS = 4  # kernel against plain tier, image of 4 iterations
PROFILE_ITERS = 2  # iterations under torch.profiler

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))


def phase(name: str, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{time.perf_counter() - T0:8.2f}s] {name} {extra}", flush=True)


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


def ray_bounces(dev, meta, options, iterations) -> int:
    """Ray-bounces (one nearest-hit test + one shade of a live path) that
    ``iterations`` of this scene execute under ``options.rng``: the
    data-dependent work K1 and K5 do."""
    n = meta.resolution[0] * meta.resolution[1]
    key = rng.make_key(SEED)
    total = 0
    for it in iterations:
        U = prng.iteration_uniforms(options, rng.iteration_key(key, it), it,
                                    num_rng_streams(meta.trace_depth), n,
                                    dev.camera.position.device)
        o, d = generate_camera_rays(dev.camera, meta.resolution, options, U)
        ones = torch.ones(n, device=o.x.device)
        s = PathStateSoA(o, d, Vec3(ones, ones, ones),
                         torch.full((n,), meta.trace_depth, dtype=torch.int32, device=o.x.device))
        for b in range(meta.trace_depth):
            alive = int((s.remaining > 0).sum())
            if alive == 0:
                break
            total += alive
            h = intersect_soa(meta, dev, s.origin, s.direction)
            s = shade_soa(meta, dev, s, h, U[4 + 3 * b], U[5 + 3 * b], U[6 + 3 * b])
    return total


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
    integer = INT_OPS_PER_DRAW * (samples * draws_per_sample + 3 * bounces)
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

    def record(fp, bounds, rays, with_visits=False):
        if len(calls) < keep:
            calls.append((fp, bounds, rays.clone()))
        return orig(fp, bounds, rays, with_visits)

    with patched(trace, "mesh_hit", record):
        yield calls


def refuse(*args, **kwargs):
    raise AssertionError("the chunked Moller-Trumbore stream ran on the mesh main path")


def mesh_scene(name: str):
    scene = load_scene(os.path.join(HERE, "scenes", f"{name}.txt"))
    scene.set_resolution(RES, RES)
    scene.state.trace_depth = DEPTH
    return scene


def app_options(**changes) -> RenderOptions:
    """The options the app builds on CUDA with its default flags."""
    return dataclasses.replace(RenderOptions(megakernel=True, mesh_tier="rows", mesh_sort=None,
                                             winner_table="auto"), **changes)


def compare_mesh_outputs(out_k, out_p, visits_k, visits_p) -> dict:
    """Kernel outputs against the plain version's, per lane."""
    hit_k, hit_p = out_k[4] >= 0, out_p[4] >= 0
    both = hit_k & hit_p
    rel = ((out_k[0] - out_p[0]).abs() / out_p[0].abs())[both]
    return {
        "hit_miss_share": float((hit_k != hit_p).float().mean()),
        "t_max_rel": float(rel.max()) if rel.numel() else 0.0,
        "gid_share": float((out_k[4] != out_p[4]).float().mean()),
        "fid_share": float((out_k[7] != out_p[7]).float().mean()),
        "uv_share": float(((out_k[5] != out_p[5]) | (out_k[6] != out_p[6])).float().mean()),
        "bitwise": bool(torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))),
        "visits_equal": bool(torch.equal(visits_k, visits_p)),
    }


def mesh_bound(fp, bounds, rays, visits) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, FP32 ops, bytes) of one mesh query: the
    face tests of the clusters its rays visit (sum of visits x 128 x
    FP_OPS_FACE_TEST), against each input read once and the [8, N] output
    written once."""
    ops = float(visits.sum()) * 128 * FP_OPS_FACE_TEST
    nbytes = 4 * (rays.numel() + fp.numel() + bounds.numel() + mh.OUT_ROWS * rays.shape[1])
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def block_visits(meta, rays, tile: int = 128, rows_per_chunk: int = 512) -> int:
    """(128-ray block, cluster) pairs in which some ray of the block can
    reach the cluster before its t_cap (``ops/trace.py::_cluster_visit_lists``,
    the TPU rows tier's schedule): an upper bound on the blocks' visits in
    the kernel, which prunes with each ray's running best."""
    pad = (-rays.shape[1]) % tile
    fill = torch.tensor([1e7, 1e7, 1e7, 1.0, 0.0, 0.0, 0.0], device=rays.device)[:, None]
    padded = torch.cat([rays, fill.expand(7, pad)], dim=1)
    total = 0
    for s in range(0, padded.shape[1], tile * rows_per_chunk):
        r = padded[:, s:s + tile * rows_per_chunk]
        _, counts = trace._cluster_visit_lists(meta, Vec3(r[0], r[1], r[2]), Vec3(r[3], r[4], r[5]),
                                               r[6], tile)
        total += int(counts.sum())
    return total


def time_mesh_query(meta, fp, bounds, rays, **labels) -> dict:
    """The kernel and its plain version timed with CUDA events on one
    recorded query, with its bound; prints one mesh_time line."""
    run = lambda: mh.mesh_hit(fp, bounds, rays)
    run()  # warm-up
    ms = float(np.median([cuda_ms(run) for _ in range(5)]))
    mh.mesh_hit_reference(fp, bounds, rays)
    plain_ms = cuda_ms(lambda: mh.mesh_hit_reference(fp, bounds, rays))
    _, visits = mh.mesh_hit(fp, bounds, rays, with_visits=True)
    bound_ms, bound_by, ops, nbytes = mesh_bound(fp, bounds, rays, visits)
    live = int((rays[6] > 0).sum())
    blocks = block_visits(meta, rays)
    phase("mesh_time", **labels, ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.1f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, of_bound=f"{bound_ms / ms:.3f}",
          visits=int(visits.sum()), visits_per_live_ray=f"{float(visits.sum()) / max(live, 1):.2f}",
          block_visits_at_most=blocks,
          lane_use_at_least=f"{float(visits.sum()) / max(blocks * 128, 1):.3f}",
          fp32_ops=f"{ops:.3e}", bytes=int(nbytes),
          slab_ops_live=f"{live * bounds.shape[1] * FP_OPS_SLAB:.3e}", library_ms="none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def compare_images(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a - b)
    agree = d.max(axis=-1) <= 1e-2
    return {"rmse": float(np.sqrt(np.mean(d ** 2))),
            "rmse_agreeing": float(np.sqrt(np.mean(d[agree] ** 2))) if agree.any() else 0.0,
            "max_abs": float(d.max()), "share_gt_1e-2": float(np.mean(~agree))}


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
    t = time.perf_counter()
    denoised, beauty = renderer.render_denoised(iterations=32, batch=16)
    main_path_s = time.perf_counter() - t
    k1_launches = megakernel.LAUNCHES
    if k1_launches < 1:
        raise AssertionError("the main path launched K1 no time")
    if not (denoised.shape == (RES, RES, 3) and np.isfinite(denoised).all()
            and np.isfinite(beauty).all() and 0.0 <= denoised.min() and denoised.max() <= 1.0):
        raise AssertionError("denoised output is not a finite [0,1] 800x800x3 image")
    phase("render", main_path_s=f"{main_path_s:.2f}", k1_launches=k1_launches,
          beauty_mean=f"{beauty.mean():.4f}", denoised_mean=f"{denoised.mean():.4f}")

    # K1 timed as step_many(16) calls it, iterations 1..16 into zeroed accumulators.
    dev, meta = parity["cornell"]["dev"], parity["cornell"]["meta"]
    record = megakernel.scene_record(meta, dev.camera)
    acc = torch.zeros((9, RES * RES), device=device)
    run_k1 = lambda: megakernel.megakernel_accumulate(
        dev, meta, options, acc, 1, PARITY_ITERS, key, record=record)
    times = []
    for _ in range(6):  # the first is a warm-up
        acc.zero_()
        times.append(cuda_ms(run_k1))
    k1_ms = float(np.median(times[1:]))
    samples = RES * RES * PARITY_ITERS
    bounces = ray_bounces(dev, meta, options, range(1, PARITY_ITERS + 1))
    fp_ops, int_ops = k1_ops(meta, options, samples, bounces)
    bytes_moved = 2 * acc.numel() * 4 + record.numel() * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(fp_ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    bound_ms = 1e3 * max(t_bytes, t_ops)
    phase("render", k1_ms_per_launch=f"{k1_ms:.3f}", k1_ms_per_iter=f"{k1_ms / PARITY_ITERS:.3f}",
          msamples_per_s=f"{samples / k1_ms / 1e3:.1f}", ray_bounces=bounces,
          bounces_per_sample=f"{bounces / samples:.3f}", fp32_ops=f"{fp_ops:.3e}",
          int32_ops=f"{int_ops:.3e}", bound_ms=f"{bound_ms:.3f}",
          bound_by="bytes" if t_bytes > t_ops else "operations",
          launches_per_iter_batch=1)

    # ---- mesh_parity -------------------------------------------------------------
    mesh_calls, mesh_metas, mesh_max_abs = {}, {}, 0.0
    for name in MESH_SCENES:
        r = Renderer(mesh_scene(name), app_options(), seed=SEED, device=device)
        dev, meta = r.dev, r.meta
        mesh_metas[name] = meta
        with recording_mesh_queries() as calls:
            render_sample(dev, meta, r.options, 1, r.base_key)
        calls = calls[:2]  # bounce 0: the camera rays; bounce 1: after one shade
        with_tb = any(g.bump > 0 for g in meta.geoms)
        tables = ({"f32": dev.face_ex_t, "f16": dev.face_ex_h, "oct": dev.face_ex_o}
                  if meta.has_textures else {"f32": dev.face_ex_t})
        for label, (fp, bounds, rays) in zip(("bounce0", "bounce1"), calls):
            out_k, visits_k = mh.mesh_hit(fp, bounds, rays, with_visits=True)
            out_p, visits_p = mh.mesh_hit_reference(fp, bounds, rays, with_visits=True)
            cmp = compare_mesh_outputs(out_k, out_p, visits_k, visits_p)
            same = (out_k == out_p) | (out_k.isnan() & out_p.isnan())
            mesh_max_abs = max(mesh_max_abs, float(torch.where(
                same, 0.0, (out_k - out_p).abs()).nan_to_num(nan=float("inf")).max()))
            extras = {"rows": [(trace._winner_extras(out_k, tab, meta.has_textures, with_tb),
                                trace._winner_extras(out_p, tab, meta.has_textures, with_tb))
                               for tab in tables.values()],
                      "lists/conds": [(
                          trace._plane_ex_extras(out_k, dev.face_plane_ex, meta.has_textures, with_tb),
                          trace._plane_ex_extras(out_p, dev.face_plane_ex, meta.has_textures, with_tb))]}
            extras_equal = all(torch.equal(a, b) for pairs in extras.values()
                               for ek, ep in pairs for a, b in zip(ek, ep))
            live = int((rays[6] > 0).sum())
            phase("mesh_parity", scene=name, batch=label, rays=rays.shape[1], live=live,
                  mesh_winners=int((out_k[4] >= 0).sum()), visits=int(visits_k.sum()),
                  tables="/".join(tables), extras_equal=extras_equal,
                  **{k: (f"{v:.3e}" if isinstance(v, float) else v) for k, v in cmp.items()})
            if not (cmp["bitwise"] and cmp["visits_equal"] and extras_equal):
                raise AssertionError(f"mesh kernel disagrees with its plain version on {name} "
                                     f"{label}: {cmp}, extras_equal={extras_equal}")
        mesh_calls[name] = calls

    # ---- mesh_render: the mesh main path, counted ----------------------------------
    mesh_launches = {}
    for name in MESH_SCENES:
        r = Renderer(mesh_scene(name), app_options(), seed=SEED, device=device)
        if r.use_megakernel or (r.options.mesh_tier, r.options.mesh_sort,
                                r.options.winner_table) != ("rows", "need", "oct"):
            raise AssertionError(f"{name}: unexpected route or options {r.options}")
        with counting(trace, "mesh_rows_hit") as queries, \
                patched(trace, "mesh_intersect_soa", refuse):
            mh.LAUNCHES = 0
            t = time.perf_counter()
            denoised, beauty = r.render_denoised(iterations=MESH_ITERS, batch=16)
            wall_s = time.perf_counter() - t
            m_launches = mh.LAUNCHES
        if not (m_launches > 0 and m_launches == queries[0]):
            raise AssertionError(f"{name}: {m_launches} kernel launches for {queries[0]} "
                                 "mesh queries")
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
        if name == "cornellShipTex":
            mesh_launches["rows"] = m_launches
        phase("mesh_render", scene=name, tier="rows", main_path_s=f"{wall_s:.2f}",
              mesh_launches=m_launches, mesh_queries=queries[0],
              render_s=f"{render_s:.3f}", ms_per_iter=f"{1e3 * render_s / MESH_ITERS:.1f}",
              msamples_per_s=f"{RES * RES * MESH_ITERS / render_s / 1e6:.2f}",
              beauty_mean=f"{beauty.mean():.4f}", denoised_mean=f"{denoised.mean():.4f}")
    tier_calls = {}
    for tier, fn in (("lists", "mesh_list_hit"), ("conds", "mesh_pallas_hit")):
        r = Renderer(mesh_scene("cornellShipTex"), app_options(mesh_tier=tier), seed=SEED,
                     device=device)
        with counting(trace, fn) as queries, patched(trace, "mesh_intersect_soa", refuse), \
                recording_mesh_queries() as tier_calls[tier]:
            mh.LAUNCHES = 0
            img = r.render(iterations=MESH_TIER_ITERS)
            mesh_launches[tier] = mh.LAUNCHES
        if not (mesh_launches[tier] > 0 and mesh_launches[tier] == queries[0]
                and np.isfinite(img).all()):
            raise AssertionError(f"tier {tier}: {mesh_launches[tier]} launches for "
                                 f"{queries[0]} queries")
        phase("mesh_render", scene="cornellShipTex", tier=tier, iterations=MESH_TIER_ITERS,
              mesh_launches=mesh_launches[tier], mesh_queries=queries[0])
    # The same 4 iterations through the kernel and through the plain tier.
    images = []
    for query in (mh.mesh_hit, mh.mesh_hit_reference):
        r = Renderer(mesh_scene("cornellShipTex"), app_options(), seed=SEED, device=device)
        with patched(trace, "mesh_hit", query):
            images.append(r.render(iterations=MESH_IMAGE_ITERS, batch=MESH_IMAGE_ITERS))
    img_cmp = compare_images(*images)
    phase("mesh_render", check="kernel_vs_plain_tier", iterations=MESH_IMAGE_ITERS,
          equal=bool(np.array_equal(*images)), **{k: f"{v:.3e}" for k, v in img_cmp.items()})
    if img_cmp["rmse_agreeing"] >= PARITY_RMSE or img_cmp["share_gt_1e-2"] >= PARITY_PIXEL_SHARE:
        raise AssertionError(f"kernel and plain-tier images disagree: {img_cmp}")

    # The kernel timed with CUDA events on the main path's own queries: the
    # rows tier's on both scenes, and each other tier's on its own run's.
    mesh_times = {}
    for name in MESH_SCENES:
        for label, (fp, bounds, rays) in zip(("bounce0", "bounce1"), mesh_calls[name]):
            mesh_times[name, "rows", label] = time_mesh_query(
                mesh_metas[name], fp, bounds, rays, scene=name, tier="rows", batch=label)
    for tier, calls in tier_calls.items():
        mesh_times["cornellShipTex", tier, "bounce1"] = time_mesh_query(
            mesh_metas["cornellShipTex"], *calls[1], scene="cornellShipTex", tier=tier,
            batch="bounce1")

    # ---- mesh_profile: where the mesh main path's device time goes ------------------
    r = Renderer(mesh_scene("cornellShipTex"), app_options(), seed=SEED, device=device)
    r.render(iterations=1)  # warm-up
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
        run_k6()  # warm-up
        ms = float(np.median([cuda_ms(run_k6) for _ in range(7)]))
        plain = lambda: prng.uniforms_reference(PRNG_SEEDS[1], k, n, device)
        plain()
        plain_ms = cuda_ms(plain)
        rand = lambda: torch.rand(k, n, device=device)
        rand()
        rand_ms = float(np.median([cuda_ms(rand) for _ in range(7)]))
        t_int = k * n * INT_OPS_PER_DRAW / INT32_OPS_PER_S
        t_bytes = 4 * k * n / HBM_BYTES_PER_S
        k6[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=rand_ms,
                     bound_ms=1e3 * max(t_int, t_bytes),
                     bound_by="operations" if t_int >= t_bytes else "bytes")
        phase("prng", shape=f"{k}x{n}", k6_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
              torch_rand_ms=f"{rand_ms:.4f}", int32_ops=f"{k * n * INT_OPS_PER_DRAW:.3e}",
              bytes=4 * k * n, bound_ms=f"{k6[k]['bound_ms']:.4f}", bound_by=k6[k]["bound_by"],
              of_bound=f"{k6[k]['bound_ms'] / ms:.3f}", vs_torch_rand=f"{ms / rand_ms:.2f}")

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
        megakernel.BOUNCE_LAUNCHES = prng.LAUNCHES = 0
        t = time.perf_counter()
        denoised, beauty = r.render_denoised(iterations=BOUNCE_ITERS, batch=16)
        wall_s = time.perf_counter() - t
        k5_launches, k6_launches = megakernel.BOUNCE_LAUNCHES, prng.LAUNCHES
    if k5_launches < 1 or k6_launches < 1:
        raise AssertionError(f"the K5 path launched K5 {k5_launches} and K6 {k6_launches} times")
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
    acc = torch.zeros((9, n), device=device)
    visits = torch.zeros(n, dtype=torch.int32, device=device)
    for it, ikey, rays in all_rays:
        megakernel.bounce_launch(dev, meta, bounce_options, acc, rays, it, ikey, record, visits)
    run_k5 = lambda: [megakernel.bounce_launch(dev, meta, bounce_options, acc, rays, it, ikey,
                                               record) for it, ikey, rays in all_rays]
    k5_ms = float(np.median([cuda_ms(run_k5) for _ in range(3)])) / BOUNCE_ITERS
    k5_plain_ms = k5_parity["cornellShip", "auto"]["plain_ms"]  # per iteration, the same inputs
    bounces = ray_bounces(dev, meta, bounce_options, range(1, BOUNCE_ITERS + 1))
    fp_k1, int_ops = k1_ops(meta, bounce_options, 0, bounces)  # raygen runs outside K5
    face_ops = float(visits.sum()) * 128 * FP_OPS_FACE_TEST
    fp_ops = fp_k1 + face_ops
    k5_bytes = BOUNCE_ITERS * 4 * (6 * n + 2 * 9 * n + record.numel() + dev.face_plane.numel()
                                   + dev.cluster_bounds.numel())
    t_ops = max(fp_ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    t_bytes = k5_bytes / HBM_BYTES_PER_S
    k5_bound_ms = 1e3 * max(t_ops, t_bytes) / BOUNCE_ITERS
    k5_bound_by = "operations" if t_ops >= t_bytes else "bytes"
    phase("bounce_render", k5_ms_per_launch=f"{k5_ms:.3f}", plain_ms_per_iter=f"{k5_plain_ms:.1f}",
          ray_bounces=bounces, bounces_per_sample=f"{bounces / (n * BOUNCE_ITERS):.3f}",
          cluster_visits=int(visits.sum()),
          visits_per_ray_bounce=f"{float(visits.sum()) / max(bounces, 1):.3f}",
          fp32_ops=f"{fp_ops:.3e}", face_test_ops=f"{face_ops:.3e}", int32_ops=f"{int_ops:.3e}",
          bytes=k5_bytes, bound_ms_per_launch=f"{k5_bound_ms:.4f}", bound_by=k5_bound_by,
          of_bound=f"{k5_bound_ms / k5_ms:.3f}")

    # Where the K5 path's device time goes: two iterations under the profiler.
    r.reset()
    r.render(iterations=1)  # warm-up
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

    # ---- app ------------------------------------------------------------------------
    for scene_arg, iters in (("cornell", 32), ("scenes/cornellShipTex.txt", 4)):
        with tempfile.TemporaryDirectory() as out_dir:
            proc = subprocess.run(
                [sys.executable, "-m", "mygpuraytracer_tpu_torch.apps.raytrace", scene_arg,
                 "--resolution", str(RES), str(RES), "--iterations", str(iters),
                 "--depth", str(DEPTH), "--out-dir", out_dir],
                capture_output=True, text=True, timeout=600, cwd=HERE)
            pngs = sorted(os.listdir(out_dir))
            tail = proc.stdout.strip().splitlines()[-3:]
            phase("app", scene=scene_arg, rc=proc.returncode, pngs=len(pngs),
                  out=repr(" | ".join(tail)))
            if proc.returncode != 0:
                raise AssertionError(f"app failed:\n{proc.stdout}\n{proc.stderr}")
            for suffix in ("samp.png", "albedo.png", "input.png", "output.png"):
                if sum(p.endswith(suffix) for p in pngs) != 1:
                    raise AssertionError(f"app did not write one *{suffix}: {pngs}")

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
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }]
    for tier, kname, line in (("rows", "k2_mesh_rows", 1109), ("lists", "k3_mesh_lists", 967),
                              ("conds", "k4_mesh_conds", 427)):
        main_time = mesh_times["cornellShipTex", tier, "bounce1"]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "mygpuraytracer_tpu_torch/csrc/mesh_hit.cu",
            "replaces": f"mygpuraytracer_tpu/ops/trace.py:{line}",
            "launches": mesh_launches[tier],
            "max_abs_err": mesh_max_abs,
            "ms": main_time["ms"],
            "plain_ms": main_time["plain_ms"],
            "bound_ms": main_time["bound_ms"],
            "bound_by": main_time["bound_by"],
            "library_ms": None,
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
    sys.exit(main())
