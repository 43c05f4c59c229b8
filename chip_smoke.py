"""End-to-end check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (mygpuraytracer_tpu_torch) on the card: the
builtin Cornell box at 800x800, depth 8, rendered through the K1 CUDA kernel
and denoised with the U-Net. Phases, each printing one line with its elapsed
seconds:

1. device   -- the card's name and power limit (nvidia-smi); fails without CUDA
2. build    -- one nvcc call over csrc/*.cu into the gitignored build dir
3. k1_parity-- K1 against its plain PyTorch version on cornell and
               cornellGlass (800x800, depth 8, 16 iterations, same seed)
4. render   -- the main path: Renderer.render_denoised with K1, launch
               counts read around it; then K1 timed with CUDA events
5. denoise  -- the fused denoise (bf16 net) against the float32 net on the
               card, and the float32 net on the card against the CPU
6. app      -- `python -m mygpuraytracer_tpu_torch.apps.raytrace` in a
               subprocess, writing its four PNGs into a temporary directory

It prints a JSON line of per-kernel numbers and, last, one JSON object
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
It imports nothing of JAX.
"""

from __future__ import annotations

import copy
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
from mygpuraytracer_tpu_torch.ops import rng
from mygpuraytracer_tpu_torch.ops.trace import intersect_soa
from mygpuraytracer_tpu_torch.ops.vec3 import Vec3
from mygpuraytracer_tpu_torch.render import Renderer, megakernel
from mygpuraytracer_tpu_torch.render.camera import generate_camera_rays
from mygpuraytracer_tpu_torch.render.denoise_fused import denoise_accumulator, load_denoiser
from mygpuraytracer_tpu_torch.render.pathtrace import num_rng_streams
from mygpuraytracer_tpu_torch.render.shade import PathStateSoA, shade_soa
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

T0 = time.perf_counter()


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
    ``iterations`` of this scene execute: the data-dependent work K1 does."""
    n = meta.resolution[0] * meta.resolution[1]
    key = rng.make_key(SEED)
    total = 0
    for it in iterations:
        U = rng.uniform(rng.iteration_key(key, it), (num_rng_streams(meta.trace_depth), n),
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
            s = shade_soa(s, h, U[4 + 3 * b], U[5 + 3 * b], U[6 + 3 * b])
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
          so=_build.library_path())

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
    launches = megakernel.LAUNCHES
    if launches < 1:
        raise AssertionError("the main path launched K1 no time")
    if not (denoised.shape == (RES, RES, 3) and np.isfinite(denoised).all()
            and np.isfinite(beauty).all() and 0.0 <= denoised.min() and denoised.max() <= 1.0):
        raise AssertionError("denoised output is not a finite [0,1] 800x800x3 image")
    phase("render", main_path_s=f"{main_path_s:.2f}", k1_launches=launches,
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
    with tempfile.TemporaryDirectory() as out_dir:
        proc = subprocess.run(
            [sys.executable, "-m", "mygpuraytracer_tpu_torch.apps.raytrace", "cornell",
             "--resolution", str(RES), str(RES), "--iterations", "32", "--depth", str(DEPTH),
             "--out-dir", out_dir],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        pngs = sorted(os.listdir(out_dir))
        tail = proc.stdout.strip().splitlines()[-3:]
        phase("app", rc=proc.returncode, pngs=len(pngs), out=repr(" | ".join(tail)))
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
        "launches": launches,
        "max_abs_err": parity["cornell"]["max_abs"],
        "ms": k1_ms,
        "plain_ms": parity["cornell"]["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
