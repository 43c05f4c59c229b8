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
                  and are counted), the winner's extras under each tier name
                  and winner table, the counting build's outputs equal, and
                  per ray necessary visits <= the kernel's <= the clusters
                  entered below t_cap
6. mesh_render -- the mesh main path: render_denoised of cornellShipTex and
                  cornellShip with the kernel's launches counted, the lists
                  and conds tiers likewise, kernel against plain-tier images,
                  the oct winner table's image against f32's (recorded);
                  then the kernel timed with CUDA events at each block size
                  of the sweep, with the necessary, plain and kernel visits
                  per live ray and the counting build's tree nodes,
                  traversal lane use and leaf rounds (mesh_time), and two
                  iterations under torch.profiler (mesh_profile): device busy
                  share and the kernels that take the device time
7. prng        -- K6 against its plain version bit for bit at [4, N] and
                  [28, N] for three seeds; its values on the 2^-24 grid with
                  U[0,1)'s mean and variance; K6 timed beside torch.rand in
                  turns under three yardsticks: one call at a time (the
                  kernels line's ms and library_ms: the wrapper's host cost
                  included), bursts of back-to-back calls, and the device
                  time of calls queued behind other work (the kernel alone);
                  at [4, N] the host cost per call of the wrapper's pieces
8. k5_parity   -- K5 against its plain version (the wavefront over the plain
                  walk) on the main path's inputs: cornellShip and the
                  open-sky shipOnly at 800x800, depth 8, seed 0, its first 2
                  iterations, under rng "threefry" and "auto"
9. bounce_render -- the K5 main path: Renderer(megakernel, bounce_megakernel,
                  rng="auto").render_denoised of cornellShip with the K5 and
                  K6 launches counted; one counting launch per iteration
                  (cluster visits, tree nodes, warp traversal iterations,
                  warp bounce rounds, lanes of ended paths: nodes per
                  ray-bounce, the traversal's lane use, the ended paths'
                  share of the bounce rounds' lanes); K5 timed per launch
                  with its bound (the necessary visits' face tests, its own
                  visits' beside it); two iterations under torch.profiler; its
                  image against the wavefront's (mesh kernel, same rng)
                  over 4 iterations
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

import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
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
MESH_TIER_ITERS = 2  # the lists and conds tiers' own main-path runs
MESH_IMAGE_ITERS = 4  # kernel against plain tier, image of 4 iterations
PROFILE_ITERS = 2  # iterations under torch.profiler

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
    k6_int, k6_all = pick(sass_int_counts(k6_lib), "k6_kernel")
    return {"threefry_int_per_draw": per("threefry"), "philox_int_per_call": per("philox"),
            "k6_kernel_int": k6_int, "k6_kernel_instructions": k6_all}


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
    for build, word in (("k1_kernel", "k1_kernelILb0E"), ("k1_counting", "k1_kernelILb1E")):
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


def time_k1(run, acc: torch.Tensor, repeats: int = 5) -> float:
    """K1's median device ms per launch over ``repeats`` launches of
    ``run()`` into zeroed accumulators, after one warm-up."""
    times = []
    for _ in range(repeats + 1):
        acc.zero_()
        times.append(cuda_ms(run))
    return float(np.median(times[1:]))


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
    """The tiers' query through the plain version, in the kernel's place."""
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
    return dataclasses.replace(RenderOptions(megakernel=True, mesh_tier="rows", mesh_sort=None,
                                             winner_table="auto"), **changes)


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
    SASS.update(sass_draw_counts())
    phase("build", sass_threefry_int_per_draw=SASS["threefry_int_per_draw"],
          sass_philox_int_per_call=SASS["philox_int_per_call"],
          sass_philox_int_per_draw=SASS["philox_int_per_call"] / 4,
          sass_k6_kernel_int=SASS["k6_kernel_int"],
          sass_k6_kernel_int_per_draw=SASS["k6_kernel_int"] / 4,
          sass_k6_kernel_instructions=SASS["k6_kernel_instructions"])

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
        tables = ({"f32": dev.face_ex_t, "f16": dev.face_ex_h, "oct": dev.face_ex_o}
                  if meta.has_textures else {"f32": dev.face_ex_t})
        for label, q in zip(("bounce0", "bounce1"), calls):
            out_k, _ = q.kernel()
            out_c, visits_k = q.kernel(with_visits=True)  # the counting build
            out_p = q.plain()
            cmp = compare_mesh_outputs(q, out_k, out_p, visits_k)
            same = (out_k == out_p) | (out_k.isnan() & out_p.isnan())
            mesh_max_abs = max(mesh_max_abs, float(torch.where(
                same, 0.0, (out_k - out_p).abs()).nan_to_num(nan=float("inf")).max()))
            # The winner's texcoord and TBN, from each table the tiers read,
            # on the lanes whose outputs are bitwise (all but proven
            # box-rounding ones, whose winner differs).
            agree = (out_k.view(torch.int32) == out_p.view(torch.int32)).all(dim=0)
            extras = [(trace._winner_extras(out_k, tab, meta.has_textures, with_tb),
                       trace._winner_extras(out_p, tab, meta.has_textures, with_tb))
                      for tab in tables.values()]
            extras.append((
                trace._plane_ex_extras(out_k, dev.face_plane_ex, meta.has_textures, with_tb),
                trace._plane_ex_extras(out_p, dev.face_plane_ex, meta.has_textures, with_tb)))
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
    # The same 4 iterations through the kernel and through the plain tier,
    # then through the kernel with the f32 winner table instead of oct.
    images = []
    for query, table in ((mh.mesh_hit, "auto"), (plain_mesh_hit, "auto"), (mh.mesh_hit, "f32")):
        r = Renderer(mesh_scene("cornellShipTex"), app_options(winner_table=table), seed=SEED,
                     device=device)
        with patched(trace, "mesh_hit", query):
            images.append(r.render(iterations=MESH_IMAGE_ITERS, batch=MESH_IMAGE_ITERS))
        if (table == "auto") != (r.options.winner_table == "oct"):
            raise AssertionError(f"winner table {r.options.winner_table} for {table!r}")
    img_cmp = compare_images(images[0], images[1])
    phase("mesh_render", check="kernel_vs_plain_tier", iterations=MESH_IMAGE_ITERS,
          equal=bool(np.array_equal(images[0], images[1])),
          **{k: f"{v:.3e}" for k, v in img_cmp.items()})
    if img_cmp["rmse_agreeing"] >= PARITY_RMSE or img_cmp["share_gt_1e-2"] >= PARITY_PIXEL_SHARE:
        raise AssertionError(f"kernel and plain-tier images disagree: {img_cmp}")
    table_cmp = compare_images(images[0], images[2])  # recorded only: no bar
    phase("mesh_render", check="oct_vs_f32_winner_table", scene="cornellShipTex",
          iterations=MESH_IMAGE_ITERS, equal=bool(np.array_equal(images[0], images[2])),
          **{k: f"{v:.3e}" for k, v in table_cmp.items()})
    if not np.isfinite(images[2]).all():
        raise AssertionError("the f32 winner table's image is not finite")

    # The kernel timed with CUDA events on the main path's own queries: the
    # rows tier's on both scenes, and each other tier's on its own run's.
    mesh_times = {}
    for name in MESH_SCENES:
        for label, q in zip(("bounce0", "bounce1"), mesh_calls[name]):
            mesh_times[name, "rows", label] = time_mesh_query(q, scene=name, tier="rows",
                                                              batch=label)
    for tier, calls in tier_calls.items():
        mesh_times["cornellShipTex", tier, "bounce1"] = time_mesh_query(
            calls[1], scene="cornellShipTex", tier=tier, batch="bounce1")

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
                      "c_launch": lambda: k6_c(PRNG_SEEDS[1], buf.data_ptr(), k, n, handle)}
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
    run_k5()  # warm-up
    k5_ms = float(np.median([cuda_ms(run_k5) for _ in range(3)])) / BOUNCE_ITERS
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
    phase("bounce_render", k5_ms_per_launch=f"{k5_ms:.3f}", plain_ms_per_iter=f"{k5_plain_ms:.1f}", ray_bounces=bounces,
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
        "bound_by": k1["cornell"]["bound_by"],
        "library_ms": None,
        "design": "redesigned: persistent lanes with a warp-aggregated pixel queue, a new path "
                  "as soon as one ends, the scene record in shared memory",
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
            "design": "redesigned: per-ray cluster-tree walk, warp-tested leaves (csrc/mesh.cuh)",
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
