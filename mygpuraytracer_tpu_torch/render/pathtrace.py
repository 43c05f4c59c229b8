"""One Monte-Carlo camera sample: the wavefront pipeline.

Counterpart of ``mygpuraytracer_tpu/render/pathtrace.py::render_sample`` without
the material sort and the first-bounce cache (neither changes the image: the
sort is a permutation undone at the end, and the cache stores a first hit
that is recomputed here from the same deterministic primary rays):

    one RNG block -> raygen -> bounce 0 (+ AOVs) -> bounces 1..depth-1
    -> finalGather (color * pi)

The RNG block is ``ops/prng.py::iteration_uniforms(options, fold_in(key(seed),
iteration), iteration, 4 + 3*depth, N)``: ``jax.random.uniform`` of that key,
reproduced bit for bit by ``ops/rng.py``, or under ``rng`` "pallas"/"auto" off
the CPU the K6 counter stream. Rows 0-1 are the AA jitter, rows 2-3 the DoF
lens sample, rows 4+3b .. 6+3b bounce b.

With ``options.megakernel`` on a scene the kernels support,
``render_sample`` takes the JAX package's megakernel route: one iteration
through K1 or, for large untextured meshes under ``bounce_megakernel``, K5
(``render/megakernel.py::megakernel_sample``). Otherwise every bounce
queries the scene through ``ops/trace.py::intersect_soa`` with the options'
mesh settings: on CUDA tensors a mesh of more than 256 faces goes through
the mesh tiers' CUDA kernel (ops/mesh_hit.py), everything else is PyTorch.
The kernels' plain versions run ``trace_sample`` on their own uniforms and
scene query.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..config import RenderOptions
from ..ops import rng
from ..ops.prng import iteration_uniforms
from ..ops.trace import HitSoA, intersect_soa
from ..ops.vec3 import Vec3
from ..scene.device_scene import DeviceScene, SceneMeta
from .camera import generate_camera_rays
from .shade import PathStateSoA, albedo_soa, shade_soa

PI = math.pi  # finalGather multiplies by pi (pathtrace.cu:508)


class SampleOutput(NamedTuple):
    color: Vec3  # [N] this sample's contribution (already * pi)
    albedo: Vec3  # [N] first-hit albedo; zero except at iteration 1
    normal: Vec3  # [N] first-hit shading normal; zero except at iteration 1


def num_rng_streams(trace_depth: int) -> int:
    return 4 + 3 * trace_depth


def render_sample(
    dev: DeviceScene,
    meta: SceneMeta,
    options: RenderOptions,
    iteration: int,  # 1-based like the reference
    base_key: rng.Key,
) -> SampleOutput:
    if options.dir_aov:
        raise NotImplementedError("dir_aov is not ported yet")
    if options.megakernel:
        from .megakernel import megakernel_sample, supports_megakernel

        if supports_megakernel(meta, options):
            return megakernel_sample(dev, meta, options, iteration, base_key)
    return wavefront_sample(dev, meta, options, iteration, base_key)


def wavefront_sample(dev: DeviceScene, meta: SceneMeta, options: RenderOptions,
                     iteration: int, base_key: rng.Key) -> SampleOutput:
    """One iteration of the wavefront: ``iteration_uniforms`` and
    ``intersect_soa`` with the options' mesh settings."""
    n = meta.resolution[0] * meta.resolution[1]
    U = iteration_uniforms(options, rng.iteration_key(base_key, iteration), iteration,
                           num_rng_streams(meta.trace_depth), n, dev.camera.position.device)
    query = lambda o, d, active=None: intersect_soa(
        meta, dev, o, d, options.face_chunk, bounding_box=options.bounding_box,
        mesh_pallas=options.mesh_pallas, mesh_sort=options.mesh_sort,
        mesh_tier=options.mesh_tier, winner_table=options.winner_table, active=active)
    return trace_sample(dev, meta, options, iteration, U, query)


def trace_sample(dev: DeviceScene, meta: SceneMeta, options: RenderOptions, iteration: int,
                 U: torch.Tensor, query: Callable[..., HitSoA]) -> SampleOutput:
    """Raygen from the uniforms ``U`` [4 + 3*depth, N], then the bounce loop
    over ``query(origin, direction, active=None)``, shading and the AOVs."""
    n = meta.resolution[0] * meta.resolution[1]
    depth = meta.trace_depth
    device = U.device

    o, d = generate_camera_rays(dev.camera, meta.resolution, options, U)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    state = PathStateSoA(
        origin=o, direction=d, color=Vec3(ones, ones, ones),
        remaining=torch.full((n,), depth, dtype=torch.int32, device=device),
    )

    hit0 = query(o, d)
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    if iteration == 1:
        albedo = albedo_soa(meta, dev, hit0)
        normal = Vec3(*(torch.where(hit0.hit, c, zero) for c in hit0.normal))
    else:
        albedo = normal = Vec3(zero, zero, zero)
    state = shade_soa(meta, dev, state, hit0, U[4], U[5], U[6])

    for b in range(1, depth):
        active = state.remaining > 0
        if not bool(active.any()):
            break  # no live path: later bounces change nothing
        # Dead lanes keep a stale ray; ``active`` keeps it out of the mesh query.
        h = query(state.origin, state.direction, active)
        state = shade_soa(meta, dev, state, h, U[4 + 3 * b], U[5 + 3 * b], U[6 + 3 * b])

    color = Vec3(state.color.x * PI, state.color.y * PI, state.color.z * PI)
    return SampleOutput(color=color, albedo=albedo, normal=normal)


def accumulate_sample(acc: torch.Tensor, out: SampleOutput, iteration: int) -> None:
    """Add one sample into the [9, N] accumulator in place: rows 0-2 sum the
    color, rows 3-5 and 6-8 take the albedo and normal AOVs at iteration 1."""
    acc[0:3] += torch.stack(out.color)
    if iteration == 1:
        acc[3:6] = torch.stack(out.albedo)
        acc[6:9] = torch.stack(out.normal)
