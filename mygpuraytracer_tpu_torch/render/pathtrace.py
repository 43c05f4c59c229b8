"""One Monte-Carlo camera sample: the wavefront pipeline.

Counterpart of ``mygpuraytracer_tpu/render/pathtrace.py::render_sample``:

    one RNG block -> raygen -> bounce 0 (first-bounce cache + AOVs)
    -> bounces 1..depth-1 -> finalGather (color * pi)

The RNG block is ``ops/prng.py::iteration_uniforms(options, fold_in(key(seed),
iteration), iteration, 4 + 3*depth, N)``: ``jax.random.uniform`` of that key,
reproduced bit for bit by ``ops/rng.py``, or under ``rng`` "pallas"/"auto" off
the CPU the K6 counter stream. Rows 0-1 are the AA jitter, rows 2-3 the DoF
lens sample, rows 4+3b .. 6+3b bounce b.

The wavefront reads three options the kernels do not have:

- ``sort_by_material`` (``sort_impl``): before each shade the lanes are
  reordered by descending material id (``_sort_wavefront``), the shade
  uniforms are fetched through the pixel map, and the color is scattered
  back to pixel order at the end. Every op works lane by lane and the mesh
  kernel answers each ray alone, so the image is bitwise that of the
  unsorted wavefront.
- the first-bounce cache (``first_bounce_cache_active``: AA and DoF off):
  iteration 1 stores its first hit, later iterations reuse it instead of
  querying the scene. The cache holds the unsorted hit; the sort runs
  after it is read or written. Nothing writes a hit record in place, so the
  cached tensors stay as they were stored.
- ``dir_aov``: the first-bounce direction of the paths alive after bounce
  0, weighted by the path's final luminance, and the luminance itself
  (``SampleOutput.dirmap``/``dirlum``). It turns the sort off and skips the
  megakernel route.

With ``options.megakernel`` on a scene the kernels support (and no
``dir_aov``), ``render_sample`` takes the JAX package's megakernel route:
one iteration through K1 or, for large untextured meshes under
``bounce_megakernel``, K5 (``render/megakernel.py::megakernel_sample``).
Otherwise every bounce queries the scene through
``ops/trace.py::intersect_soa`` with the options' mesh settings: on CUDA
tensors a mesh of more than 256 faces goes through the mesh tiers' CUDA
kernel (ops/mesh_hit.py), everything else is PyTorch. The kernels' plain
versions run ``wavefront_sample``/``trace_sample`` with the three options
off (their keyword defaults).

The bounce loop runs every one of its ``depth - 1`` bounces, with the
lanes of ended paths masked: ``shade_soa`` passes a dead lane through and
the mesh query leaves it out, so a bounce with no live lane changes
nothing, which is what the JAX package's ``lax.cond(any_alive, ...)``
guard relies on. No value is read back to the host to decide it.

``iteration`` is an int or, on the capture route of the Renderer's CUDA
graphs (render/graphs.py), a 0-dim int64 tensor: an iteration counted on
the device, whose key and uniforms are computed there. The Renderer runs
iteration 1 eagerly, so a counted iteration is never the first
(:func:`is_first`).

Every function takes an optional pixel range ``pixels = (p0, count)``: the
lanes are then the image's pixels p0 .. p0 + count - 1 and every [.., N]
array is [.., count]. Raygen reads the image's pixel p0 + lane and the
uniforms are those columns of the whole block, so the lanes compute what
the same pixels of a whole-image sample do, bit for bit (the pixel-sharded
render, ``parallel/sharded.py``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..config import RenderOptions
from ..ops import rng
from ..ops.compaction import material_sort_perm
from ..ops.prng import sample_uniforms
from ..ops.trace import HitSoA, intersect_soa
from ..ops.vec3 import Vec3
from ..scene.device_scene import DeviceScene, SceneMeta
from .camera import generate_camera_rays
from .shade import PathStateSoA, albedo_soa, shade_soa

PI = math.pi  # finalGather multiplies by pi (pathtrace.cu:508)
LUMINANCE = (0.2126, 0.7152, 0.0722)  # the dir AOV's path weight


class SampleOutput(NamedTuple):
    color: Vec3  # [N] this sample's contribution (already * pi)
    albedo: Vec3  # [N] first-hit albedo; zero except at iteration 1
    normal: Vec3  # [N] first-hit shading normal; zero except at iteration 1
    cache: HitSoA | None = None  # the first-bounce cache after this sample
    # dir_aov: first-bounce direction * path luminance, and the luminance;
    # their sums over iterations give the normalized mean direction.
    dirmap: Vec3 | None = None
    dirlum: torch.Tensor | None = None


def is_first(iteration) -> bool:
    """Whether ``iteration`` is iteration 1, which writes the AOVs and fills
    the first-bounce cache. An iteration counted on the device (a tensor)
    is a later one: the capture route runs iteration 1 eagerly."""
    return not isinstance(iteration, torch.Tensor) and iteration == 1


def cache_tensors(cache: HitSoA) -> list[torch.Tensor]:
    """The cache's tensors, nested Vec3 fields flattened, in field order."""
    return [t for f in cache for t in (f if isinstance(f, tuple) else (f,))]


def clear_cache(cache: HitSoA) -> None:
    """Make ``cache`` the empty cache in place: every lane a miss (t =
    +inf, every other field zero), as :func:`make_empty_cache` builds it."""
    cache.t.fill_(math.inf)
    for t in cache_tensors(cache)[1:]:
        t.zero_()


def make_empty_cache(n: int, device="cuda") -> HitSoA:
    """An empty first-bounce cache of ``n`` lanes (every lane a miss), each
    field its own tensor."""
    z = lambda: torch.zeros(n, dtype=torch.float32, device=device)
    zi = lambda: torch.zeros(n, dtype=torch.int32, device=device)
    zb = lambda: torch.zeros(n, dtype=torch.bool, device=device)
    zv = lambda: Vec3(z(), z(), z())
    return HitSoA(
        t=torch.full((n,), math.inf, dtype=torch.float32, device=device), hit=zb(),
        normal=zv(), is_obj=zb(), color=zv(), spec_color=zv(), spec_ex=z(), refl=z(),
        refr=z(), ior=z(), emit=z(), material_id=zi(), u=z(), v=z(), kd=zi(), ks=zi(),
        ke=zi(), bump=zi(),
    )


def num_rng_streams(trace_depth: int) -> int:
    return 4 + 3 * trace_depth


def _rebuild_material_fields(meta, mat_id: torch.Tensor, hit_mask: torch.Tensor):
    """The per-material constant HitSoA fields from a (sorted) material-id
    vector, by the select chain over ``meta.geoms`` that intersection uses
    (ops/trace.py ``_Running.set_material``); lanes where ``hit_mask`` is
    False keep zeros, as a miss does. Returns (color Vec3, spec_color Vec3,
    spec_ex, refl, refr, ior, emit), bitwise the unsorted fields: both
    select the same Python-float constants."""
    z = torch.zeros(mat_id.shape, dtype=torch.float32, device=mat_id.device)
    col, spec = [z, z, z], [z, z, z]
    spec_ex = refl = refr = ior = emit = z
    seen = set()
    for g in meta.geoms:
        if g.material_id in seen:
            continue  # the same material gives the same constants
        seen.add(g.material_id)
        sel = hit_mask & (mat_id == g.material_id)
        col = [torch.where(sel, c, a) for c, a in zip(g.color, col)]
        spec = [torch.where(sel, c, a) for c, a in zip(g.spec_color, spec)]
        spec_ex = torch.where(sel, g.spec_exponent, spec_ex)
        refl = torch.where(sel, g.has_reflective, refl)
        refr = torch.where(sel, g.has_refractive, refr)
        ior = torch.where(sel, g.ior, ior)
        emit = torch.where(sel, g.emittance, emit)
    return Vec3(*col), Vec3(*spec), spec_ex, refl, refr, ior, emit


def _take(x, idx: torch.Tensor):
    """Gather every tensor of a (nested) NamedTuple through ``idx``."""
    if isinstance(x, tuple):
        return type(x)(*(_take(a, idx) for a in x))
    return x[idx]


def _sort_wavefront(meta, state: PathStateSoA, hit: HitSoA, pixel: torch.Tensor,
                    num_materials: int, impl: str = "fused"):
    """Material-sorted execution (thrust::sort_by_key, pathtrace.cu:590,612):
    the path state, the hits and the pixel map reordered by descending
    material id, stably. Returns (state, hit, pixel).

    - ``"fused"``: one stable ``torch.sort`` of the negated key, then one
      gather of the per-lane arrays stacked as int32 bit views into
      [K, N] (K = 16: ray state, t, normal, ``is_obj``, pixel; 22 when
      textured: u, v and the four texture slots), and the per-material
      constants rebuilt from the sorted key. An untextured scene's u, v and
      slots come back as zeros, as in the JAX function.
    - ``"perm"``: ``ops/compaction.py::material_sort_perm`` (counting sort),
      then a gather of every field.
    - ``"argsort"``: a stable argsort, then a gather of every field.

    All three apply the same permutation."""
    if impl == "fused":
        textured = bool(meta.has_textures)
        floats = [*state.origin, *state.direction, *state.color, hit.t, *hit.normal]
        ints = [state.remaining, hit.is_obj.to(torch.int32), pixel]
        if textured:
            floats += [hit.u, hit.v]
            ints += [hit.kd, hit.ks, hit.ke, hit.bump]
        neg_key, order = torch.sort(-hit.material_id, stable=True)
        rows = torch.stack([f.view(torch.int32) for f in floats] + ints).index_select(1, order)
        f = [r.view(torch.float32) for r in rows[:len(floats)]]
        remaining, is_obj, pix = rows[len(floats):len(floats) + 3]
        mat_id = -neg_key
        if textured:
            u, v = f[13], f[14]
            kd, ks, ke, bump = rows[len(floats) + 3:]
        else:
            u = v = torch.zeros_like(f[9])
            kd = ks = ke = bump = torch.zeros_like(mat_id)
        t = f[9]
        hit_mask = torch.isfinite(t)
        col, spec, spec_ex, refl, refr, ior, emit = _rebuild_material_fields(
            meta, mat_id, hit_mask)
        state = PathStateSoA(origin=Vec3(*f[0:3]), direction=Vec3(*f[3:6]),
                             color=Vec3(*f[6:9]), remaining=remaining)
        hit = HitSoA(t=t, hit=hit_mask, normal=Vec3(*f[10:13]), is_obj=is_obj != 0,
                     color=col, spec_color=spec, spec_ex=spec_ex, refl=refl, refr=refr,
                     ior=ior, emit=emit, material_id=mat_id, u=u, v=v, kd=kd, ks=ks, ke=ke,
                     bump=bump)
        return state, hit, pix
    if impl == "perm":
        order = material_sort_perm(hit.material_id, num_materials).to(torch.int64)
    elif impl == "argsort":
        order = torch.argsort(-hit.material_id, stable=True)
    else:
        raise ValueError(f"unknown sort_impl {impl!r}")
    return _take(state, order), _take(hit, order), pixel[order]


def render_sample(
    dev: DeviceScene,
    meta: SceneMeta,
    options: RenderOptions,
    iteration,  # 1-based like the reference; an int, or a counted 0-dim tensor
    base_key: rng.Key,
    cache: HitSoA | None = None,
    pixels: tuple[int, int] | None = None,
) -> SampleOutput:
    """One iteration under ``options`` (over the pixel range ``pixels``, or
    the whole image). ``cache`` is the first-bounce cache
    (``make_empty_cache``; None: none yet); the result carries its update."""
    if options.megakernel and not options.dir_aov:
        from .megakernel import megakernel_sample, supports_megakernel

        if supports_megakernel(meta, options):
            out = megakernel_sample(dev, meta, options, iteration, base_key, pixels)
            return out._replace(cache=cache)
    return wavefront_sample(
        dev, meta, options, iteration, base_key, cache,
        sort=options.sort_by_material and meta.num_geoms > 1 and not options.dir_aov,
        cache_first_bounce=options.first_bounce_cache_active, dir_aov=options.dir_aov,
        pixels=pixels)


def wavefront_sample(dev: DeviceScene, meta: SceneMeta, options: RenderOptions,
                     iteration, base_key: rng.Key, cache: HitSoA | None = None, *,
                     sort: bool = False, cache_first_bounce: bool = False,
                     dir_aov: bool = False,
                     pixels: tuple[int, int] | None = None) -> SampleOutput:
    """One iteration of the wavefront: ``sample_uniforms`` and
    ``intersect_soa`` with the options' mesh settings, then
    :func:`trace_sample` with the wavefront options given here (all off by
    default, as the kernels' plain versions call it)."""
    n = meta.resolution[0] * meta.resolution[1]
    U = sample_uniforms(options, base_key, iteration, num_rng_streams(meta.trace_depth), n,
                        dev.camera.position.device, pixels)
    query = lambda o, d, active=None: intersect_soa(
        meta, dev, o, d, options.face_chunk, bounding_box=options.bounding_box,
        mesh_pallas=options.mesh_pallas, mesh_sort=options.mesh_sort,
        mesh_tier=options.mesh_tier, winner_table=options.winner_table, active=active)
    return trace_sample(dev, meta, options, iteration, U, query, cache, sort=sort,
                        cache_first_bounce=cache_first_bounce, dir_aov=dir_aov,
                        p0=pixels[0] if pixels is not None else 0)


def _shade_rows(U: torch.Tensor, depth: int) -> torch.Tensor:
    """The shade uniforms as [depth, N, 4] rows (u0, u1, u2, 0): one row
    gather per bounce fetches a sorted lane's three numbers."""
    n = U.shape[1]
    u = U[4:4 + 3 * depth].reshape(depth, 3, n).transpose(1, 2)
    return torch.cat([u, torch.zeros((depth, n, 1), dtype=U.dtype, device=U.device)],
                     dim=2).contiguous()


def trace_sample(dev: DeviceScene, meta: SceneMeta, options: RenderOptions, iteration,
                 U: torch.Tensor, query: Callable[..., HitSoA],
                 cache: HitSoA | None = None, *, sort: bool = False,
                 cache_first_bounce: bool = False, dir_aov: bool = False,
                 p0: int = 0) -> SampleOutput:
    """Raygen from the uniforms ``U`` [4 + 3*depth, count] of pixels p0 ..
    p0 + count - 1 (the whole image: p0 = 0, count = N), then the bounce
    loop over ``query(origin, direction, active=None)``, shading and the
    AOVs.

    ``sort`` runs the material-sorted bounce (``options.sort_impl``);
    ``cache_first_bounce`` takes bounce 0's hit from ``cache`` after
    iteration 1 (or queries and stores it, at iteration 1 or when ``cache``
    is None); ``dir_aov`` adds the directional AOV."""
    n = U.shape[1]
    depth = meta.trace_depth
    device = U.device

    o, d = generate_camera_rays(dev.camera, meta.resolution, options, U, p0=p0)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    state = PathStateSoA(
        origin=o, direction=d, color=Vec3(ones, ones, ones),
        remaining=torch.full((n,), depth, dtype=torch.int32, device=device),
    )

    if cache_first_bounce and cache is not None and not is_first(iteration):
        hit0 = cache
    else:
        hit0 = query(o, d)
    new_cache = hit0 if cache_first_bounce else cache
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    if is_first(iteration):
        albedo = albedo_soa(meta, dev, hit0)
        normal = Vec3(*(torch.where(hit0.hit, c, zero) for c in hit0.normal))
    else:
        albedo = normal = Vec3(zero, zero, zero)

    num_materials = int(dev.mat_color.shape[0])
    pixel = torch.arange(n, dtype=torch.int32, device=device)
    if sort:
        # The random numbers follow the pixel, as the reference's RNG hashes
        # pixelIndex (pathtrace.cu:409): a sorted lane fetches its pixel's.
        rows = _shade_rows(U, depth)

        def shade_uniforms(b: int, pix: torch.Tensor):
            r = rows[b].index_select(0, pix)
            return r[:, 0], r[:, 1], r[:, 2]

        state, hit0, pixel = _sort_wavefront(meta, state, hit0, pixel, num_materials,
                                             options.sort_impl)
        state = shade_soa(meta, dev, state, hit0, *shade_uniforms(0, pixel))
    else:
        state = shade_soa(meta, dev, state, hit0, U[4], U[5], U[6])
    if dir_aov:
        dir0, alive0 = state.direction, state.remaining > 0

    for b in range(1, depth):
        # Dead lanes keep a stale ray; ``active`` keeps it out of the mesh
        # query, and shade passes them through.
        h = query(state.origin, state.direction, state.remaining > 0)
        if sort:
            state, h, pixel = _sort_wavefront(meta, state, h, pixel, num_materials,
                                              options.sort_impl)
            state = shade_soa(meta, dev, state, h, *shade_uniforms(b, pixel))
        else:
            state = shade_soa(meta, dev, state, h, U[4 + 3 * b], U[5 + 3 * b], U[6 + 3 * b])

    color = Vec3(state.color.x * PI, state.color.y * PI, state.color.z * PI)
    if sort:
        # Back to pixel order (finalGather keys on pixelIndex, pathtrace.cu:501-510).
        sorted_rows = torch.stack(color)
        rows_out = torch.empty_like(sorted_rows)
        rows_out[:, pixel.to(torch.int64)] = sorted_rows
        color = Vec3(*rows_out)
    dirmap = dirlum = None
    if dir_aov:
        lum = LUMINANCE[0] * color.x + LUMINANCE[1] * color.y + LUMINANCE[2] * color.z
        dirlum = torch.where(alive0, lum, 0.0)
        dirmap = Vec3(dir0.x * dirlum, dir0.y * dirlum, dir0.z * dirlum)
    return SampleOutput(color=color, albedo=albedo, normal=normal, cache=new_cache,
                        dirmap=dirmap, dirlum=dirlum)


def accumulate_sample(acc: torch.Tensor, out: SampleOutput, iteration,
                      dir_acc: torch.Tensor | None = None) -> None:
    """Add one sample into the [9, N] accumulator in place: rows 0-2 sum the
    color, rows 3-5 and 6-8 take the albedo and normal AOVs at iteration 1.
    ``dir_acc`` [4, N], if given, sums the dir AOV (direction rows 0-2,
    luminance row 3) of a sample that has one."""
    acc[0:3] += torch.stack(out.color)
    if is_first(iteration):
        acc[3:6] = torch.stack(out.albedo)
        acc[6:9] = torch.stack(out.normal)
    if dir_acc is not None and out.dirmap is not None:
        dir_acc[0:3] += torch.stack(out.dirmap)
        dir_acc[3] += out.dirlum
