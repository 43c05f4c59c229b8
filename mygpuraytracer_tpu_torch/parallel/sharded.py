"""Multi-device rendering over a :class:`~.mesh.Mesh`.

The port's counterpart of ``mygpuraytracer_tpu/parallel/sharded.py``. Two
modes, as there:

1. **Sample-parallel** (:func:`render_multichip_sample`): every device
   renders disjoint Monte-Carlo iterations of the whole image into its own
   [9, N] accumulator; one psum merges them. Device d renders iterations
   d*spp/D + 1 .. (d+1)*spp/D, so the RNG streams are a sequential render's
   first spp iterations. On the megakernel route that is one
   ``render/megakernel.py::accumulate`` call per device (one K1 launch, or
   K5 per iteration); on the wavefront ``render_sample`` per iteration, with
   a first-bounce cache per device. Only iteration 1 writes the albedo and
   normal AOVs, so their sum is exact.

2. **Pixel-sharded** (:func:`sharded_render_step`): device d holds pixels
   [d*N/D, (d+1)*N/D) of the accumulators, of the first-bounce cache and of
   the wavefront state; the scene is replicated. Each step runs the pixel
   range through K1/K5 (their ``pixels`` launch argument) or through the
   wavefront (raygen and the uniforms take the range), so every pixel
   computes what it computes in a whole-image render. The image is
   gathered to one [9, N] only on request (:meth:`Shards.gather`).

Each device's work is launched from this one process; CUDA launches are
asynchronous, so devices overlap. Spans (``utils/profiling.py``):
``mygpurt.multichip.replicate`` (the scene's copies),
``mygpurt.multichip.launch`` (one device's enqueue in sample mode) and
``mygpurt.multichip.psum`` (the merge). One difference from the JAX function: a
device whose first iteration is not 1 fills its first-bounce cache at that
iteration (JAX's device d > 0 would reuse an empty cache, all misses).
"""

from __future__ import annotations

import torch

from ..config import RenderOptions
from ..ops import rng
from ..ops.vec3 import Vec3
from ..render import megakernel
from ..render.pathtrace import accumulate_sample, render_sample
from ..scene.device_scene import DeviceScene, SceneMeta
from ..utils.profiling import named_scope
from .mesh import Mesh, psum, replicate, split


def _replicated(dev, mesh: Mesh) -> list:
    """``dev`` once per device: a DeviceScene is replicated (in the span
    ``mygpurt.multichip.replicate``), a list from :func:`~.mesh.replicate`
    is taken as it is."""
    if isinstance(dev, DeviceScene):
        with named_scope("mygpurt.multichip.replicate"):
            return replicate(dev, mesh)
    dev = list(dev)
    if len(dev) != mesh.size:
        raise ValueError(f"need one scene per device ({mesh.size}), got {len(dev)}")
    return dev


def render_multichip_sample(dev, meta: SceneMeta, options: RenderOptions, base_key: rng.Key,
                            spp: int, mesh: Mesh) -> tuple[Vec3, Vec3, Vec3]:
    """Render ``spp`` samples split across the mesh; returns (color sum,
    albedo, normal) as Vec3s of [N] tensors on the mesh's first device,
    summed over the devices (the color is not divided by ``spp``).

    Per-device iteration indices are disjoint (device d renders iterations
    d*spp/D + 1 ...), so the RNG streams match a sequential render's first
    spp iterations exactly."""
    n_dev = mesh.size
    per_dev = spp // n_dev
    if per_dev * n_dev != spp:
        raise ValueError(f"spp {spp} must divide evenly over {n_dev} devices")
    n = meta.resolution[0] * meta.resolution[1]
    mega = megakernel.route(meta, options) != "wavefront"
    accs = []
    for d, (device, dev_d) in enumerate(zip(mesh.devices, _replicated(dev, mesh))):
        with named_scope("mygpurt.multichip.launch"):
            acc = torch.zeros((9, n), dtype=torch.float32, device=device)
            start = d * per_dev + 1
            if mega:
                megakernel.accumulate(dev_d, meta, options, acc, start, per_dev, base_key)
            else:
                cache = None  # filled at this device's first iteration
                for it in range(start, start + per_dev):
                    out = render_sample(dev_d, meta, options, it, base_key, cache)
                    accumulate_sample(acc, out, it)
                    cache = out.cache
        accs.append(acc)
    with named_scope("mygpurt.multichip.psum"):
        total = psum(accs, mesh)
    return Vec3(*total[0:3]), Vec3(*total[3:6]), Vec3(*total[6:9])


class Shards:
    """A [rows, N] array held as per-device [rows, N/D] pieces: rows
    ``rows`` of each device's accumulator ``base[d]`` [9, N/D]."""

    def __init__(self, base: list[torch.Tensor], rows: slice, mesh: Mesh):
        self.base, self.rows, self.mesh = base, rows, mesh

    @property
    def parts(self) -> list[torch.Tensor]:
        return [b[self.rows] for b in self.base]

    def gather(self) -> torch.Tensor:
        """The whole [rows, N] array on the mesh's first device."""
        return torch.cat([p.to(self.mesh.first) for p in self.parts], dim=1)


def sharded_render_step(meta: SceneMeta, options: RenderOptions, mesh: Mesh):
    """Build a pixel-sharded single-iteration step.

    Returns (step_fn, make_state): ``step_fn(dev, image, albedo, cache,
    iteration, key)`` adds iteration ``iteration`` into the sharded
    ``image``/``albedo`` (updated in place, as the JAX step donates them)
    and returns (image, albedo, cache). ``dev`` is the scene or its per-device copies (``mesh.replicate``);
    the copies and K1/K5's records are made once per scene passed, and again
    after its camera was written in place (``Renderer.move_camera``). Device
    memory per device scales as N/D. ``make_state()`` gives zeroed
    accumulators and an empty cache per device. The megakernel route takes
    one launch per device and iteration, so its image equals a sequential
    render of one iteration per launch bit for bit."""
    n = meta.resolution[0] * meta.resolution[1]
    if n % mesh.size:
        raise ValueError("pixel count must divide the mesh size")
    ranges = split(n, mesh)
    mega = megakernel.route(meta, options) != "wavefront"
    # The scene last passed, its cameras' versions, its copies and K1/K5's records.
    held = {"key": (), "versions": (), "copies": []}

    def scenes(dev):
        """Per device: the scene's copy and K1/K5's record (None off the
        megakernel route), made again only when another scene is passed or
        a camera tensor of the one passed was written in place (which bumps
        the tensor's version counter)."""
        key = (dev,) if isinstance(dev, DeviceScene) else tuple(dev)
        versions = tuple(t._version for d in key for t in d.camera)
        if len(key) != len(held["key"]) or any(a is not b for a, b in zip(key, held["key"])) \
                or versions != held["versions"]:
            held.update(key=key, versions=versions, copies=[
                (d, megakernel.scene_record(meta, d.camera) if mega else None)
                for d in _replicated(dev, mesh)])
        return held["copies"]

    def make_state():
        accs = [torch.zeros((9, count), dtype=torch.float32, device=device)
                for device, (_, count) in zip(mesh.devices, ranges)]
        return Shards(accs, slice(0, 3), mesh), Shards(accs, slice(3, 6), mesh), \
            [None] * mesh.size

    def step_fn(dev, image: Shards, albedo: Shards, cache, iteration, key):
        if image.base is not albedo.base:
            raise ValueError("image and albedo must come from one make_state()")
        it = int(iteration)
        new_cache = []
        for d, ((dev_d, record), acc, pixels) in enumerate(zip(scenes(dev), image.base, ranges)):
            if mega:
                megakernel.accumulate(dev_d, meta, options, acc, it, 1, key, record=record,
                                      pixels=pixels)
                new_cache.append(cache[d])
            else:
                out = render_sample(dev_d, meta, options, it, key, cache[d], pixels=pixels)
                accumulate_sample(acc, out, it)
                new_cache.append(out.cache)
        return image, albedo, new_cache

    return step_fn, make_state
