"""Stateful render orchestration.

Counterpart of ``mygpuraytracer_tpu/render/renderer.py::Renderer``
(pathtraceInit/pathtrace/pathtraceFree + the runCuda accumulation protocol,
apps/src/pathtrace.cu:130-223,527-671; apps/src/main.cpp:221-281): owns the
accumulators and the iteration counter.

The accumulators are one [9, N] float32 tensor on the device: rows 0-2 sum
color * pi over iterations, rows 3-5 hold the first-hit albedo and rows 6-8
the first-hit normal, both taken at iteration 1. Beside it the Renderer
holds the first-bounce cache (``options.first_bounce_cache_active``), kept
across ``step``/``step_many`` and dropped by ``reset``, and a [4, N] dir
accumulator (``options.dir_aov``: direction rows 0-2, luminance row 3).
With ``options.megakernel`` on a scene the kernels support
(render/megakernel.py) and no ``dir_aov``, ``step_many`` runs a batch of
iterations through the K1 CUDA kernel in one launch or, for a mesh of more
than 256 faces under ``bounce_megakernel``, through K5, one launch per
iteration. Otherwise it runs the wavefront sample by sample
(render/pathtrace.py) with the material sort, the cache and the dir AOV as
the options ask, where a mesh of more than 256 faces, textured or not,
goes through the cluster query: its CUDA kernel on a CUDA device, its
plain version on the CPU (ops/mesh_hit.py). ``megakernel.route`` decides
the route (``route``). ``move_camera`` moves the camera and
resets the accumulation (main.cpp:222-248).

On CUDA, ``step``/``step_many`` replay captured CUDA graphs, as the JAX
Renderer runs its jitted ``_iteration_step``/``_multi_step``
(render/graphs.py): every iteration after the first is one replay of one
graph (on the K5 route: K6's raygen uniforms, the camera rays and K5). The
Renderer's first iteration 1 runs eagerly, as the captures' warm-up; on
the wavefront route every later iteration 1, after a ``reset`` or a
``move_camera``, replays a second graph, of iteration 1 (``graph_first``),
while the K5 route runs each iteration 1 eagerly. The route is
chosen up front (``graph_route``): the K1 route is already one launch per
batch and stays as it is, and a wavefront whose mesh query compacts its
live lanes (a mesh off the cluster query: ``mesh_pallas=False``, or a
mesh too small for it) has data-dependent shapes and runs eagerly. The CPU
runs eagerly, as does every step inside ``graphs.disabled()``. The
accumulators, the cache, the camera and K5's record stay where they are
for the Renderer's life: ``reset`` and ``move_camera`` write them in
place, so the graphs stay valid.

As in the JAX package, the auto options are resolved once, at
construction, from the device: on CUDA the cluster query is on,
``mesh_sort="need"`` is chosen for a mesh embedded in a primitive room, and
its winner table is ``"oct"``; on the CPU the chunked
Moller-Trumbore stream runs and the table is ``"f32"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RenderOptions
from ..ops import rng
from ..ops.trace import uses_cluster_query
from ..scene.device_scene import build_device_scene, camera_params
from ..scene.structs import GeomType, Scene
from ..utils.profiling import named_scope
from ..utils.timer import PerformanceTimer
from . import graphs, megakernel
from .pathtrace import (accumulate_sample, cache_tensors, clear_cache, make_empty_cache,
                        render_sample, store_cache)

def mesh_reach_fraction(scene: Scene, meta, grid: int = 64) -> float:
    """Host-side estimate of the share of camera rays (a grid x grid set of
    pixel centers) that can reach an OBJ mesh's AABB: drives the
    ``mesh_sort`` auto mode."""
    cam = scene.state.camera
    w, h = meta.resolution
    xs = (np.arange(grid, dtype=np.float32) + 0.5) * (w / grid)
    ys = (np.arange(grid, dtype=np.float32) + 0.5) * (h / grid)
    x, y = np.meshgrid(xs, ys)
    sx = np.float32(cam.pixel_length[0]) * (x - w * 0.5)
    sy = np.float32(cam.pixel_length[1]) * (y - h * 0.5)
    view = np.asarray(cam.view, np.float32)
    right = np.asarray(cam.right, np.float32)
    up = np.asarray(cam.up, np.float32)
    pos = np.asarray(cam.position, np.float32)
    d = view[None, None] - right[None, None] * sx[..., None] - up[None, None] * sy[..., None]
    mask = np.zeros(x.shape, bool)
    for g in meta.geoms:
        if g.type != int(GeomType.OBJ) or g.face_count <= 0:
            continue
        bmin = np.asarray(g.aabb_min, np.float32)
        bmax = np.asarray(g.aabb_max, np.float32)
        da = np.where(np.abs(d) < 1e-20, 1e-20, d)
        t1 = (bmin[None, None] - pos[None, None]) / da
        t2 = (bmax[None, None] - pos[None, None]) / da
        tmin = np.minimum(t1, t2).max(axis=-1)
        tmax = np.maximum(t1, t2).min(axis=-1)
        mask |= (tmax >= tmin) & (tmax > 0)
    return float(mask.mean())


def _resolve_auto_options(options: RenderOptions, scene: Scene, meta,
                          device) -> RenderOptions:
    """Resolve ``mesh_sort=None`` (auto) once: "need" where the cluster
    query runs (on CUDA unless ``mesh_pallas`` says otherwise) on a mesh
    embedded in a room of primitives (bounce-0 reach < 30% and >= 4
    non-OBJ geoms, which keep the rays that miss the mesh alive); False
    otherwise."""
    if options.mesh_sort is not None:
        return options
    use: bool | str = False
    n_prim = sum(1 for g in meta.geoms if g.type != int(GeomType.OBJ))
    if (uses_cluster_query(meta, options.mesh_pallas, device)
            and n_prim >= 4 and mesh_reach_fraction(scene, meta) < 0.30):
        use = "need"
    return dataclasses.replace(options, mesh_sort=use)


def _resolve_winner_table(options: RenderOptions, device) -> RenderOptions:
    """``winner_table="auto"``: "oct" on CUDA (16-byte gather rows), exact
    "f32" on the CPU."""
    if options.winner_table != "auto":
        return options
    use = "oct" if torch.device(device).type == "cuda" else "f32"
    return dataclasses.replace(options, winner_table=use)


class Renderer:
    """One scene bound to device tensors; call step()/step_many()/render()."""

    def __init__(self, scene: Scene, options: RenderOptions | None = None, seed: int = 0,
                 device="cuda"):
        self.scene = scene
        self.options = options or RenderOptions()
        self.device = torch.device(device)
        self.dev, self.meta = build_device_scene(scene, self.options.face_chunk, self.device)
        self.options = _resolve_auto_options(self.options, scene, self.meta, self.device)
        self.options = _resolve_winner_table(self.options, self.device)
        self.base_key = rng.make_key(seed)
        self.timer = PerformanceTimer(self.device)
        self.route = megakernel.route(self.meta, self.options)  # "k1", "k5" or "wavefront"
        self.use_megakernel = self.route != "wavefront"
        self.graph_route = self._graph_route()
        self.graph: graphs.Captured | None = None  # a later iteration, captured at its first use
        # The wavefront's iteration 1, captured after the first eager one.
        self.graph_first: graphs.Captured | None = None
        self._graph_pool = None
        self._graph_buffers = None
        self._counter = torch.zeros((), dtype=torch.int64, device=self.device)
        self.acc = self.record = None
        self.reset()

    def _graph_route(self) -> str | None:
        """``"wavefront"``, ``"k5"`` or None (eager): decided once, from the
        device and the options."""
        if self.device.type != "cuda" or self.route == "k1":
            return None  # K1: one launch a batch
        if self.route == "k5":
            return "k5"
        if self.meta.has_obj and not uses_cluster_query(self.meta, self.options.mesh_pallas,
                                                        self.device):
            return None  # the chunked stream compacts the live lanes (data-dependent shapes)
        return "wavefront"

    # -- lifecycle (pathtraceInit/Free analog) --------------------------------
    def reset(self) -> None:
        """Zero the accumulators and the iteration counter and empty the
        first-bounce cache (camera-move semantics), in place: the
        accumulators and the cache keep their storage, which the graphs
        hold."""
        w, h = self.meta.resolution
        n = w * h
        if self.acc is None:
            self.acc = torch.zeros((9, n), dtype=torch.float32, device=self.device)
            self.dir_acc = torch.zeros((4, n), dtype=torch.float32, device=self.device)
            self.cache = (make_empty_cache(n, self.device)
                          if self.options.first_bounce_cache_active else None)
        else:
            self.acc.zero_()
            self.dir_acc.zero_()
            if self.cache is not None:
                clear_cache(self.cache)
        self.iteration = 0
        if self.use_megakernel:
            record = megakernel.scene_record(self.meta, self.dev.camera)
            self.record = record if self.record is None else self.record.copy_(record)

    def move_camera(self, position=None, look_at=None) -> None:
        """Move the camera and reset the accumulation (main.cpp:222-248):
        the new camera is written into the device's camera tensors in place
        and the kernels' scene record rebuilt from it."""
        cam = self.scene.state.camera
        if position is not None:
            cam.position = np.asarray(position, np.float32)
        if look_at is not None:
            cam.look_at = np.asarray(look_at, np.float32)
        cam.rebuild()
        for old, new in zip(self.dev.camera, camera_params(cam, self.device)):
            old.copy_(new)
        self.reset()

    # -- iteration ------------------------------------------------------------
    def step(self) -> int:
        """Run one MC iteration; returns the new iteration count."""
        return self.step_many(1)

    def step_many(self, num_iters: int) -> int:
        """Run ``num_iters`` MC iterations: one K1 launch where that route
        applies; else on CUDA replays of the captured graphs
        (``graph_route``): iteration 1 eager the first time and on the K5
        route, else the wavefront's graph of iteration 1, and every later
        iteration one graph; else iteration by iteration (K5: one launch
        per iteration)."""
        start = self.iteration + 1
        if self.graph_route is not None and graphs.enabled():
            if num_iters <= 0:
                return self.iteration
            self._drop_graphs_on_new_buffers()
            if start == 1:
                self._first()
                start, num_iters = 2, num_iters - 1
                self.iteration += 1
            self._replay(start, num_iters)
        else:
            self._eager(start, num_iters)
        self.iteration += num_iters
        return self.iteration

    def _eager(self, start: int, num_iters: int) -> None:
        with named_scope("mygpurt.step.eager"):
            if self.use_megakernel:
                megakernel.accumulate(self.dev, self.meta, self.options, self.acc, start,
                                      num_iters, self.base_key, record=self.record)
                return
            for it in range(start, start + num_iters):
                out = render_sample(self.dev, self.meta, self.options, it, self.base_key,
                                    self.cache)
                accumulate_sample(self.acc, out, it, self.dir_acc)
                store_cache(self.cache, out)

    def _drop_graphs_on_new_buffers(self) -> None:
        """Drop both graphs when a buffer they hold was replaced, so that
        each is captured anew at its next use."""
        buffers = [self.acc, self.dir_acc, self._counter, *self.dev.camera]
        buffers += cache_tensors(self.cache) if self.cache is not None else []
        buffers += [self.record] if self.record is not None else []
        held = tuple(t.data_ptr() for t in buffers)
        if held != self._graph_buffers:
            self.graph = self.graph_first = None
            self._graph_buffers = held

    def _capture(self, step, *buffers) -> graphs.Captured:
        """``step`` (a ``graphs`` step) on the device counter and
        ``buffers``, captured into the Renderer's pool, which both of its
        graphs share: each writes its outputs into buffers that outlive
        both, and they never replay at once."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return graphs.Captured(
            lambda: step(self.dev, self.meta, self.options, self.base_key, self._counter,
                         *buffers),
            self._graph_pool)

    def _first(self) -> None:
        """Iteration 1: the wavefront's graph of it, replayed; eager on the
        K5 route and where that graph is not captured yet, which it then
        is (the eager iteration is its warm-up)."""
        if self.graph_first is None:
            self._eager(1, 1)
            if self.graph_route == "wavefront":
                self.graph_first = self._capture(graphs.wavefront_first_step, self.acc,
                                                 self.dir_acc, self.cache)
            return
        with named_scope("mygpurt.step.first"):
            self._counter.fill_(1)
            self.graph_first.replay()

    def _replay(self, start: int, num_iters: int) -> None:
        """Iterations ``start`` (>= 2) .. ``start + num_iters - 1``: the
        device counter set to ``start``, then the graph (captured at its
        first use) replayed ``num_iters`` times, each adding one to it."""
        if num_iters <= 0:
            return
        self._counter.fill_(start)
        if self.graph is None:
            if self.graph_route == "k5":
                self.graph = self._capture(graphs.bounce_step, self.acc, self.record)
            else:
                self.graph = self._capture(graphs.wavefront_step, self.acc, self.dir_acc,
                                           self.cache)
        for _ in range(num_iters):
            self.graph.replay()

    def render(self, iterations: int | None = None, progress=None,
               batch: int = 16) -> np.ndarray:
        """Run ``iterations`` samples (default: the scene's ITERATIONS) in
        batches of ``batch`` and return the normalized beauty image HxWx3.
        ``progress`` (the cooperative-cancel callback, cf. oidnDenoise's
        progress monitor) is called with the done fraction after each batch;
        rendering stops when it returns False. ``self.timer`` times the
        call on the device's stream (CUDA events; the host clock on the
        CPU) and does not wait for the device."""
        total = iterations if iterations is not None else self.meta.iterations
        self.timer.start()
        done = 0
        while done < total:
            n = min(batch, total - done)
            self.step_many(n)
            done += n
            if progress is not None and not progress(done / total):
                break
        self.timer.end()
        return self.beauty()

    def render_denoised(self, iterations: int | None = None, batch: int = 16,
                        slot: str = "rt_ldr_alb") -> tuple[np.ndarray, np.ndarray]:
        """Render, then denoise on the device. Returns (denoised HxWx3,
        beauty HxWx3). A ``*_nrm`` slot adds the normal AOV as the third
        feature; an ``rt_hdr*`` slot switches to the HDR packing. The span
        ``mygpurt.denoise`` covers the denoiser's load and enqueue, not the
        copies to the host."""
        from .denoise_fused import denoise_accumulator, load_denoiser

        self.render(iterations=iterations, batch=batch)
        with named_scope("mygpurt.denoise"):
            net, self.denoiser_random_weights = load_denoiser(slot, self.device)
            out = denoise_accumulator(
                self.acc[0:3], self.acc[3:6], self.iteration, net, self.meta.resolution,
                normal=self.acc[6:9] if slot.endswith("_nrm") else None,
                hdr=slot.startswith("rt_hdr"),
            )
        return out.cpu().numpy(), self.beauty()

    # -- outputs ----------------------------------------------------------------
    def _to_hw3(self, rows: torch.Tensor) -> np.ndarray:
        w, h = self.meta.resolution
        return rows.reshape(3, h, w).permute(1, 2, 0).cpu().numpy()

    def beauty(self) -> np.ndarray:
        """Accumulated image / iteration count (sendImageToPBO semantics)."""
        return self._to_hw3(self.acc[0:3]) / max(self.iteration, 1)

    def albedo_image(self) -> np.ndarray:
        return self._to_hw3(self.acc[3:6])

    def normal_image(self) -> np.ndarray:
        """First-hit shading normals in [-1, 1] (the AOV that feeds the
        denoiser's albedo + normal tier)."""
        return self._to_hw3(self.acc[6:9])

    def dir_image(self) -> np.ndarray:
        """The normalized SH-L1 directional lightmap in [-1, 1]
        (``options.dir_aov``): the luminance-weighted mean first-bounce
        direction per pixel, the RTLightmap directional filter's input
        (core/unet.cpp:744-763)."""
        w = torch.clamp_min(self.dir_acc[3:4], 1e-8)
        return np.clip(self._to_hw3(self.dir_acc[0:3] / w), -1.0, 1.0)

    def raw_accumulator(self) -> np.ndarray:
        """The color sum over iterations, not divided by their count."""
        return self._to_hw3(self.acc[0:3])
