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
goes through the mesh tiers: their CUDA kernel on a CUDA device, its plain
version on the CPU (ops/mesh_hit.py). ``move_camera`` moves the camera and
resets the accumulation (main.cpp:222-248).

As in the JAX package, the auto options are resolved once, at
construction, from the device: on CUDA the mesh tiers are on,
``mesh_sort="need"`` is chosen for a mesh embedded in a primitive room, and
the rows tier's winner table is ``"oct"``; on the CPU the chunked
Moller-Trumbore stream runs and the table is ``"f32"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RenderOptions
from ..ops import rng
from ..scene.device_scene import build_device_scene, camera_params
from ..scene.structs import GeomType, Scene
from ..utils.timer import PerformanceTimer
from . import megakernel
from .pathtrace import accumulate_sample, make_empty_cache, render_sample


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
    """Resolve ``mesh_sort=None`` (auto) once: "need" where the mesh tiers
    run (on CUDA unless ``mesh_pallas`` says otherwise) on a mesh embedded
    in a room of primitives (bounce-0 reach < 30% and >= 4 non-OBJ geoms,
    which keep the rays that miss the mesh alive); False otherwise."""
    if options.mesh_sort is not None:
        return options
    use: bool | str = False
    pallas = options.mesh_pallas
    if pallas is None:
        pallas = torch.device(device).type == "cuda"
    n_prim = sum(1 for g in meta.geoms if g.type != int(GeomType.OBJ))
    if (pallas and meta.has_obj and bool(meta.mesh_clusters) and meta.num_faces > 256
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
        self.timer = PerformanceTimer()
        self.use_megakernel = bool(
            self.options.megakernel
            and not self.options.dir_aov
            and megakernel.supports_megakernel(self.meta, self.options)
        )
        self.reset()

    # -- lifecycle (pathtraceInit/Free analog) --------------------------------
    def reset(self) -> None:
        """Zero the accumulators and the iteration counter and drop the
        first-bounce cache (camera-move semantics)."""
        w, h = self.meta.resolution
        n = w * h
        self.acc = torch.zeros((9, n), dtype=torch.float32, device=self.device)
        self.dir_acc = torch.zeros((4, n), dtype=torch.float32, device=self.device)
        self.cache = (make_empty_cache(n, self.device)
                      if self.options.first_bounce_cache_active else None)
        self.iteration = 0
        self.record = (megakernel.scene_record(self.meta, self.dev.camera)
                       if self.use_megakernel else None)

    def move_camera(self, position=None, look_at=None) -> None:
        """Move the camera and reset the accumulation (main.cpp:222-248);
        K1's scene record is rebuilt from the new camera."""
        cam = self.scene.state.camera
        if position is not None:
            cam.position = np.asarray(position, np.float32)
        if look_at is not None:
            cam.look_at = np.asarray(look_at, np.float32)
        cam.rebuild()
        self.dev = self.dev._replace(camera=camera_params(cam, self.device))
        self.reset()

    # -- iteration ------------------------------------------------------------
    def step(self) -> int:
        """Run one MC iteration; returns the new iteration count."""
        return self.step_many(1)

    def step_many(self, num_iters: int) -> int:
        """Run ``num_iters`` MC iterations (one K1 launch, or one K5 launch
        per iteration, where the megakernel route applies)."""
        start = self.iteration + 1
        if self.use_megakernel:
            megakernel.accumulate(self.dev, self.meta, self.options, self.acc, start, num_iters,
                                  self.base_key, record=self.record)
        else:
            for it in range(start, start + num_iters):
                out = render_sample(self.dev, self.meta, self.options, it, self.base_key,
                                    self.cache)
                accumulate_sample(self.acc, out, it, self.dir_acc)
                self.cache = out.cache
        self.iteration += num_iters
        return self.iteration

    def render(self, iterations: int | None = None, progress=None,
               batch: int = 16) -> np.ndarray:
        """Run ``iterations`` samples (default: the scene's ITERATIONS) in
        batches of ``batch`` and return the normalized beauty image HxWx3.
        ``progress`` (the cooperative-cancel callback, cf. oidnDenoise's
        progress monitor) is called with the done fraction after each batch;
        rendering stops when it returns False. ``self.timer`` times the
        call, the device synchronised."""
        total = iterations if iterations is not None else self.meta.iterations
        self.timer.start()
        done = 0
        while done < total:
            n = min(batch, total - done)
            self.step_many(n)
            done += n
            if progress is not None and not progress(done / total):
                break
        self.timer.end(sync=self.acc)
        return self.beauty()

    def render_denoised(self, iterations: int | None = None, batch: int = 16,
                        slot: str = "rt_ldr_alb") -> tuple[np.ndarray, np.ndarray]:
        """Render, then denoise on the device. Returns (denoised HxWx3,
        beauty HxWx3). A ``*_nrm`` slot adds the normal AOV as the third
        feature; an ``rt_hdr*`` slot switches to the HDR packing."""
        from .denoise_fused import denoise_accumulator, load_denoiser

        self.render(iterations=iterations, batch=batch)
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
