"""Stateful render orchestration.

Counterpart of ``mygpuraytracer_tpu/render/renderer.py::Renderer``
(pathtraceInit/pathtrace/pathtraceFree + the runCuda accumulation protocol,
apps/src/pathtrace.cu:130-223,527-671; apps/src/main.cpp:221-281): owns the
accumulators and the iteration counter.

The accumulators are one [9, N] float32 tensor on the device: rows 0-2 sum
color * pi over iterations, rows 3-5 hold the first-hit albedo and rows 6-8
the first-hit normal, both taken at iteration 1. ``step_many`` runs a batch
of iterations through the K1 CUDA kernel in one launch when
``options.megakernel`` is set and the scene is one K1 supports
(render/megakernel.py); otherwise it runs the plain wavefront sample by
sample (render/pathtrace.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderOptions
from ..ops import rng
from ..scene.device_scene import build_device_scene
from ..scene.structs import Scene
from . import megakernel
from .pathtrace import accumulate_sample, render_sample


class Renderer:
    """One scene bound to device tensors; call step()/step_many()/render()."""

    def __init__(self, scene: Scene, options: RenderOptions | None = None, seed: int = 0,
                 device="cuda"):
        self.scene = scene
        self.options = options or RenderOptions()
        self.device = torch.device(device)
        self.dev, self.meta = build_device_scene(scene, self.options.face_chunk, self.device)
        if self.meta.has_textures:
            raise NotImplementedError("textured scenes are not ported yet")
        self.base_key = rng.make_key(seed)
        self.use_megakernel = bool(
            self.options.megakernel
            and not self.options.dir_aov
            and megakernel.supports_megakernel(self.meta, self.options)
        )
        self.reset()

    # -- lifecycle (pathtraceInit/Free analog) --------------------------------
    def reset(self) -> None:
        """Zero accumulators and iteration counter (camera-move semantics)."""
        w, h = self.meta.resolution
        self.acc = torch.zeros((9, w * h), dtype=torch.float32, device=self.device)
        self.iteration = 0
        self.record = (megakernel.scene_record(self.meta, self.dev.camera)
                       if self.use_megakernel else None)

    # -- iteration ------------------------------------------------------------
    def step(self) -> int:
        """Run one MC iteration; returns the new iteration count."""
        return self.step_many(1)

    def step_many(self, num_iters: int) -> int:
        """Run ``num_iters`` MC iterations (one K1 launch when K1 applies)."""
        start = self.iteration + 1
        if self.use_megakernel:
            megakernel.megakernel_accumulate(
                self.dev, self.meta, self.options, self.acc, start, num_iters,
                self.base_key, record=self.record)
        else:
            for it in range(start, start + num_iters):
                out = render_sample(self.dev, self.meta, self.options, it, self.base_key)
                accumulate_sample(self.acc, out, it)
        self.iteration += num_iters
        return self.iteration

    def render(self, iterations: int | None = None, batch: int = 16) -> np.ndarray:
        """Run ``iterations`` samples (default: the scene's ITERATIONS) in
        batches of ``batch`` and return the normalized beauty image HxWx3."""
        total = iterations if iterations is not None else self.meta.iterations
        done = 0
        while done < total:
            n = min(batch, total - done)
            self.step_many(n)
            done += n
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
