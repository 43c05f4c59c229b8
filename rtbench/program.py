"""The system under test: the port (``mygpuraytracer_tpu_torch``) driven
through the calls its raytrace app and its live preview make. This is the
only file of the benchmark that imports the port.

- a converge job is the app's: ``Renderer.reset()``, ``step_many(batch)``
  until the job's iterations are done, ``beauty()`` and ``albedo_image()``
  to the host, then ``apps.raytrace.denoise_beauty`` (the "RT" Filter on
  host arrays);
- a preview frame is ``Renderer.render_denoised(iterations)`` (more
  iterations, then the fused U-Net on the device; the denoised image and
  the beauty to the host), after ``move_camera`` when the frame moves.

Each call runs inside a ``torch.profiler.record_function`` span named
``rtbench.<call>``, which the traced run's breakdown reads.
"""

from __future__ import annotations

import numpy as np
import torch


def span(name: str):
    return torch.profiler.record_function(f"rtbench.{name}")


class Program:
    def __init__(self, config: dict, seed: int, device, resolution=None):
        from mygpuraytracer_tpu_torch.apps.raytrace import denoise_beauty
        from mygpuraytracer_tpu_torch.config import RenderOptions
        from mygpuraytracer_tpu_torch.render import Renderer
        from mygpuraytracer_tpu_torch.scene import load_scene

        self.device = torch.device(device)
        self._denoise_beauty = denoise_beauty
        with span("load_scene"):
            scene = load_scene(config["scene"])
        w, h = resolution or config["RES"]
        scene.set_resolution(w, h)
        scene.state.trace_depth = config["DEPTH"]
        options = RenderOptions(**config["options"])
        with span("renderer"):
            self.r = Renderer(scene, options, seed=seed, device=self.device)
        self.route = ("k1" if self.r.use_megakernel and self.r.graph_route is None
                      else self.r.graph_route or "eager")

    @property
    def pixels(self) -> int:
        w, h = self.r.meta.resolution
        return w * h

    # -- converge ---------------------------------------------------------------
    def reset(self) -> None:
        with span("reset"):
            self.r.reset()

    def step_many(self, n: int) -> None:
        with span("step_many"):
            self.r.step_many(n)

    def finish_job(self) -> dict:
        """The job's images on the host and the Filter's denoise of them."""
        with span("beauty"):
            beauty = self.r.beauty()
        with span("albedo_image"):
            albedo = self.r.albedo_image()
        with span("denoise_beauty"):
            denoised, timings = self._denoise_beauty(beauty, albedo, self.device)
        return dict(beauty=beauty, albedo=albedo, denoised=denoised,
                    random_weights=bool(timings["random_weights"]),
                    iterations=int(self.r.iteration))

    # -- preview --------------------------------------------------------------
    def frame(self, position=None, iterations: int = 1) -> dict:
        """One preview frame: a camera move to ``position`` (if given),
        ``iterations`` more iterations and the fused denoise."""
        if position is not None:
            with span("move_camera"):
                self.r.move_camera(position=position)
        with span("render_denoised"):
            denoised, beauty = self.r.render_denoised(iterations=iterations)
        return dict(beauty=beauty, denoised=denoised, iterations=int(self.r.iteration),
                    random_weights=bool(getattr(self.r, "denoiser_random_weights", False)))

    def albedo_on_device(self) -> torch.Tensor:
        """A copy, on the device, of the albedo AOV the last frame denoised
        with (read to the host after the window)."""
        return self.r.acc[3:6].clone()

    def albedo_to_host(self, rows: torch.Tensor) -> np.ndarray:
        w, h = self.r.meta.resolution
        return rows.reshape(3, h, w).permute(1, 2, 0).cpu().numpy()

    def close(self) -> None:
        del self.r
