"""The system under test on a mesh of cards: the raytrace app's
``--multichip sample`` job. With ``rtbench/program.py`` it is one of the two
files of the benchmark that import the port (``mygpuraytracer_tpu_torch``).

A job is the app's: ``Renderer.reset()``, then
``apps.raytrace.render_multichip`` over the configuration's ``cards`` (card
d renders its d-th share of the job's iterations in one launch, the sums
added onto the first card), then, as in ``Program``, ``beauty()`` and
``albedo_image()`` to the host and ``denoise_beauty`` on the first card. The
Renderer lives on the first card. Each call runs inside a
``torch.profiler.record_function`` span named ``rtbench.<call>``.
"""

from __future__ import annotations

import torch

from rtbench.program import Program, span


def make_mesh(cards: int, device):
    """``cards`` CUDA devices (the first ones visible), or on the CPU
    ``("cpu",) * cards``; ValueError when fewer are visible."""
    from mygpuraytracer_tpu_torch.parallel.mesh import make_mesh as port_mesh

    if torch.device(device).type == "cpu":
        return port_mesh(devices=("cpu",) * cards)
    mesh = port_mesh(cards)
    if mesh.size != cards:
        raise ValueError(f"the configuration takes {cards} cards, {mesh.size} visible")
    return mesh


class MeshProgram(Program):
    def __init__(self, config: dict, seed: int, device, resolution=None):
        from mygpuraytracer_tpu_torch.apps.raytrace import render_multichip

        super().__init__(config, seed, device, resolution)
        self._render_multichip = render_multichip
        self.mode = config["multichip"]
        self.mesh = make_mesh(int(config["cards"]), self.device)

    def step_many(self, n: int) -> None:
        """The job's ``n`` iterations from its reset, in one call of the
        app's multichip render; ValueError where the mesh does not take them
        all (the app would render the rest on one card)."""
        if self.r.iteration:
            raise ValueError("a multichip job renders from a reset Renderer")
        with span("render_multichip"):
            done = self._render_multichip(self.r, self.r.options, n, self.mode,
                                          lambda *a: None, self.mesh)
        if done != n:
            raise ValueError(f"{n} iterations do not split over {self.mesh.size} devices")
