"""The preview's U-Net, built once per Renderer, slot and number format.

``Renderer.render_denoised`` keeps the net of each (slot, dtype) it has
run: every later frame denoises with the kept net, and its image equals,
bit for bit, ``denoise_accumulator`` run on a freshly loaded net over the
same accumulators, across ``move_camera`` and ``reset``.
``denoiser_builds`` counts the builds; ``denoiser_random_weights`` is the
kept net's flag.

Imports torch and the port only, so the card's case runs on a machine
without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_denoiser_cache.py
Without a CUDA device the card's case skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mygpuraytracer_tpu_torch.config import RenderOptions
from mygpuraytracer_tpu_torch.render import Renderer, denoise_fused
from mygpuraytracer_tpu_torch.scene.builtin import cornell_box

SLOTS = ("rt_ldr_alb", "rt_ldr_alb_nrm", "rt_hdr_alb")


def _renderer(res=16, device="cpu"):
    scene = cornell_box()
    scene.set_resolution(res, res)
    return Renderer(scene, RenderOptions(), seed=3, device=device)


def _fresh(r: Renderer, slot: str) -> np.ndarray:
    """The frame's image as the uncached path made it: a net loaded anew,
    cast inside ``denoise_accumulator``."""
    net, _ = denoise_fused.load_denoiser(slot, r.device)
    out = denoise_fused.denoise_accumulator(
        r.acc[0:3], r.acc[3:6], r.iteration, net, r.meta.resolution,
        normal=r.acc[6:9] if slot.endswith("_nrm") else None,
        hdr=slot.startswith("rt_hdr"),
    )
    return out.cpu().numpy()


def _frames(r: Renderer, slot: str):
    """Preview frames: two held, one after a move, one after a reset."""
    yield r.render_denoised(iterations=2, batch=2, slot=slot)
    yield r.render_denoised(iterations=1, batch=1, slot=slot)
    r.move_camera(position=np.asarray(r.scene.state.camera.position) + [0.3, 0.0, 0.0])
    yield r.render_denoised(iterations=2, batch=1, slot=slot)
    r.reset()
    yield r.render_denoised(iterations=1, batch=1, slot=slot)


@pytest.mark.parametrize("bf16", [False, True], ids=["net_dtype", "bf16"])
@pytest.mark.parametrize("slot", SLOTS)
def test_kept_net_denoises_as_a_fresh_one(slot, bf16, monkeypatch):
    """Bit for bit against a fresh net on each frame, one build in all; on
    the CPU the net runs in float32, and bfloat16 is forced as on CUDA."""
    if bf16:
        monkeypatch.setattr(denoise_fused, "net_dtype", lambda device: torch.bfloat16)
    r = _renderer()
    n = 0
    for denoised, beauty in _frames(r, slot):
        n += 1
        assert denoised.dtype == np.float32 and denoised.shape == beauty.shape
        np.testing.assert_array_equal(denoised, _fresh(r, slot))
    assert n == 4 and r.denoiser_builds == 1
    net, _ = r._denoisers[(slot, denoise_fused.net_dtype(r.device))]
    want = torch.bfloat16 if bf16 else torch.float32
    assert all(p.dtype == want for p in net.parameters())


def test_builds_count_one_per_slot_and_dtype(monkeypatch):
    r = _renderer(8)
    assert r.denoiser_builds == 0
    for _ in range(3):
        r.render_denoised(iterations=1, batch=1)
    assert r.denoiser_builds == 1
    r.render_denoised(iterations=1, batch=1, slot="rt_ldr_alb_nrm")
    assert r.denoiser_builds == 2
    r.render_denoised(iterations=1, batch=1)
    r.render_denoised(iterations=1, batch=1, slot="rt_ldr_alb_nrm")
    assert r.denoiser_builds == 2
    # The number format is looked up at each frame, and keys the kept nets.
    monkeypatch.setattr(denoise_fused, "net_dtype", lambda device: torch.bfloat16)
    r.render_denoised(iterations=1, batch=1)
    assert r.denoiser_builds == 3
    assert set(r._denoisers) == {("rt_ldr_alb", torch.float32),
                                 ("rt_ldr_alb_nrm", torch.float32),
                                 ("rt_ldr_alb", torch.bfloat16)}
    assert _renderer(8).denoiser_builds == 0  # a Renderer keeps its own nets


def test_random_weights_flag_is_kept_on_hits(monkeypatch):
    """The flag of the build is reported on every frame that reuses it."""
    loads = []

    def load(slot, device):
        loads.append(slot)
        net, _ = real(slot, device)
        return net, slot == "rt_ldr_alb"

    real = denoise_fused.load_denoiser
    monkeypatch.setattr(denoise_fused, "load_denoiser", load)
    r = _renderer(8)
    for slot, flag in [("rt_ldr_alb", True), ("rt_ldr_alb", True), ("rt_hdr_alb", False),
                       ("rt_ldr_alb", True), ("rt_hdr_alb", False)]:
        r.render_denoised(iterations=1, batch=1, slot=slot)
        assert r.denoiser_random_weights is flag
    assert loads == ["rt_ldr_alb", "rt_hdr_alb"]


@pytest.mark.requires_cuda
def test_cuda_frames_build_once_and_match_fresh_nets():
    """Eight frames of a CUDA Renderer (graph replays, a move half way):
    one build, the kept net in bfloat16 on the card, and each frame's image
    equal to the one a fresh float32 net, cast in ``denoise_accumulator``,
    makes from the same accumulators."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Renderer's graphs and the bf16 net run there")
    r = _renderer(64, "cuda")
    for i in range(8):
        if i == 4:
            r.move_camera(position=np.asarray(r.scene.state.camera.position) + [0.3, 0.0, 0.0])
        denoised, _ = r.render_denoised(iterations=2, batch=2)
        np.testing.assert_array_equal(denoised, _fresh(r, "rt_ldr_alb"))
    assert r.denoiser_builds == 1
    net, _ = r._denoisers[("rt_ldr_alb", torch.bfloat16)]
    assert all(p.dtype == torch.bfloat16 and p.device.type == "cuda" for p in net.parameters())
