"""The work counts: the frozen U-Net table against a hand count, and the
render count's arithmetic."""

from __future__ import annotations

import pytest

from rtbench import work


def test_unet_flops_hand_count_at_800x800():
    # per level: sum of cin * cout over its convs (6 input channels)
    full = 6 * 32 + 32 * 32 + (64 + 6) * 64 + 64 * 32 + 32 * 3  # 800 x 800
    half = 32 * 48 + (96 + 32) * 64 + 64 * 64  # 400 x 400
    quarter = 48 * 64 + (112 + 48) * 96 + 96 * 96  # 200 x 200
    eighth = 64 * 80 + (96 + 64) * 112 + 112 * 112  # 100 x 100
    sixteenth = 80 * 96 + 96 * 96  # 50 x 50
    hand = 2 * 9 * (full * 640000 + half * 160000 + quarter * 40000 + eighth * 10000
                    + sixteenth * 2500)
    assert work.unet_flops(800, 800, 6) == hand
    assert hand == pytest.approx(0.157e12, rel=0.01)


def test_unet_pads_to_16():
    assert work.unet_flops(801, 799, 6) == work.unet_flops(816, 800, 6)


def test_render_count():
    prims = ["cube"] * 6 + ["sphere"]
    per_segment = 6 * work.PRIMITIVE_TEST["cube"] + work.PRIMITIVE_TEST["sphere"] + work.SHADE
    assert work.render_flops_per_sample(prims, 2.0) == work.RAYGEN + 2.0 * per_segment
    assert work.render_flops_per_sample(prims + ["obj"], 2.0) is None


def test_peaks():
    assert work.peaks("NVIDIA H100 80GB HBM3")["fp32"] == 67e12
    assert work.peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert work.peaks("cpu") == {}
