"""The four-card converge job's share of the four cards' FP32 peak, in %:
the render count (rtbench/work.py) times the samples of the traced
iterations, over the host wall of the traced slices (render and finish),
over 4 x the card's FP32 peak."""

CARDS = 4


def read(t):
    flops = t.work.get("render_flops_per_sample")
    peak = t.peaks.get("fp32")
    wall = t.wall_s(("render", "finish"))
    if not t.iterations or not flops or not peak or wall <= 0:
        return None
    return 100.0 * flops * t.iterations * t.pixels / wall / (CARDS * peak)
