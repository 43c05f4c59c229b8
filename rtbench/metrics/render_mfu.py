"""The whole converge job's share of the FP32 peak, in %: the render count
(rtbench/work.py) times the samples of the traced iterations, over the
host wall of the traced slices (render and finish), over the FP32 peak."""


def read(t):
    flops = t.work.get("render_flops_per_sample")
    peak = t.peaks.get("fp32")
    wall = t.wall_s(("render", "finish"))
    if not t.iterations or not flops or not peak or wall <= 0:
        return None
    return 100.0 * flops * t.iterations * t.pixels / wall / peak
