"""K1's share of the FP32 peak, in %: the benchmark's render count
(rtbench/work.py: FP32 operations a sample needs, from the scene and the
configuration's path segments per sample) times the samples of the traced
iterations, over K1's device seconds, over the card's FP32 peak. Nothing
where K1 did not run or the scene has no such count."""

KERNEL = "k1_kernel"


def read(t):
    s = t.device_s(KERNEL, ("render",))
    flops = t.work.get("render_flops_per_sample")
    peak = t.peaks.get("fp32")
    if not t.iterations or s <= 0 or not flops or not peak:
        return None
    return 100.0 * flops * t.iterations * t.pixels / s / peak
