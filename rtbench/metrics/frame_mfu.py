"""The preview's share of the bf16 peak, in %: the U-Net's FLOPs per frame
(rtbench/work.py's frozen table of OIDN's convs at the frame's size) times
the traced frames, over their host wall, over the card's bf16 peak."""


def read(t):
    flops = t.work.get("unet_flops_per_frame")
    peak = t.peaks.get("bf16")
    wall = t.wall_s(("frames",))
    if not t.frames or not flops or not peak or wall <= 0:
        return None
    return 100.0 * flops * t.frames / wall / peak
