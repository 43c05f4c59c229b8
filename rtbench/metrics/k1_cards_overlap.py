"""Cards rendering at once: K1's device seconds (kernel ``k1_kernel``),
summed over the cards, over the host wall of the traced render slice. It
reads near the number of cards when their launches run together and at
most 1 when they run one after another; nothing where K1 did not run."""

KERNEL = "k1_kernel"


def read(t):
    s = t.device_s(KERNEL, ("render",))
    wall = t.wall_s(("render",))
    if not t.iterations or s <= 0 or wall <= 0:
        return None
    return s / wall
