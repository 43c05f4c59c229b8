"""Device idle share of a four-card converge job's traced slices (the job's
reset, its multichip render and sum, and its end on the first card):
1 - (device seconds of every operation, summed over the cards) / (4 x the
host wall). The union that ``idle_share.converge`` reads is busy while any
one card is."""

CARDS = 4
ROLES = ("render", "finish")


def read(t):
    wall = t.wall_s(ROLES)
    if not t.iterations or wall <= 0:
        return None
    return 1.0 - t.device_s("", ROLES) / (CARDS * wall)
