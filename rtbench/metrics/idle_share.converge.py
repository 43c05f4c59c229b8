"""Device idle share of a converge job's traced slices (its reset and first
iterations, and its end): 1 - (seconds in which a device operation ran, the
union of their intervals) / (host wall)."""

ROLES = ("render", "finish")


def read(t):
    if not t.iterations or t.wall_s(ROLES) <= 0:
        return None
    return 1.0 - t.busy_s(ROLES) / t.wall_s(ROLES)
