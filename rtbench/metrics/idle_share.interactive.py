"""Device idle share of the traced preview frames: 1 - (union of device
operation intervals) / (host wall)."""

ROLES = ("frames",)


def read(t):
    if not t.frames or t.wall_s(ROLES) <= 0:
        return None
    return 1.0 - t.busy_s(ROLES) / t.wall_s(ROLES)
