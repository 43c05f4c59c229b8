"""Device-busy milliseconds per iteration of the wavefront (the union of
device operation intervals), over the traced render slice."""


def read(t):
    if t.route != "wavefront" or not t.iterations:
        return None
    return 1e3 * t.busy_s(("render",)) / t.iterations
