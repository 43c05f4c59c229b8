"""Kernels on the card per iteration of the wavefront (render/pathtrace.py,
render/shade.py, ops/trace.py), over the traced render slice; only where
the Renderer's route is the wavefront."""


def read(t):
    if t.route != "wavefront" or not t.iterations:
        return None
    return t.kernels(("render",)) / t.iterations
