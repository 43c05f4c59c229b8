"""Kernel and graph launches the host made (``cudaLaunchKernel``,
``cudaGraphLaunch`` and their kin) per iteration, over the traced render
slice of a converge job (its reset and first traced iterations, the eager
first iteration among them)."""


def read(t):
    if not t.iterations:
        return None
    return t.launches(("render",)) / t.iterations
