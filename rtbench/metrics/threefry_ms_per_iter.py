"""Device milliseconds of the wavefront's threefry block (csrc/prng.cu,
kernel ``threefry_uniforms_kernel``) per iteration, over the traced render
slice; nothing where it did not run."""

KERNEL = "threefry_uniforms_kernel"


def read(t):
    s = t.device_s(KERNEL, ("render",))
    if not t.iterations or s <= 0:
        return None
    return 1e3 * s / t.iterations
