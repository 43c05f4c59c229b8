"""Device milliseconds of the mesh kernel (csrc/mesh_hit.cu, kernel
``mesh_hit_kernel``) per iteration, over the traced render slice; nothing
where it did not run."""

KERNEL = "mesh_hit_kernel"


def read(t):
    s = t.device_s(KERNEL, ("render",))
    if not t.iterations or s <= 0:
        return None
    return 1e3 * s / t.iterations
