"""The wavefront's nearest cube or sphere: one CUDA kernel a bounce.

``ops/trace.py::intersect_primitives_soa`` tests each cube and sphere of
the scene with ~200 elementwise PyTorch ops and selects the running hit and
its material field by field: ~1,600 kernels a bounce on CUDA tensors. The
kernel (``csrc/prims_hit.cu``) computes the same running hit in one launch
from the scene's ``prim_table`` (``scene/device_scene.py::
primitive_table``), bit for bit, one thread a lane. It replaces no kernel
of the JAX package, whose function is plain jnp.

:func:`prims_hit` launches it for CUDA tensors and counts its launches in
``LAUNCHES`` and on the device (``_build.count_on_device``, which a CUDA
graph's replays move too). It returns one float32 tensor of ``OUT_F``
rows, one int32 tensor of ``OUT_I`` rows and one zero word, all views of
one buffer; ``ops/trace.py::nearest_primitives`` turns them into the
running hit (the zero word expanded into the texcoords and ``is_obj``,
which no cube or sphere sets), and runs the plain version on CPU
tensors.
"""

from __future__ import annotations

import torch

from ..scene.device_scene import PRIM_COLS
from .vec3 import Vec3

# float32 rows: t, normal xyz, color xyz, spec color xyz, spec exponent,
# reflective, refractive, ior, emittance.
OUT_F = 15
# int32 rows: material id, kd, ks, ke, bump.
OUT_I = 5

LAUNCHES = 0  # kernel launches from the host since the last reset (a graph capture records one)


def prims_hit(table: torch.Tensor, o: Vec3, d: Vec3):
    """The nearest of the cubes and spheres in ``table`` [P, PRIM_COLS] for
    each ray (o, d: Vec3s of float32 [N] CUDA tensors, each with any stride:
    the camera's origins are expanded scalars): ``(rows_f [OUT_F, N],
    rows_i [OUT_I, N], zero [1])``, one launch on the current stream."""
    global LAUNCHES
    lanes = (*o, *d)
    n = o.x.shape[0] if o.x.dim() == 1 else -1
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"the primitive kernel runs on CUDA tensors, not {device}")
    if table.dim() != 2 or table.shape[1] != PRIM_COLS:
        raise ValueError(f"table must be [P, {PRIM_COLS}], got {tuple(table.shape)}")
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous float32 tensor on {device}")
    for name, x in zip(("ox", "oy", "oz", "dx", "dy", "dz"), lanes):
        if x.device != device or x.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 tensor on {device}")
    if n <= 0 or any(tuple(x.shape) != (n,) for x in lanes):
        raise ValueError(f"the rays must be six [N] tensors with N > 0, got "
                         f"{[tuple(x.shape) for x in lanes]}")
    buf = torch.empty((OUT_F + OUT_I) * n + 1, dtype=torch.float32, device=device)
    rows_f = buf[:OUT_F * n].view(OUT_F, n)
    rows_i = buf[OUT_F * n:(OUT_F + OUT_I) * n].view(torch.int32).view(OUT_I, n)
    zero = buf[(OUT_F + OUT_I) * n:]

    from .._build import count_on_device, device_guard, library, stream_handle

    with device_guard(device):
        err = library().prims_hit(
            *(x.data_ptr() for x in lanes), *(x.stride(0) for x in lanes), table.data_ptr(),
            table.shape[0], rows_f.data_ptr(), rows_i.data_ptr(), zero.data_ptr(), n,
            stream_handle(device))
    if err != 0:
        raise RuntimeError(f"primitive kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    count_on_device("prims_hit", device)
    return rows_f, rows_i, zero
