"""The Filter's "mesh" parameter (``denoise/filter.py``) against the port's
single device and the JAX package's mesh Filter, on the CPU.

Mirrors ``tests/test_parallel.py::test_sharded_filter_execute_matches_single``:
520^2 at ``maxMemoryMB=0`` (several tiles), the port's mesh ``("cpu",) *
8`` and ``* 3`` (a tile table that pads with no-op rows). Tolerances: bit
for bit against the port's single-device execute (every pixel has one
writer); within the Filter tests' bar (atol 1e-5, rtol 1e-4) of JAX's mesh
Filter on its 8 virtual devices.
"""

import numpy as np
import pytest
import torch

import jax

from mygpuraytracer_tpu.denoise import Device as JaxDevice
from mygpuraytracer_tpu.parallel.mesh import make_mesh as jax_make_mesh

from mygpuraytracer_tpu_torch.denoise import Device, DeviceBuffer
from mygpuraytracer_tpu_torch.parallel import make_mesh

FILTER_ATOL, FILTER_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(8)


def _denoise(dev, color, albedo, mesh=None, buffers=False, **params):
    f = dev.new_filter("RT")
    wrap = (lambda a: DeviceBuffer(a, device="cpu")) if buffers else (lambda a: a.copy())
    f.set_image("color", wrap(color))
    f.set_image("albedo", wrap(albedo))
    out = wrap(np.zeros_like(color))
    f.set_image("output", out)
    for k, v in params.items():
        f.set(k, v)
    if mesh is not None:
        f.set("mesh", mesh)
    f.commit()
    f.execute()
    return out.numpy() if buffers else out


@pytest.fixture(scope="module")
def filter_inputs():
    g = np.random.default_rng(7)
    n = 520
    return (g.uniform(0.0, 1.0, (n, n, 3)).astype(np.float32),
            g.uniform(0.0, 1.0, (n, n, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def filter_single(filter_inputs):
    dev = Device("cpu")
    dev.commit()
    return _denoise(dev, *filter_inputs, maxMemoryMB=0)


@pytest.mark.parametrize("size,buffers", [(8, False), (3, True)])
def test_filter_mesh_is_bitwise_the_single_device(size, buffers, filter_inputs, filter_single):
    """520^2 at maxMemoryMB=0: 4x4 tiles; over 3 devices the table pads
    with two no-op rows, with DeviceBuffers in and out."""
    dev = Device("cpu")
    dev.commit()
    out = _denoise(dev, *filter_inputs, mesh=make_mesh(devices=("cpu",) * size),
                   buffers=buffers, maxMemoryMB=0)
    assert np.isfinite(out).all()
    assert np.array_equal(out, filter_single)


def test_filter_mesh_matches_jax_mesh(filter_inputs, filter_single, jax_mesh):
    jdev = JaxDevice()
    jdev.commit()
    want = _denoise(jdev, *filter_inputs, mesh=jax_mesh, maxMemoryMB=0)
    dev = Device("cpu")
    dev.commit()
    got = _denoise(dev, *filter_inputs, mesh=make_mesh(devices=("cpu",) * 8), maxMemoryMB=0)
    np.testing.assert_allclose(got, want, atol=FILTER_ATOL, rtol=FILTER_RTOL)
