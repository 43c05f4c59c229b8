"""Device meshes: one process driving an ordered tuple of torch devices.

The port's counterpart of ``mygpuraytracer_tpu/parallel/mesh.py``. A JAX
``Mesh`` is single-controller: one process holds it, and every API that
takes one (``render_multichip_sample``, ``Filter.set("mesh", m)``,
``train(cfg, mesh)``) takes it as an in-process object. So here a
:class:`Mesh` is an ordered tuple of ``torch.device`` named by an axis, and
the work is split by launching each device's share from this one process.
It is not ``torch.distributed``: that needs a process per device, NCCL
refuses two ranks on one card, and gloo has no ``all_gather`` of CUDA
tensors.

An entry may repeat (``("cuda:0", "cuda:0")`` splits the work over one
card; ``("cpu",) * 8`` is the tests' stand-in for 8 devices). A psum
(:func:`psum`) is a sum of the per-device tensors onto the first device, in
device order.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in order, named by ``axis_names``; ``shape`` lays them out
    (1-D: one axis over all of them)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("dp",)
    shape: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        shape = self.shape or (len(self.devices),)
        n = 1
        for s in shape:
            n *= s
        if n != len(self.devices) or len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} over axes {self.axis_names} does not fit "
                             f"{len(self.devices)} devices")
        object.__setattr__(self, "shape", tuple(shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def make_mesh(num_devices: int | None = None, axis: str = "dp", devices=None) -> Mesh:
    """1-D mesh over the first ``num_devices`` of ``devices`` (default:
    every visible CUDA device)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. ('cpu',) * 8)")
        devices = [f"cuda:{i}" for i in range(count)]
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(tuple(resolve_device(d) for d in devices), (axis,))


def make_mesh_2d(shape: tuple[int, int], axes=("dp", "sp"), devices=None) -> Mesh:
    """2-D mesh of ``shape`` over the first shape[0] * shape[1] devices."""
    mesh = make_mesh(shape[0] * shape[1], devices=devices)
    if mesh.size != shape[0] * shape[1]:
        raise ValueError(f"mesh shape {shape} needs {shape[0] * shape[1]} devices, "
                         f"got {mesh.size}")
    return Mesh(mesh.devices, tuple(axes), tuple(shape))


def to_device(tree, device):
    """Every tensor of a (nested) tuple, NamedTuple, list or dict on
    ``device``; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per mesh device (a tensor already there is not
    copied)."""
    return [to_device(tree, d) for d in mesh.devices]


def sum_onto(tensors, device) -> torch.Tensor:
    """The sum of ``tensors`` on ``device``, added in their order."""
    tensors = list(tensors)
    total = tensors[0].to(device)
    for t in tensors[1:]:
        total = total + t.to(device)
    return total


def psum(tensors, mesh: Mesh) -> torch.Tensor:
    """The sum of the per-device ``tensors``, on the first device, added in
    device order."""
    tensors = list(tensors)
    if len(tensors) != mesh.size:
        raise ValueError(f"psum takes one tensor per device ({mesh.size}), got {len(tensors)}")
    return sum_onto(tensors, mesh.first)


def split(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """Device d's (start, count) of ``n`` items cut in ``mesh.size`` equal
    contiguous shares; ValueError when they do not divide."""
    if n % mesh.size:
        raise ValueError(f"{n} does not divide evenly over {mesh.size} devices")
    per = n // mesh.size
    return [(d * per, per) for d in range(mesh.size)]
