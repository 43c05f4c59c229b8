"""K6: the uniform block of the ``pallas`` RNG, as a CUDA kernel.

Counterpart of ``mygpuraytracer_tpu/ops/prng.py``. The TPU kernel
(``_uniform_kernel``) seeded the TPU's hardware PRNG with
``seed * 0x9E3779B1 + b`` for each 2048-column block ``b`` of a ``[k, n]``
block and took ``(bits >> 8) * 2^-24`` per element. That generator cannot be
reproduced anywhere else, so the port defines the stream as a pure counter
function of ``(seed, row, col)``:

- column ``col`` lies in block ``b = col // 2048``, whose stream word is
  ``w = uint32(seed * 0x9E3779B1 + b)``;
- element ``(row, col)`` takes the bits ``y0 ^ y1`` of
  ``threefry2x32(key=(0, w), counter=(row, col % 2048))``;
- its value is ``(bits >> 8) * 2^-24``: 24-bit mantissas in [0, 1).

A value depends only on ``(seed, row, col)``, not on ``k`` or ``n``, so K5
(``csrc/bounce.cu``) draws the same numbers in-kernel at any (row, pixel).
Source of K6: ``csrc/prng.cu``.

``pallas_uniforms`` launches K6 for a CUDA device and counts its launches in
``LAUNCHES``; for the CPU it runs the plain version, ``uniforms_reference``.
``iteration_uniforms`` is the JAX package's dispatch between this stream and
threefry (``ops/rng.py``).
"""

from __future__ import annotations

import torch

from . import rng

_BLK = 2048  # columns per stream word (the TPU kernel's grid block)
MIX = 0x9E3779B1  # golden-ratio odd multiplier of the seed

LAUNCHES = 0  # kernel launches since the last reset


def uniforms_reference(seed: int, k: int, n: int, device="cpu") -> torch.Tensor:
    """Plain version of K6: the [k, n] float32 block of the counter stream."""
    col = torch.arange(n, dtype=torch.int64, device=device)
    word = ((int(seed) & rng.MASK32) * MIX + col // _BLK) & rng.MASK32
    row = torch.arange(k, dtype=torch.int64, device=device)[:, None]
    y0, y1 = rng.threefry2x32(0, word[None, :], row, (col % _BLK)[None, :])
    return ((y0 ^ y1) >> 8).to(torch.float32) * 2.0**-24


def pallas_uniforms(seed: int, k: int, n: int, device="cuda") -> torch.Tensor:
    """[k, n] U[0, 1) of the counter stream under the int32 ``seed``: one K6
    launch on the current stream for a CUDA device, the plain version for
    the CPU."""
    global LAUNCHES
    device = torch.device(device)
    if device.type == "cpu":
        return uniforms_reference(seed, k, n, device)
    if device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or (plain) the CPU, not {device}")
    if not -(2**31) <= int(seed) < 2**31 or k < 0 or n < 0:
        raise ValueError(f"need an int32 seed and k, n >= 0, got {seed}, {k}, {n}")
    out = torch.empty((k, n), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out

    from .._build import library

    err = library().k6_uniforms(int(seed), out.data_ptr(), k, n,
                                torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def uniforms_mode(options, device) -> str:
    """Which stream ``iteration_uniforms`` draws: ``"pallas"`` (K6's counter
    stream) for ``rng`` "pallas" or "auto" off the CPU, else ``"threefry"``,
    as the JAX package dispatches (``ops/prng.py::iteration_uniforms``)."""
    mode = getattr(options, "rng", "auto")
    if mode in ("pallas", "auto") and torch.device(device).type != "cpu":
        return "pallas"
    return "threefry"


def iteration_uniforms(options, ikey: rng.Key, iteration: int, k: int, n: int,
                       device="cuda") -> torch.Tensor:
    """One iteration's [k, n] uniforms under the iteration key ``ikey``:
    K6 under the seed ``randint(ikey)`` where :func:`uniforms_mode` says
    "pallas", else ``jax.random.uniform(ikey, (k, n))``. ``iteration`` is
    unused, as in the JAX package."""
    del iteration
    if uniforms_mode(options, device) == "pallas":
        return pallas_uniforms(rng.randint(ikey), k, n, device)
    return rng.uniform(ikey, (k, n), device)
