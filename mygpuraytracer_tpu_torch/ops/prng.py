"""K6: the uniform block of the ``pallas`` RNG, as a CUDA kernel.

Counterpart of ``mygpuraytracer_tpu/ops/prng.py``. The TPU kernel
(``_uniform_kernel``) seeded the TPU's hardware PRNG with
``seed * 0x9E3779B1 + b`` for each 2048-column block ``b`` of a ``[k, n]``
block and took ``(bits >> 8) * 2^-24`` per element. That generator cannot be
reproduced anywhere else, so the port defines the stream as a pure counter
function of ``(seed, row, col)``:

- column ``col`` lies in block ``b = col // 2048``, whose stream word is
  ``w = uint32(seed * 0x9E3779B1 + b)``;
- element ``(row, col)`` takes word ``row % 4`` of
  ``philox4x32_10(key=(w, 0), counter=(row // 4, col % 2048, 0, 0))``;
- its value is ``(word >> 8) * 2^-24``: 24-bit mantissas in [0, 1).

Philox4x32-10 is that of Salmon et al., *Parallel Random Numbers: As Easy
as 1, 2, 3* (SC'11) and of the CUDA toolkit's ``curand_philox4x32_x.h``;
one call gives four rows of a column. A value depends only on
``(seed, row, col)``, not on ``k`` or ``n``, so K5 (``csrc/bounce.cu``)
draws the same numbers in-kernel at any (row, pixel). Source of K6:
``csrc/prng.cu``.

``pallas_uniforms`` launches K6 for a CUDA device and counts its launches in
``LAUNCHES`` and on the device (``_build.count_on_device``, which a CUDA
graph's replays move too); for the CPU it runs the plain version,
``uniforms_reference``.
Its seed is an int, passed by value, or that of an iteration counted on the
device, in a CUDA graph (render/graphs.py): a pair (base key, iteration),
from which the kernel (its ``WORDS`` build) derives the seed
``randint(iteration_key(base key, iteration))``, the iteration read from
device memory. ``iteration_uniforms`` is the JAX package's dispatch between
this stream and threefry (``ops/rng.py``); :func:`sample_uniforms` is that
dispatch for an iteration that may be counted on the device.

The threefry block, ``jax.random.uniform(key, (k, n))``, is one CUDA kernel
launch for a CUDA device (:func:`threefry_uniforms`, ``csrc/prng.cu``), bit
for bit ``ops/rng.py``'s plain threefry, which a CPU device runs. Its key
is an iteration's, by value, or derived in the kernel from the base key and
an iteration counted on the device. It replaces no TPU kernel: in int64
ATen ops (torch lacks uint32) the block costs ~350 kernels an iteration.
Its launches are counted in ``THREEFRY_LAUNCHES`` and on the device as
``threefry``.
"""

from __future__ import annotations

import torch

from .. import _build
from . import rng

_BLK = 2048  # columns per stream word (the TPU kernel's grid block)
MIX = 0x9E3779B1  # golden-ratio odd multiplier of the seed

LAUNCHES = 0  # kernel launches from the host since the last reset (a graph capture records one)
THREEFRY_LAUNCHES = 0  # the same, of the threefry kernel


PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl key increments
PHILOX_ROUNDS = 10


def _mulhilo(m: int, x):
    """(hi, lo) words of the 64-bit product of the constant ``m`` and the
    words ``x``, in int64 without overflow: x is split into 16-bit halves,
    so every partial product stays below 2^49."""
    p_lo, p_hi = m * (x & 0xFFFF), m * (x >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & rng.MASK32


def philox4x32_10(k0, k1, c0, c1, c2, c3):
    """Philox4x32-10 on 32-bit words held in int64 tensors or Python ints
    (all values in [0, 2**32)). Returns the four output words."""
    for i in range(PHILOX_ROUNDS):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & rng.MASK32, (k1 + PHILOX_W[1]) & rng.MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms_reference(seed, k: int, n: int, device="cpu", col0: int = 0) -> torch.Tensor:
    """Plain version of K6: the [k, n] float32 block of the counter stream,
    its columns ``col0 .. col0 + n - 1``. ``seed`` takes the forms of
    :func:`pallas_uniforms`'s."""
    col = torch.arange(col0, col0 + n, dtype=torch.int64, device=device)
    if isinstance(seed, tuple):  # (base key, iteration): the seed computed here
        seed = rng.randint(rng.iteration_key(*seed)).to(device)
    seed = seed if isinstance(seed, torch.Tensor) else int(seed)
    word = (rng.mul32(seed & rng.MASK32, MIX) + col // _BLK) & rng.MASK32
    group = torch.arange((k + 3) // 4, dtype=torch.int64, device=device)[:, None]
    words = philox4x32_10(word[None, :], 0, group, (col % _BLK)[None, :], 0, 0)
    rows = torch.stack(torch.broadcast_tensors(*words), dim=1).reshape(-1, n)[:k]
    return (rows >> 8).to(torch.float32) * 2.0**-24


def pallas_uniforms(seed, k: int, n: int, device="cuda", col0: int = 0) -> torch.Tensor:
    """[k, n] U[0, 1) of the counter stream under the int32 ``seed``, its
    columns ``col0 .. col0 + n - 1``: one K6 launch on the current stream
    for a CUDA device, the plain version for the CPU. ``seed`` is an int,
    or a pair (base key, iteration) with ``iteration`` a 0-dim int64 tensor
    on ``device`` counted there: the seed is then ``randint(iteration_key(
    base key, iteration))``, which the kernel derives, reading the iteration
    from device memory."""
    global LAUNCHES
    device = torch.device(device)
    if device.type == "cpu":
        return uniforms_reference(seed, k, n, device, col0)
    if device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or (plain) the CPU, not {device}")
    counted = isinstance(seed, tuple)
    if not counted and not -(2**31) <= int(seed) < 2**31:
        raise ValueError(f"need an int32 seed, got {seed}")
    if k < 0 or n < 0 or col0 < 0:
        raise ValueError(f"need k, n, col0 >= 0, got {k}, {n}, {col0}")
    out = torch.empty((k, n), dtype=torch.float32, device=device)
    if counted:
        base_key, iteration = seed
        _check_counted(iteration, out.device)
    if out.numel() == 0:
        return out
    words = (0, *base_key, iteration.data_ptr()) if counted else (int(seed), 0, 0, None)
    with _build.device_guard(out.device):
        err = _build.library().k6_uniforms(words[0], out.data_ptr(), k, n, int(col0), *words[1:],
                                           _build.stream_handle(out.device))
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    LAUNCHES += 1
    _build.count_on_device("k6", out.device)
    return out


def _check_counted(iteration, device: torch.device) -> None:
    """Raise unless ``iteration`` is a 0-dim int64 tensor on ``device`` (a
    CUDA device), as an iteration counted there is."""
    if not (isinstance(iteration, torch.Tensor) and iteration.dim() == 0
            and iteration.dtype == torch.int64 and iteration.device.type == "cuda"):
        raise ValueError(f"a counted iteration must be a 0-dim int64 CUDA tensor, got "
                         f"{iteration!r}")
    if iteration.device != device:
        raise ValueError(f"the iteration lies on {iteration.device}, the block on {device}")


def threefry_uniforms(key, k: int, n: int, col0: int = 0, count: int | None = None,
                      device="cuda") -> torch.Tensor:
    """Columns ``col0 .. col0 + count - 1`` (all ``n`` by default) of
    ``jax.random.uniform(key, (k, n))``, a [k, count] float32 block: one
    launch of the threefry kernel on the current stream of a CUDA device,
    bit for bit ``rng.uniform_columns``. ``key`` is a key of two int words,
    or a pair (base key, iteration) with ``iteration`` a 0-dim int64 tensor
    on ``device`` counted there: the key is then ``iteration_key(base key,
    iteration)``, which the kernel derives, reading the iteration from
    device memory, so a CUDA graph that records the launch bakes in no
    iteration."""
    global THREEFRY_LAUNCHES
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the threefry kernel runs on CUDA, not {device}")
    count = n - col0 if count is None else count
    if k < 0 or count < 0 or not 0 <= col0 <= n - count:
        raise ValueError(f"need k, count >= 0 and columns {col0} .. {col0 + count - 1} "
                         f"inside [0, {n}), got k = {k}")
    counted = isinstance(key[0], tuple)
    words = key[0] if counted else key
    if not all(isinstance(w, int) and 0 <= w <= rng.MASK32 for w in words):
        raise ValueError(f"need a key of two 32-bit int words, got {words!r}")
    out = torch.empty((k, count), dtype=torch.float32, device=device)
    if counted:
        _check_counted(key[1], out.device)
    if out.numel() == 0:
        return out
    iteration_at = key[1].data_ptr() if counted else None
    with _build.device_guard(out.device):
        err = _build.library().threefry_uniforms(out.data_ptr(), k, count, n, col0, *words,
                                                 iteration_at, _build.stream_handle(out.device))
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    THREEFRY_LAUNCHES += 1
    _build.count_on_device("threefry", out.device)
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
                       device="cuda", pixels: tuple[int, int] | None = None) -> torch.Tensor:
    """One iteration's [k, n] uniforms under the iteration key ``ikey``:
    K6 under the seed ``randint(ikey)`` where :func:`uniforms_mode` says
    "pallas", else ``jax.random.uniform(ikey, (k, n))``, the threefry
    kernel's for a CUDA device. ``pixels`` = (p0, count) gives only the
    columns p0 .. p0 + count - 1 of that block, bit for bit ([k, count]).
    ``iteration`` is unused, as in the JAX package."""
    del iteration
    p0, count = pixels if pixels is not None else (0, n)
    if uniforms_mode(options, device) == "pallas":
        return pallas_uniforms(rng.randint(ikey), k, count, device, col0=p0)
    if torch.device(device).type == "cuda":
        return threefry_uniforms(ikey, k, n, p0, count, device)
    if pixels is None:
        return rng.uniform(ikey, (k, n), device)
    return rng.uniform_columns(ikey, k, n, p0, count, device)


def sample_uniforms(options, base_key: rng.Key, iteration, k: int, n: int, device="cuda",
                    pixels: tuple[int, int] | None = None) -> torch.Tensor:
    """:func:`iteration_uniforms` under ``iteration_key(base_key,
    iteration)``, for an int ``iteration`` or one counted on the device (a
    0-dim int64 tensor). On a CUDA device the latter's key is not computed
    here: K6 derives its seed, or the threefry kernel its key, from
    ``base_key`` and the iteration it reads from device memory. On the CPU
    its key words are tensors (``rng.iteration_key``)."""
    if isinstance(iteration, torch.Tensor) and torch.device(device).type == "cuda":
        p0, count = pixels if pixels is not None else (0, n)
        if uniforms_mode(options, device) == "pallas":
            return pallas_uniforms((base_key, iteration), k, count, device, col0=p0)
        return threefry_uniforms((base_key, iteration), k, n, p0, count, device)
    return iteration_uniforms(options, rng.iteration_key(base_key, iteration), iteration, k, n,
                              device, pixels)
