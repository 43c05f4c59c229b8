"""Counter-based RNG: threefry2x32, bit-exact with ``jax.random``.

Reproduces ``jax.random.key``, ``fold_in`` and ``uniform`` (float32) as JAX
0.9 computes them with ``jax_threefry_partitionable`` on:

- a key is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``;
- ``split(key, num)`` gives key ``i`` = ``threefry2x32(key, (0, i))``;
- the bits of element ``i`` of a shape (row-major flat index) are
  ``y0 ^ y1`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
- a uniform is ``bitcast((bits >> 9) | 0x3F800000) - 1``.

The path tracer draws one ``[4 + 3*depth, N]`` block per iteration under
``fold_in(key(seed), iteration)`` (render/pathtrace.py), so the wavefront
and the K1 CUDA kernel (which runs the same hash per draw) see the same
numbers as the JAX package's wavefront.

Words are carried in int64 tensors (or Python ints) masked to 32 bits, since
torch has no full set of uint32 ops; :func:`threefry2x32` takes either.

A key's words may themselves be tensors: :func:`iteration_key` of an
iteration counted on the device (an int64 tensor, 0-dim or a batch) gives
tensor words, and :func:`fold_in`, :func:`bounce_key`, :func:`randint` and
the draws keep them on the device with no host sync, so that a CUDA graph
can record an iteration whose number it reads from device memory
(render/graphs.py). Both forms give the same bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on 32-bit words held in int64 tensors or
    Python ints (all values in [0, 2**32)). Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def make_key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed that fits int32 (JAX's default
    32-bit mode): the high word is 0 and the low word is the seed's bits."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return (0, seed & MASK32)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``; tensor words (of the key or of
    ``data``, an int64 tensor) stay tensors."""
    data = data & MASK32 if _is_tensor(data) else int(data) & MASK32
    y0, y1 = threefry2x32(key[0], key[1], 0, data)
    if _is_tensor(y0):
        return (y0, y1)
    return (int(y0), int(y1))


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)``: key ``i`` is the word pair of
    ``threefry2x32(key, (0, i))``."""
    return [fold_in(key, i) for i in range(num)]


def mul32(a, b):
    """``(a * b) mod 2**32`` of words below 2**32 without int64 overflow."""
    return ((((a >> 16) * b & 0xFFFF) << 16) + (a & 0xFFFF) * b) & MASK32


def _randint_words(higher, lower, minval: int, maxval: int):
    """``jax/_src/random.py::_randint``'s reduction of two 32-bit words
    (Python ints or int64 tensors) into ``[minval, maxval)``: uint32
    arithmetic that wraps, then the int32 view."""
    if not -(2**31) <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"need int32 bounds with minval < maxval, got {minval}, {maxval}")
    span = (maxval - minval) & MASK32
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (mul32(higher % span, multiplier) + lower % span) & MASK32
    value = (minval + offset % span) & MASK32
    return value - ((value >> 31) << 32)


def randint(key: Key, minval: int = 0, maxval: int = 2**31 - 1):
    """``jax.random.randint(key, (), minval, maxval, dtype=int32)`` for
    ``minval < maxval`` within int32, as ``jax/_src/random.py::_randint``
    computes it: two 32-bit words under ``split(key)`` (element 0 of a draw
    under each key), reduced modulo the span with uint32 arithmetic that
    wraps. An int for a key of ints (computed on ints alone); for tensor
    words, an int64 tensor of their shape, one per key."""
    if _is_tensor(key[0]):
        w0, w1 = split_words(key, 2)
        y0, y1 = threefry2x32(w0, w1, 0, 0)
        bits = y0 ^ y1
        return _randint_words(bits[..., 0], bits[..., 1], minval, maxval)
    higher, lower = (int(y0 ^ y1) for y0, y1 in
                     (threefry2x32(k[0], k[1], 0, 0) for k in split(key)))
    return _randint_words(higher, lower, minval, maxval)


def split_words(key, num: int):
    """``jax.random.split`` of a key whose words may be int64 tensors (a batch
    of keys): the words of ``num`` keys on a new last axis."""
    k0, k1 = key
    if not _is_tensor(k0):
        return threefry2x32(k0, k1, 0, torch.arange(num, dtype=torch.int64))
    idx = torch.arange(num, dtype=torch.int64, device=k0.device)
    return threefry2x32(k0[..., None], k1[..., None], 0, idx)


def _shaped_bits(key, shape, device):
    """The 32-bit words of a draw of ``shape`` under ``key`` (int words, or
    int64 tensors for a batch of keys, whose shape leads the result)."""
    shape = tuple(shape)
    numel = 1
    for s in shape:
        numel *= s
    k0, k1 = key
    if isinstance(k0, torch.Tensor):
        device = k0.device
        k0, k1 = k0[..., None], k1[..., None]
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & MASK32)
    bits = y0 ^ y1
    return bits.reshape(bits.shape[:-1] + shape)


def randint_shaped(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)`` as an
    int64 tensor; ``key`` may be a batch of keys (:func:`split_words`)."""
    w0, w1 = split_words(key, 2)
    higher = _shaped_bits((w0[..., 0], w1[..., 0]), shape, device)
    lower = _shaped_bits((w0[..., 1], w1[..., 1]), shape, device)
    return _randint_words(higher, lower, minval, maxval)


def bernoulli(key, p: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: float32
    uniforms below ``p``; ``key`` may be a batch of keys."""
    return bits_to_uniform(_shaped_bits(key, shape, device)) < p


def random_bits(key: Key, numel: int, device="cpu", offset: int = 0) -> torch.Tensor:
    """32-bit random words (int64 tensor) of flat elements
    ``offset .. offset + numel - 1`` of a draw under ``key`` (a key of
    0-dim tensor words draws on their device)."""
    if _is_tensor(key[0]):
        device = key[0].device
    idx = torch.arange(offset, offset + numel, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return y0 ^ y1


def uniform_columns(key: Key, rows: int, n: int, p0: int, count: int,
                    device="cpu") -> torch.Tensor:
    """Columns ``p0 .. p0 + count - 1`` of ``uniform(key, (rows, n))``:
    element (r, c) is flat element ``r * n + p0 + c`` of the draw, so the
    slice equals those columns of the whole block bit for bit (the pixel
    range of a sharded render)."""
    if not 0 <= p0 <= n - count:
        raise ValueError(f"columns {p0} .. {p0 + count - 1} lie outside [0, {n})")
    if _is_tensor(key[0]):
        device = key[0].device
    idx = (torch.arange(rows, dtype=torch.int64, device=device)[:, None] * n
           + torch.arange(p0, p0 + count, dtype=torch.int64, device=device)[None, :])
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return bits_to_uniform(y0 ^ y1)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform in [0, 1) from 32-bit words."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype=float32)``."""
    shape = tuple(shape)
    numel = 1
    for s in shape:
        numel *= s
    return bits_to_uniform(random_bits(key, numel, device)).reshape(shape)


def iteration_key(base_key: Key, iteration) -> Key:
    """Key for one camera sample (MC iteration): ``fold_in(base_key,
    iteration)``. ``iteration`` is an int, or an int64 tensor of
    iterations counted on the device (0-dim, or a batch), whose key words
    are tensors of its shape on its device."""
    return fold_in(base_key, iteration)


def bounce_key(iter_key: Key, depth: int) -> Key:
    """Key for bounce ``depth`` of one iteration: ``fold_in(iter_key, depth)``."""
    return fold_in(iter_key, depth)


def bounce_uniforms(iter_key: Key, depth: int, n: int, m: int, device="cpu") -> torch.Tensor:
    """[n, m] U[0, 1) for bounce ``depth``: ``jax.random.uniform`` of
    :func:`bounce_key` (m uniforms per ray, the reference's fixed per-bounce
    draw pattern, interactions.h)."""
    return uniform(bounce_key(iter_key, depth), (n, m), device)
