"""Stream compaction and the material sort, at fixed sizes.

Counterpart of ``mygpuraytracer_tpu/ops/compaction.py``: the reference's
stream_compaction library (efficient.cu map -> scan -> scatter) and the
render loop's thrust::stable_partition / sort_by_key calls
(pathtrace.cu:590,612,649), as stock PyTorch ops. Buffers keep their size:
``compact`` packs the live elements to the front and returns their count.

Index dtypes follow the JAX functions: scans of int32 (or bool) stay int32,
and ``compact``'s count and ``material_sort_perm`` are int32, although
``torch.cumsum`` and ``torch.sort`` would hand back int64.
"""

from __future__ import annotations

import torch


def _scan_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype ``jnp.cumsum`` returns: int32 for bool and narrow ints."""
    if x.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32):
        return torch.int32
    return x.dtype


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along axis 0 (efficient.cu:35-113's Blelloch
    scan, as one ``cumsum``)."""
    dtype = _scan_dtype(x)
    return torch.cumsum(x, 0, dtype=dtype) - x.to(dtype)


def compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Stable partition: the elements where ``mask`` holds move to the front
    of each array in order, the others follow in order
    (thrust::stable_partition, pathtrace.cu:649). Returns (count, packed
    arrays...), count an int32 0-d tensor."""
    mask = mask.to(torch.int32)
    count = mask.sum(dtype=torch.int32)
    n = mask.shape[0]
    live_pos = exclusive_scan(mask)
    dead_pos = exclusive_scan(1 - mask)
    dest = torch.where(mask == 1, live_pos, count + dead_pos)
    perm = _inverse(dest, n)
    return (count, *(a[perm] for a in arrays))


def _inverse(dest: torch.Tensor, n: int) -> torch.Tensor:
    """The permutation ``perm`` with ``perm[dest[i]] = i`` (int32)."""
    perm = torch.zeros(n, dtype=torch.int32, device=dest.device)
    return perm.index_put_((dest.to(torch.int64),),
                           torch.arange(n, dtype=torch.int32, device=dest.device))


def sort_by_material_key(material_id: torch.Tensor, *arrays: torch.Tensor):
    """Stable sort of wavefront arrays by DESCENDING material id
    (thrust::sort_by_key with the sortByMaterial comparator,
    pathtrace.cu:512-516): returns (sorted ids, sorted arrays...)."""
    out = lax_sort_by_neg_key(-material_id, arrays)
    return (-out[0], *out[1:])


def lax_sort_by_neg_key(neg_key: torch.Tensor, arrays):
    """Co-sort ``arrays`` by ascending ``neg_key``, stably: JAX's variadic
    ``lax.sort`` as one stable ``torch.sort`` of the key and one gather of
    each array through the indices it returns (PyTorch has no variadic
    sort). Returns (sorted key, sorted arrays...)."""
    key, order = torch.sort(neg_key, stable=True)
    return (key, *(a[order] for a in arrays))


def material_sort_perm(material_id: torch.Tensor, num_materials: int) -> torch.Tensor:
    """Stable DESCENDING-material permutation by counting sort: ``perm``
    (int32) with ``sorted[i] = orig[perm[i]]``, equal to a stable argsort of
    ``-material_id``, from one cumsum per material and one inverse
    scatter. Material ids lie in ``[0, num_materials)`` (misses are 0)."""
    n = material_id.shape[0]
    dest = torch.zeros(n, dtype=torch.int32, device=material_id.device)
    offset = torch.zeros((), dtype=torch.int32, device=material_id.device)
    for m in range(num_materials - 1, -1, -1):
        is_m = material_id == m
        im = is_m.to(torch.int32)
        dest = torch.where(is_m, offset + exclusive_scan(im), dest)
        offset = offset + im.sum(dtype=torch.int32)
    return _inverse(dest, n)
