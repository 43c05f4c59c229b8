"""Weights acquisition and the feature -> weights selection table.

Search order for ``<name>.tza``:

1. ``$MYGPURAYTRACER_TPU_WEIGHTS_DIR``
2. ``<repo>/weights`` (the directory beside this package)

Archives that fail to parse (git-LFS pointer stubs) are skipped. If nothing
valid is found, deterministic randomly-initialized weights are returned,
flagged by the second tuple element, so the pipeline stays runnable.
"""

from __future__ import annotations

import os
import zlib

from .tza import read_tza
from .unet import init_unet_tensors

# input channel count per weights blob (unet.cpp feature selection)
WEIGHTS_CHANNELS = {
    "rt_hdr": 3,
    "rt_ldr": 3,
    "rt_hdr_alb": 6,
    "rt_ldr_alb": 6,
    "rt_hdr_alb_nrm": 9,
    "rt_ldr_alb_nrm": 9,
    "rt_hdr_calb_cnrm": 9,
    "rt_ldr_calb_cnrm": 9,
    "rt_alb": 3,
    "rt_nrm": 3,
    "rtlightmap_hdr": 3,
    "rtlightmap_dir": 3,
}

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_cache: dict[str, tuple[dict, bool]] = {}


def search_dirs() -> list[str]:
    dirs = []
    env = os.environ.get("MYGPURAYTRACER_TPU_WEIGHTS_DIR")
    if env:
        dirs.append(env)
    dirs.append(os.path.join(os.path.dirname(_PKG_ROOT), "weights"))
    return dirs


def load_default_params(name: str) -> tuple[dict, bool]:
    """Returns ({tensor name: (array, layout)}, used_random_init); build the
    net with ``UNet.from_tza``."""
    if name in _cache:
        return _cache[name]
    if name not in WEIGHTS_CHANNELS:
        raise ValueError(f"unknown weights blob '{name}'")
    for d in search_dirs():
        path = os.path.join(d, f"{name}.tza")
        if os.path.isfile(path):
            try:
                tensors = read_tza(path)
            except ValueError:
                continue  # LFS stub or corrupt
            _cache[name] = (tensors, False)
            return _cache[name]
    # Seeded by the blob name; crc32, not hash(), which Python salts per process.
    seed = zlib.crc32(name.encode()) % (2**31)
    _cache[name] = (init_unet_tensors(WEIGHTS_CHANNELS[name], seed=seed), True)
    return _cache[name]


def load_params_from_blob(blob: bytes) -> tuple[dict, bool]:
    """User-provided weights (``Filter.set_data("weights", blob)``): the
    TZA archive's tensors, as ``load_default_params`` returns them."""
    return read_tza(blob), False
