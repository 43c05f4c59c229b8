"""Export trained U-Net params to the TZA runtime weights format.

The port of ``mygpuraytracer_tpu/train/export.py`` (training/export.py:28-65):
conv weights as 'oihw', biases as 'x', each 64-byte aligned; the archive is
byte for byte the JAX package's for the same params, and both packages (and
the Filter's ``set_data("weights", ...)``) read it.
"""

from __future__ import annotations

import numpy as np

from ..denoise.tza import write_tza


def export_weights(params: dict, path: str) -> None:
    """Write ``{name: {'w': HWIO, 'b': [O]}}`` (numpy, as the trainers
    return them) to ``path``."""
    tensors = {}
    for name, p in params.items():
        w = np.asarray(p["w"], np.float32)
        tensors[f"{name}.weight"] = (np.transpose(w, (3, 2, 0, 1)).copy(), "oihw")
        tensors[f"{name}.bias"] = (np.asarray(p["b"], np.float32), "x")
    write_tza(path, tensors)


def load_checkpoint_params(result_dir: str) -> dict:
    """The params of the latest checkpoint in ``result_dir``."""
    from .train import latest_checkpoint

    ckpt = latest_checkpoint(result_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint in {result_dir}")
    return ckpt["params"]
