"""Device selection for the CLI apps.

The port's counterpart of ``mygpuraytracer_tpu/utils/platform.py``
(``force_platform``/``add_platform_flag``): the reference apps bind a CUDA
device at startup (cudaGLSetGLDevice, apps/src/preview.cpp:107-112); here
an app takes a ``--device`` flag, CUDA by default, and resolves it once.
A CUDA device that is not there raises: nothing falls back to the CPU
unless the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """``name`` as a torch.device with its index: a CUDA device must be
    visible, else RuntimeError; the CPU as it is; anything else ValueError."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r}: CUDA is not available (ask for --device cpu)")
        index = torch.cuda.current_device() if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r}: only {torch.cuda.device_count()} CUDA devices "
                               "are visible")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"the port runs on CUDA devices or the CPU, not {name!r}")
    return device


def add_device_flag(parser) -> None:
    """Attach the shared --device flag to an app's argparser."""
    parser.add_argument(
        "--device", default="cuda", metavar="NAME",
        help="torch device to run on (default cuda; 'cpu' runs the plain versions of the "
             "kernels)",
    )
