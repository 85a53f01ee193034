"""Device helpers and the kernel build directory.

The wrappers in `ops/` decide by the device of the tensors they are given:
a CPU tensor takes the plain PyTorch version, a CUDA tensor the hand-written
kernel. There is no switch that forces either.
"""

from __future__ import annotations

import os

import torch

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_device() -> torch.device:
    """The first CUDA card. Raises when there is none: a caller that wants the
    CPU passes `device="cpu"`."""
    if not torch.cuda.is_available():
        raise RuntimeError("mllm_tpu_torch runs on a CUDA card and found none "
                           "(torch.cuda.is_available() is False); pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def csrc_dir() -> str:
    """The CUDA sources of the kernels (`*.cu`, `*.cuh`)."""
    return os.path.join(_PACKAGE_DIR, "csrc")


def kernel_build_dir() -> str:
    """Where `ops/_build.py` puts the compiled kernel library: `build/kernels`
    beside the package (listed in .gitignore)."""
    return os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")
