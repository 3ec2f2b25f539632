"""Runtime configuration of the PyTorch port: on-disk locations and the
transcript's Poseidon parameterisation.

The device is never chosen here: every entry point takes a `device`
argument, "cuda" unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)


@dataclass
class Config:
    # The port's cache files (generators, base layouts, native libraries)
    # carry `torch_*` names, so it never writes a file of the JAX package's.
    cache_dir: str = os.environ.get(
        "HOTPROOFS_CACHE", os.path.join(_REPO_ROOT, ".cache"))
    # Where nvcc writes the kernels' shared library (csrc/ -> _build/).
    build_dir: str = os.path.join(_PKG_DIR, "_build")
    # Transcript Poseidon parameterisation, read from the same variable as
    # the reference so both packages hash with the same sponge.
    poseidon: str = os.environ.get("HOTPROOFS_POSEIDON", "default")


CONFIG = Config()


def require_device(device) -> torch.device:
    """The torch device an entry point runs on. A CUDA device must exist:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
