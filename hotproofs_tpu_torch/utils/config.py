"""Runtime configuration of the PyTorch port: on-disk locations and the
transcript's Poseidon parameterisation.

The device is never chosen here: every entry point takes an explicit
`device` argument.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)


@dataclass
class Config:
    # Generator files are shared with the JAX package (same derivation, same
    # `gens_*.npy` names); the port's own base layouts use `torch_*` names.
    cache_dir: str = os.environ.get(
        "HOTPROOFS_CACHE", os.path.join(_REPO_ROOT, ".cache"))
    # Where nvcc writes the kernels' shared library (csrc/ -> _build/).
    build_dir: str = os.path.join(_PKG_DIR, "_build")
    # Transcript Poseidon parameterisation, read from the same variable as
    # the reference so both packages hash with the same sponge.
    poseidon: str = os.environ.get("HOTPROOFS_POSEIDON", "default")


CONFIG = Config()
