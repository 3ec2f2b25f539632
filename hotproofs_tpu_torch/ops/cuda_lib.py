"""Build and load the CUDA kernels of csrc/ (route: nvcc into a shared
library with a plain C interface, bound with ctypes; no torch headers).

The library is compiled for sm_90a on first use into `_build/`, under a file
name that carries a hash of the sources, so an edited kernel is never
served from a stale build. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..utils.config import CONFIG

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("field.cuh", "curve.cuh", "msm.cuh", "msm.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # path, seconds, ptxas log of the last build


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of hotproofs_tpu_torch cannot be built")


def build() -> str:
    """Compile csrc/msm.cu (if not built yet) and return the library path."""
    os.makedirs(CONFIG.build_dir, exist_ok=True)
    path = os.path.join(CONFIG.build_dir, f"libhp_msm_{source_hash()}.so")
    if os.path.exists(path):
        build_info.setdefault("path", path)
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC, "msm.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)
    build_info.update(path=path, seconds=time.perf_counter() - t0,
                      ptxas=res.stderr)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            for name, args in {
                "hp_msm_bucket": [P, P, P, P, I, I, I, P],
                "hp_msm_merge": [P, P, P, I, I, P],
                "hp_msm_wsum": [P, P, P, I, P],
                "hp_to_affine": [P, P, P, P, P, P, LL, P],
            }.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
