"""Build and load the CUDA kernels of csrc/ (route: nvcc into a shared
library with a plain C interface, bound with ctypes; no torch headers).

The library is compiled for sm_90a on first use into `_build/`, under a file
name that carries a hash of the sources, so an edited kernel is never
served from a stale build: one nvcc per .cu file, all started together,
then one link. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from ..utils.config import CONFIG

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("field.cuh", "curve.cuh", "msm.cuh", "msm.cu", "msm_designs.cuh",
           "msm_designs.cu", "mont.cuh", "mont.cu", "conv_mma.cu",
           "points.cuh", "points.cu", "tables.cuh", "tables.cu")
UNITS = tuple(s for s in SOURCES if s.endswith(".cu"))
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # path, seconds, ptxas log, unit_seconds of a build


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


def _nvcc(args) -> tuple:
    """Run nvcc with args; return its stderr (the ptxas report) and its
    seconds. Raise if it failed."""
    t0 = time.perf_counter()
    r = subprocess.run([nvcc()] + args, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(args)}"
                           f"\n{r.stdout}\n{r.stderr}")
    return r.stderr, time.perf_counter() - t0


def build() -> str:
    """Compile csrc/*.cu (if not built yet) and return the library path."""
    os.makedirs(CONFIG.build_dir, exist_ok=True)
    path = os.path.join(CONFIG.build_dir, f"libhp_msm_{source_hash()}.so")
    if os.path.exists(path):
        build_info.setdefault("path", path)
        return path
    tmp = f"{path}.{os.getpid()}"
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs = [f"{tmp}.{unit}.o" for unit in UNITS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(UNITS)) as pool:
        units = list(pool.map(_nvcc, [
            flags + ["-Xptxas", "-v", "-c", "-o", obj, os.path.join(CSRC, u)]
            for u, obj in zip(UNITS, objs)]))
    _nvcc(flags + ["-shared", "-o", f"{tmp}.tmp"] + objs)
    os.replace(f"{tmp}.tmp", path)
    for obj in objs:
        os.remove(obj)
    build_info.update(path=path, seconds=time.perf_counter() - t0,
                      ptxas="".join(err for err, _ in units),
                      unit_seconds={u: s for u, (_, s) in zip(UNITS, units)})
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
                "hp_msm_merge": [P, P, P, P, P, I, I, I, P],
                "hp_msm_wsum": [P, P, P, I, I, P],
                "hp_to_affine": [P, P, P, P, P, P, LL, P],
                "hp_msm_chain": [P, P, P, I, I, I, P],
                "hp_msm_bucket_tsplit": [P, P, P, P, I, I, I, I, P],
                "hp_msm_bucket_signed": [P, P, P, P, I, I, I, P],
                "hp_mont_mul": [P, P, LL, P, LL, P, LL, I, P],
                "hp_mont_mul_stage": [P, P, P, P, LL, I, P],
                "hp_mont_mul_part": [P, P, P, P, LL, I, P],
                "hp_conv_mma": [P, P, P, LL, P],
                "hp_scale16": [P, P, P, LL, I, P],
                "hp_h_tables": [P, P, P, P, P, P, P, P, I, I, I, P],
            }.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# What every kernel wrapper shares (ops/msm_pallas.py, ops/pallas_field.py).
# ---------------------------------------------------------------------------

# Launch counts: each wrapper adds one where it launches its kernel.
launches: Dict[str, int] = {name: 0 for name in (
    "msm_bucket", "msm_merge", "msm_wsum", "to_affine", "msm_chain",
    "msm_bucket_tsplit", "msm_bucket_signed", "mont_mul", "mont_mul_stage",
    "mont_mul_part", "conv_mma", "scale16", "h_tables")}


# `d[k] += 1` is a read, an add and a store, which another thread's launch
# (parallel/segments.py proves segments in a thread pool) can interleave:
# the lock keeps every count exact.
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in launches:
            launches[k] = 0


def count_launch(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def check_input(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: want int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def on_cuda(name: str, *ts: torch.Tensor) -> bool:
    """True if all of ts lie on one CUDA device, False if all on the CPU;
    raises on anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def launch(name: str, fn, *args, device: torch.device) -> None:
    """Run a kernel launcher on `device` and its current stream; raise if
    the launch failed. Counts the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(fn(*args, ctypes.c_void_p(stream)), name)
    count_launch(name)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
