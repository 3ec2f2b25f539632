"""ctypes loader for the native BLAKE3 tree hasher (csrc/host/b3native.cc,
the port's copy of the reference's native/b3native.cc).

Replaces the pure-Python oracle on the data-ingestion path (the reference
uses the native blake3/bao crates for this, rust_fold/src/blake3_hash.rs).
The shared object is built on demand with g++ -O3 into the repo cache as
`torch_b3native.so` (never a file of the reference's), through a
per-process temporary name so concurrent builds cannot collide, and
memoized; when no compiler is available the callers fall back to the
Python oracle (`hash_with_path(..., native=...)` in blake3_ref).

Validated bit-for-bit against the Python oracle and the reference's hasher
in tests/test_torch_port_boundary.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host", "b3native.cc")
_SO = os.path.join(os.path.dirname(_PKG), ".cache", "torch_b3native.so")

_lib = None
_lib_failed = False


def _build() -> Optional[str]:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for extra in (["-march=native", "-funroll-loops"], []):
        cmd = (["g++", "-O3"] + extra
               + ["-fPIC", "-shared", "-o", tmp, _SRC])
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, _SO)
        return _SO
    return None


def get_lib():
    """The loaded library, or None when unavailable (no compiler)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    path = _build()
    if path is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(path)
    lib.b3n_hash.restype = ctypes.c_int
    lib.b3n_hash.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                             ctypes.c_char_p]
    lib.b3n_hash_with_path.restype = ctypes.c_int
    lib.b3n_hash_with_path.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def hash_bytes(data: bytes) -> Optional[bytes]:
    """Native 32-byte BLAKE3 hash, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.b3n_hash(data, len(data), out)
    return out.raw


def hash_with_path(data: bytes, chunk_idx: int):
    """Native equivalent of blake3_ref.hash_with_path; returns the same
    HashProof type, or None when the library is unavailable."""
    from . import blake3_ref as b3

    lib = get_lib()
    if lib is None:
        return None
    cap = 70
    root = ctypes.create_string_buffer(32)
    sibs = ctypes.create_string_buffer(32 * cap)
    dirs = ctypes.create_string_buffer(cap)
    total_depth = ctypes.c_int32(0)
    n = lib.b3n_hash_with_path(data, len(data), chunk_idx, root, sibs,
                               dirs, cap, ctypes.byref(total_depth))
    if n == -1:
        raise AssertionError("chunk_idx out of range")
    assert n >= 0, "native path extraction failed"
    # Native fills leaf-side first; the proof wants root-side first.
    path = []
    for i in range(n - 1, -1, -1):
        cv_bytes = sibs.raw[32 * i: 32 * (i + 1)]
        cv = [int.from_bytes(cv_bytes[4 * j: 4 * j + 4], "little")
              for j in range(8)]
        path.append(b3.PathNode(down_left=bool(dirs.raw[i]),
                                sibling_cv=cv))
    chunks = b3.split_chunks(data)
    return b3.HashProof(
        chunk_idx=chunk_idx,
        parent_path=path,
        chunk_bytes=chunks[chunk_idx],
        total_depth=int(total_depth.value),
        leaf_depth=n + 1,
        root_hash=root.raw,
    )
