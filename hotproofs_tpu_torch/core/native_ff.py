"""ctypes loader for the native field/Poseidon/EC helpers (csrc/host/ffec.cc,
the port's copy of the reference's native/ffec.cc).

The per-fold host work — Fiat-Shamir transcript permutations and the
instance-fold EC scalar multiplications — measured 24.8 + 6.1 ms per fold in
pure Python (tools/profile_msm_phases.py), i.e. ~250 ms of host time per
lockstep step at K=8 chains. This module runs the identical math natively
(~20-30x faster); the Python implementations in ops/poseidon.py and
ops/curve.py remain the reference oracles and the automatic fallback.

Bit-for-bit parity with the reference's copy is enforced by
tests/test_torch_port_boundary.py. The shared
object is built into the repo cache as `torch_ffec.so` (never a file of the
reference's), through a per-process temporary name so concurrent builds
cannot collide.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host", "ffec.cc")
_SO = os.path.join(os.path.dirname(_PKG), ".cache", "torch_ffec.so")

_lib = None
_lib_failed = False
_lock = threading.Lock()


def _build() -> Optional[str]:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for extra in (["-march=native", "-funroll-loops"], []):
        cmd = (["g++", "-O3", "-std=c++17"] + extra
               + ["-fPIC", "-shared", "-o", tmp, _SRC])
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=180)
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
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build()
        if path is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.ffec_field.restype = ctypes.c_int
        lib.ffec_field.argtypes = [ctypes.c_char_p]
        lib.ffec_poseidon.restype = ctypes.c_int
        lib.ffec_poseidon.argtypes = [ctypes.c_int] * 4 + [ctypes.c_char_p] * 2
        lib.ffec_absorb.restype = ctypes.c_longlong
        lib.ffec_absorb.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_longlong, ctypes.c_char_p,
                                    ctypes.c_longlong]
        lib.ffec_squeeze.restype = ctypes.c_longlong
        lib.ffec_squeeze.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_longlong, ctypes.c_char_p]
        lib.ffec_curve.restype = ctypes.c_int
        lib.ffec_curve.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.ffec_fold_point.restype = None
        lib.ffec_fold_point.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
        lib.ffec_permute.restype = None
        lib.ffec_permute.argtypes = [ctypes.c_int, ctypes.c_char_p]
        _lib = lib
    return _lib


_field_ids = {}
_poseidon_ids = {}
_curve_ids = {}


def _i2b(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def _checked(handle: int, what: str) -> int:
    """Native registration returns -1 on rejection (e.g. t > 16); caching
    and later passing a negative handle would index a C++ vector out of
    bounds (round-4 advisor finding) — fail loudly instead."""
    if handle < 0:
        raise ValueError(f"native {what} registration rejected "
                         f"(handle {handle})")
    return handle


def field_id(p: int) -> int:
    lib = get_lib()
    if p not in _field_ids:
        _field_ids[p] = _checked(lib.ffec_field(_i2b(p)), "field")
    return _field_ids[p]


def poseidon_id(spec) -> int:
    """Native handle for an ops.poseidon.PoseidonSpec."""
    key = (spec.field.p, spec.t, spec.r_full, spec.r_partial,
           spec.round_constants[0][0])
    if key not in _poseidon_ids:
        lib = get_lib()
        fid = field_id(spec.field.p)
        rc = b"".join(_i2b(c) for row in spec.round_constants for c in row)
        mds = b"".join(_i2b(m) for row in spec.mds for m in row)
        _poseidon_ids[key] = _checked(lib.ffec_poseidon(
            fid, spec.t, spec.r_full, spec.r_partial, rc, mds), "poseidon")
    return _poseidon_ids[key]


def curve_id(curve_spec) -> int:
    """Native handle for an ops.curve.CurveSpec (a = 0)."""
    key = (curve_spec.base.p, curve_spec.b)
    if key not in _curve_ids:
        lib = get_lib()
        fid = field_id(curve_spec.base.p)
        _curve_ids[key] = _checked(
            lib.ffec_curve(fid, _i2b(curve_spec.b % curve_spec.base.p)),
            "curve")
    return _curve_ids[key]


class NativeSponge:
    """Drop-in for ops.poseidon.HostSponge (same .state / ._absorbed attrs,
    which prover checkpoints serialize), backed by ffec.cc."""

    def __init__(self, spec, domain_tag: int):
        self.spec = spec
        self.p = spec.field.p
        self.state = [domain_tag % self.p] + [0] * (spec.t - 1)
        self._absorbed = 0
        self._pid = poseidon_id(spec)

    def _state_buf(self) -> bytearray:
        return bytearray(b"".join(_i2b(v) for v in self.state))

    def _load_state(self, buf: bytearray) -> None:
        self.state = [int.from_bytes(buf[32 * i: 32 * i + 32], "little")
                      for i in range(self.spec.t)]

    def absorb(self, vals: Sequence[int]):
        if not vals:
            return
        lib = get_lib()
        buf = self._state_buf()
        data = b"".join(_i2b(v % self.p) for v in vals)
        sbuf = ctypes.create_string_buffer(bytes(buf), len(buf))
        self._absorbed = lib.ffec_absorb(self._pid, sbuf, self._absorbed,
                                         data, len(vals))
        self._load_state(bytearray(sbuf.raw))

    def squeeze(self) -> int:
        lib = get_lib()
        buf = self._state_buf()
        sbuf = ctypes.create_string_buffer(bytes(buf), len(buf))
        out = ctypes.create_string_buffer(32)
        self._absorbed = lib.ffec_squeeze(self._pid, sbuf, self._absorbed,
                                          out)
        self._load_state(bytearray(sbuf.raw))
        return int.from_bytes(out.raw, "little")


def fold_point(curve_spec, acc, q, r: int):
    """acc + r*q on affine int points (None = identity) — the native
    fold_instance commitment update. Returns affine tuple or None."""
    lib = get_lib()
    cid = curve_id(curve_spec)
    buf = ctypes.create_string_buffer(64)
    inf = ctypes.c_int(1)
    if acc is not None:
        buf.raw = _i2b(acc[0]) + _i2b(acc[1])
        inf.value = 0
    qbuf = _i2b(q[0]) + _i2b(q[1]) if q is not None else b"\0" * 64
    r = r % curve_spec.scalar.p
    lib.ffec_fold_point(cid, buf, ctypes.byref(inf), qbuf,
                        0 if q is not None else 1, _i2b(r))
    if inf.value:
        return None
    raw = buf.raw
    return (int.from_bytes(raw[:32], "little"),
            int.from_bytes(raw[32:], "little"))


def available() -> bool:
    return get_lib() is not None
