"""Fixed-base MSM and its key preparation on Hopper (port of
hotproofs_tpu/ops/msm_pallas.py, with ops/msm.py's n_windows4,
scale_points16 and _digits4).

Design (as in the reference): radix-16 digits; the window weight 16^w lives
in pre-scaled affine bases prepared once per key; all windows flatten into
one lane axis, lane l = w * lpw + c holding points [c*B, (c+1)*B) of window
w. J MSMs over one shared base array run as one chain of three kernels:

  K1 msm_bucket  (replaces _bucket_kernel, msm_pallas.py:210)
  K2 msm_merge   (replaces _merge_kernel,  msm_pallas.py:288)
  K3 msm_wsum    (replaces _wsum_kernel,   msm_pallas.py:358)

and the bases come out of

  K4 to_affine   (replaces batch_inv_mont_lm + mont_mul_lm as composed by
                  scaled_affine_device, msm_pallas.py:156-170)

The kernels are CUDA C++ in csrc/msm.cu (what bounds each and how it is
laid out is noted there). Beside each wrapper is its plain torch version,
the same per-lane algorithm in the same order, so the two agree bit for bit
in projective form, and a launch count. A wrapper takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.

Kernel layouts (int32 tensors holding u32 words):
  digits  (J, B, n_lanes)         bases   (B, 2, 8, n_lanes)
  buckets (J, 15, 3, 8, n_lanes)  reduced (J, 15, 3, 8)     sums (J, 3, 8)
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import curve as C
from . import field as F
from .cuda_lib import check, lib

RADIX_BITS = 4
NBUCKET = 15          # digit values 1..15; digit 0 is skipped
MERGE_THREADS = 256   # lanes summed per thread stride in K2 (csrc/msm.cuh)
NW = 8                # u32 words per field element

# Launch counts: each wrapper adds one where it launches its kernel.
launches: Dict[str, int] = {"msm_bucket": 0, "msm_merge": 0,
                            "msm_wsum": 0, "to_affine": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plan, digits and base layout.
# ---------------------------------------------------------------------------


def n_windows4(max_bits: int) -> int:
    return (max_bits + RADIX_BITS - 1) // RADIX_BITS


def plan(m: int, max_bits: int) -> Tuple[int, int, int, int]:
    """(B, lanes_per_window, windows, n_lanes) for an m-point MSM.

    B = 64 points per lane keeps the merge at a quarter of the bucket work
    and gives the comm_T MSM 16k lanes (threads); small m shrinks B so each
    window still has >= 16 lanes."""
    w4 = n_windows4(max_bits)
    b = 64
    while b > 8 and m // b < 16:
        b //= 2
    lpw = -(-m // b)
    return b, lpw, w4, w4 * lpw


def digits4(scalars: torch.Tensor, windows: int) -> torch.Tensor:
    """(..., m, 32) canonical digit scalars -> (..., W4, m) radix-16 digits."""
    lo = scalars & 0xF
    hi = (scalars >> RADIX_BITS) & 0xF
    flat = torch.stack([lo, hi], dim=-1).flatten(-2)      # (..., m, 64)
    return flat[..., :windows].transpose(-1, -2)


def digits_tm(scalars: torch.Tensor, m: int, b: int, lpw: int,
              w4: int) -> torch.Tensor:
    """(J, m, 32) canonical scalars -> (J, B, n_lanes) int32 digits."""
    J = scalars.shape[0]
    d = digits4(scalars, w4)                               # (J, W4, m)
    pad = lpw * b - m
    if pad:
        d = torch.nn.functional.pad(d, (0, pad))
    d = d.reshape(J, w4, lpw, b).permute(0, 3, 1, 2)
    return d.reshape(J, b, w4 * lpw).to(torch.int32).contiguous()


def bases_tm(xa: torch.Tensor, ya: torch.Tensor, m: int,
             max_bits: int) -> torch.Tensor:
    """Affine Montgomery (W4', m, 32) digit arrays (W4' >= the plan's
    windows) -> (B, 2, 8, n_lanes) kernel layout. Padding points are zero;
    their digits are always 0, so no kernel ever reads them."""
    b, lpw, w4, n_lanes = plan(m, max_bits)

    def one(a):
        w = F.digits_to_words(a[:w4, :m])                  # (W4, m, 8)
        pad = lpw * b - m
        if pad:
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        return w.reshape(w4, lpw, b, NW).permute(2, 3, 0, 1).reshape(
            b, NW, n_lanes)

    return torch.stack([one(xa), one(ya)], dim=1).contiguous()


_CONSTS: Dict[str, ctypes.Array] = {}


def consts_words(spec: C.CurveSpec) -> np.ndarray:
    """The csrc `Consts` pack: p, one (R mod p), p - 2, 3b (Montgomery),
    -p^-1 mod 2^32, as 33 little-endian u32 words."""
    f = spec.base
    words = lambda v: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(NW)]
    return np.asarray(words(f.p) + words(f.r_mod_p) + words(f.p - 2)
                      + words(f.to_mont_int(3 * spec.b))
                      + [(-pow(f.p, -1, 1 << 32)) % (1 << 32)], np.uint32)


def _consts_arg(spec: C.CurveSpec) -> ctypes.Array:
    if spec.name not in _CONSTS:
        w = consts_words(spec)
        _CONSTS[spec.name] = (ctypes.c_uint32 * len(w))(*w.tolist())
    return _CONSTS[spec.name]


def _check_input(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: want int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_cuda(name: str, *ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def _launch(name: str, fn, *args, device: torch.device) -> None:
    """Run a kernel launcher on `device` and its current stream; raise if
    the launch failed. Counts the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(fn(*args, ctypes.c_void_p(stream)), name)
    launches[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _proj_words(pt) -> torch.Tensor:
    """h16 projective tuple with coordinates (..., 16) -> (..., 3, 8)
    words."""
    return torch.stack([F.h16_to_words(c) for c in pt], dim=-2)


# ---------------------------------------------------------------------------
# K1: bucket accumulation.
# ---------------------------------------------------------------------------


def msm_bucket_plain(spec: C.CurveSpec, digits: torch.Tensor,
                     bases: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1: all (job, lane) pairs step through their
    B bases together; each gathers the bucket its digit picks, mixed-adds
    the base, and scatters it back."""
    J, B, L = digits.shape
    bx = F.words_to_h16(bases[:, 0].transpose(1, 2))       # (B, L, 16)
    by = F.words_to_h16(bases[:, 1].transpose(1, 2))
    bk = C.h_identity(spec, (J, L, NBUCKET), digits.device)
    for t in range(B):
        d = digits[:, t, :].to(torch.int64)                # (J, L)
        live = d > 0
        if not bool(live.any()):
            continue
        idx = (d - 1).clamp(min=0)[..., None, None].expand(J, L, 1, F.N_H16)
        cur = tuple(c.gather(2, idx).squeeze(2) for c in bk)
        new = C.h_pt_add_mixed(spec, cur, (bx[t][None], by[t][None]))
        new = C.h_pt_select(live, new, cur)
        for c, n in zip(bk, new):
            c.scatter_(2, idx, n[:, :, None, :])
    # (J, L, 15, 16) x3 -> (J, 15, 3, 8, L)
    return _proj_words(bk).permute(0, 2, 3, 4, 1).contiguous()


def msm_bucket(spec: C.CurveSpec, digits: torch.Tensor,
               bases: torch.Tensor) -> torch.Tensor:
    """K1: (J, B, n_lanes) digits x (B, 2, 8, n_lanes) bases -> per-lane
    buckets (J, 15, 3, 8, n_lanes)."""
    J, B, L = digits.shape
    _check_input("msm_bucket digits", digits, (J, B, L))
    _check_input("msm_bucket bases", bases, (B, 2, NW, L))
    if not _on_cuda("msm_bucket", digits, bases):
        return msm_bucket_plain(spec, digits, bases)
    out = torch.empty((J, NBUCKET, 3, NW, L), dtype=torch.int32,
                      device=digits.device)
    if J * L:
        _launch("msm_bucket", lib().hp_msm_bucket, _consts_arg(spec),
                _ptr(digits), _ptr(bases), _ptr(out), J, B, L,
                device=digits.device)
    return out


# ---------------------------------------------------------------------------
# K2: lane merge.
# ---------------------------------------------------------------------------


def msm_merge_plain(spec: C.CurveSpec, buckets: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K2, in the kernel's order: accumulator t sums
    lanes t, t + 256, ..., then a halving tree over the 256 accumulators."""
    J, S, _, _, L = buckets.shape
    pts = tuple(F.words_to_h16(buckets[:, :, c].transpose(2, 3))
                for c in range(3))                         # (J, 15, L, 16)
    T = MERGE_THREADS
    acc = C.h_identity(spec, (J, S, T), buckets.device)
    for lo in range(0, L, T):
        w = min(T, L - lo)
        new = C.h_pt_add(spec, tuple(a[:, :, :w] for a in acc),
                         tuple(p[:, :, lo:lo + w] for p in pts))
        acc = tuple(torch.cat([n, a[:, :, w:]], dim=2)
                    for n, a in zip(new, acc))
    h = T // 2
    while h >= 1:
        acc = C.h_pt_add(spec, tuple(a[:, :, :h] for a in acc),
                         tuple(a[:, :, h:2 * h] for a in acc))
        h //= 2
    return _proj_words(tuple(a[:, :, 0] for a in acc)).contiguous()


def msm_merge(spec: C.CurveSpec, buckets: torch.Tensor) -> torch.Tensor:
    """K2: buckets (J, 15, 3, 8, n_lanes) -> reduced (J, 15, 3, 8)."""
    J, _, _, _, L = buckets.shape
    _check_input("msm_merge buckets", buckets, (J, NBUCKET, 3, NW, L))
    if not _on_cuda("msm_merge", buckets):
        return msm_merge_plain(spec, buckets)
    out = torch.empty((J, NBUCKET, 3, NW), dtype=torch.int32,
                      device=buckets.device)
    if J:
        _launch("msm_merge", lib().hp_msm_merge, _consts_arg(spec),
                _ptr(buckets), _ptr(out), J, L, device=buckets.device)
    return out


# ---------------------------------------------------------------------------
# K3: weighted bucket sum.
# ---------------------------------------------------------------------------


def msm_wsum_plain(spec: C.CurveSpec, reduced: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K3: running suffix sums over slots 15..1."""
    J = reduced.shape[0]
    pts = tuple(F.words_to_h16(reduced[:, :, c]) for c in range(3))
    t = C.h_identity(spec, (J,), reduced.device)
    s = t
    for v in range(NBUCKET, 0, -1):
        t = C.h_pt_add(spec, t, tuple(p[:, v - 1] for p in pts))
        s = C.h_pt_add(spec, s, t)
    return _proj_words(s).contiguous()


def msm_wsum(spec: C.CurveSpec, reduced: torch.Tensor) -> torch.Tensor:
    """K3: reduced (J, 15, 3, 8) -> S = sum_v v * B_v as (J, 3, 8)."""
    J = reduced.shape[0]
    _check_input("msm_wsum reduced", reduced, (J, NBUCKET, 3, NW))
    if not _on_cuda("msm_wsum", reduced):
        return msm_wsum_plain(spec, reduced)
    out = torch.empty((J, 3, NW), dtype=torch.int32, device=reduced.device)
    if J:
        _launch("msm_wsum", lib().hp_msm_wsum, _consts_arg(spec),
                _ptr(reduced), _ptr(out), J, device=reduced.device)
    return out


# ---------------------------------------------------------------------------
# K4: projective -> affine (key preparation).
# ---------------------------------------------------------------------------


def to_affine_words_plain(spec: C.CurveSpec, X, Y, Z):
    """Plain torch version of K4 on (N, 8) words: Fermat z^-1 (0 -> 0),
    then x * z^-1 and y * z^-1."""
    f = spec.base
    zinv = F.h_inv(f, F.words_to_h16(Z))
    return (F.h16_to_words(F.h_mont_mul(f, F.words_to_h16(X), zinv)),
            F.h16_to_words(F.h_mont_mul(f, F.words_to_h16(Y), zinv)))


def to_affine_words(spec: C.CurveSpec, X: torch.Tensor, Y: torch.Tensor,
                    Z: torch.Tensor):
    """K4 on (N, 8) Montgomery words -> affine (x, y) (N, 8) words."""
    n = X.shape[0]
    for name, t in (("X", X), ("Y", Y), ("Z", Z)):
        _check_input(f"to_affine {name}", t, (n, NW))
    if not _on_cuda("to_affine", X, Y, Z):
        return to_affine_words_plain(spec, X, Y, Z)
    x = torch.empty_like(X)
    y = torch.empty_like(Y)
    if n:
        _launch("to_affine", lib().hp_to_affine, _consts_arg(spec), _ptr(X),
                _ptr(Y), _ptr(Z), _ptr(x), _ptr(y), n, device=X.device)
    return x, y


def to_affine(spec: C.CurveSpec, X: torch.Tensor, Y: torch.Tensor,
              Z: torch.Tensor):
    """(..., 32) Montgomery projective digits -> affine (x, y) digits."""
    shape = X.shape
    w = lambda a: F.digits_to_words(a.reshape(-1, F.N_LIMBS))
    x, y = to_affine_words(spec, w(X), w(Y), w(Z))
    return (F.words_to_digits(x).reshape(shape),
            F.words_to_digits(y).reshape(shape))


# ---------------------------------------------------------------------------
# The MSM and the key preparation.
# ---------------------------------------------------------------------------


def msm_many(spec: C.CurveSpec, scalars: torch.Tensor, bases: torch.Tensor,
             m: int, max_bits: int) -> C.Point:
    """J MSMs over one shared base array through K1 -> K2 -> K3.

    scalars: (J, m, 32) canonical digits, each < 2^max_bits; bases: the
    (B, 2, 8, n_lanes) layout of bases_tm(m, max_bits). Returns projective
    Montgomery (J, 32) x3."""
    b, lpw, w4, _ = plan(m, max_bits)
    d = digits_tm(scalars, m, b, lpw, w4)
    s = msm_wsum(spec, msm_merge(spec, msm_bucket(spec, d, bases)))
    dig = F.words_to_digits(s)                             # (J, 3, 32)
    return (dig[:, 0], dig[:, 1], dig[:, 2])


def scale_points16(spec: C.CurveSpec, points: C.Point,
                   windows: int) -> C.Point:
    """(m, 32) x3 projective Montgomery points -> (W4, m, 32) x3 holding
    16^w * P (plain torch: 4 doublings per window)."""
    pt = tuple(F.to_h16(c) for c in points)
    out: List[Tuple] = []
    for w in range(windows):
        out.append(pt)
        if w + 1 < windows:
            for _ in range(RADIX_BITS):
                pt = C.h_pt_double(spec, pt)
    return tuple(F.from_h16(torch.stack([o[c] for o in out]))
                 for c in range(3))


def scaled_affine_host(spec: C.CurveSpec, gens: list, w4: int):
    """Host-exact affine pre-scaled bases (the oracle): gens = [(x, y)]
    ints -> (W4, m, 32) Montgomery digit numpy arrays."""
    f = spec.base
    m = len(gens)
    xa = np.zeros((w4, m, F.N_LIMBS), np.int32)
    ya = np.zeros((w4, m, F.N_LIMBS), np.int32)
    for i, g in enumerate(gens):
        pt = g
        for w in range(w4):
            assert pt is not None, "16^w * G may never be the identity"
            xa[w, i] = F.int_to_limbs(f.to_mont_int(pt[0]))
            ya[w, i] = F.int_to_limbs(f.to_mont_int(pt[1]))
            for _ in range(RADIX_BITS):
                pt = C.host_add(spec, pt, pt)
    return xa, ya
