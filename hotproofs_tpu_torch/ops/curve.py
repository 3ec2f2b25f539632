"""Short-Weierstrass curves with a = 0 (port of hotproofs_tpu/ops/curve.py
and the plain half of ops/pallas_curve.py).

Points are projective (X, Y, Z) triples of Montgomery-form field elements;
the identity is (0 : 1 : 0). Every group operation uses the complete
formulas of Renes-Costello-Batina 2015 for a = 0 (Algorithms 7, 8 and 9),
the formulas the reference's device code and csrc/curve.cuh use, so the
projective outputs agree bit for bit.

The host_* functions are the exact-integer oracle on affine pairs (None is
the identity), and derive_generators is the reference's deterministic
hash-to-curve derivation, re-implemented here so the port never imports
jax.
"""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import field as F
from . import hash_to_curve as H2C

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (X, Y, Z)


@dataclass(frozen=True)
class CurveSpec:
    name: str
    base: F.FieldSpec     # coordinate field
    scalar: F.FieldSpec   # group order field
    b: int                # y^2 = x^3 + b
    gen: Tuple[int, int]  # affine generator

    @property
    def b3_mont(self) -> np.ndarray:
        return F.int_to_limbs(self.base.to_mont_int(3 * self.b))


PALLAS = CurveSpec("pallas", F.pallas_base, F.pallas_scalar, 5,
                   (F.PALLAS_P - 1, 2))
VESTA = CurveSpec("vesta", F.vesta_base, F.vesta_scalar, 5,
                  (F.VESTA_P - 1, 2))
BN254 = CurveSpec("bn254", F.bn254_base, F.bn254_scalar, 3, (1, 2))
GRUMPKIN = CurveSpec("grumpkin", F.grumpkin_base, F.grumpkin_scalar,
                     (-17) % F.BN254_FR,
                     (1, H2C.sqrt_mod((1 - 17) % F.BN254_FR, F.BN254_FR)))

CURVES = {c.name: c for c in (PALLAS, VESTA, BN254, GRUMPKIN)}


# ---------------------------------------------------------------------------
# Plain torch point ops on int64 halves (internal) and on digits (public).
# ---------------------------------------------------------------------------


def _b3(spec: CurveSpec, device) -> torch.Tensor:
    return F.to_h16(torch.from_numpy(spec.b3_mont).to(device))


def h_identity(spec: CurveSpec, shape, device) -> Tuple:
    c = F.consts(spec.base, device)
    z = torch.zeros(tuple(shape) + (F.N_H16,), dtype=torch.int64,
                    device=device)
    return (z, c["one"].expand(z.shape).clone(), z.clone())


def _stk(*xs):
    return torch.stack(torch.broadcast_tensors(*xs))


def h_pt_add(spec: CurveSpec, p, q):
    """RCB15 Algorithm 7 (a = 0): complete projective addition. The
    independent multiplies of each stage run as one stacked call."""
    f = spec.base
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    b3 = _b3(spec, X1.device)
    mul = lambda a, b: F.h_mont_mul(f, a, b)
    add = lambda a, b: F.h_add(f, a, b)
    sub = lambda a, b: F.h_sub(f, a, b)
    s1 = add(_stk(X1, Y1, X1), _stk(Y1, Z1, Z1))       # X1+Y1, Y1+Z1, X1+Z1
    s2 = add(_stk(X2, Y2, X2), _stk(Y2, Z2, Z2))
    m = mul(torch.cat([_stk(X1, Y1, Z1), s1]),
            torch.cat([_stk(X2, Y2, Z2), s2]))
    t0, t1, t2 = m[0], m[1], m[2]
    d = sub(m[3:], add(_stk(t0, t1, t0), _stk(t1, t2, t2)))
    t3, t4, Y3 = d[0], d[1], d[2]
    t0 = add(add(t0, t0), t0)
    bb = mul(b3, _stk(t2, Y3))
    t2, Y3 = bb[0], bb[1]
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    m = mul(_stk(t3, t4, t1, Y3, Z3, t0), _stk(t1, Y3, Z3, t0, t4, t3))
    X3 = sub(m[0], m[1])
    yz = add(m[2::2], m[3::2])
    return (X3, yz[0], yz[1])


def h_pt_add_mixed(spec: CurveSpec, p, q_affine):
    """RCB15 Algorithm 8 (a = 0, Z2 = 1); q is never the identity."""
    f = spec.base
    X1, Y1, Z1 = p
    X2, Y2 = q_affine
    b3 = _b3(spec, X1.device)
    mul = lambda a, b: F.h_mont_mul(f, a, b)
    add = lambda a, b: F.h_add(f, a, b)
    sub = lambda a, b: F.h_sub(f, a, b)
    s = add(_stk(X2, X1), _stk(Y2, Y1))                # X2+Y2, X1+Y1
    m = mul(_stk(X1, Y1, s[0], Y2, X2, b3), _stk(X2, Y2, s[1], Z1, Z1, Z1))
    t0, t1, t2 = m[0], m[1], m[5]
    t3 = sub(m[2], add(t0, t1))
    a = add(m[3:5], _stk(Y1, X1))
    t4, Y3 = a[0], a[1]
    t0 = add(add(t0, t0), t0)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    Y3 = mul(b3, Y3)
    m = mul(_stk(t3, t4, t1, Y3, Z3, t0), _stk(t1, Y3, Z3, t0, t4, t3))
    X3 = sub(m[0], m[1])
    yz = add(m[2::2], m[3::2])
    return (X3, yz[0], yz[1])


def h_pt_double(spec: CurveSpec, p):
    """RCB15 Algorithm 9 (a = 0): complete doubling."""
    f = spec.base
    X, Y, Z = p
    b3 = _b3(spec, X.device)
    mul = lambda a, b: F.h_mont_mul(f, a, b)
    add = lambda a, b: F.h_add(f, a, b)
    sub = lambda a, b: F.h_sub(f, a, b)
    m = mul(_stk(Y, Y, Z, X), _stk(Y, Z, Z, Y))
    t0, t1, t2, xy = m[0], m[1], m[2], m[3]
    Z3 = add(t0, t0)
    Z3 = add(Z3, Z3)
    Z3 = add(Z3, Z3)
    t2 = mul(b3, t2)
    m = mul(_stk(t2, t1), _stk(Z3, Z3))
    X3, Z3 = m[0], m[1]
    Y3 = add(t0, t2)
    t2 = add(add(t2, t2), t2)
    t0 = sub(t0, t2)
    m = mul(_stk(t0, t0), _stk(Y3, xy))
    Y3 = add(X3, m[0])
    X3 = add(m[1], m[1])
    return (X3, Y3, Z3)


def h_pt_select(mask: torch.Tensor, p, q):
    """mask ? p : q (mask has the batch shape)."""
    return tuple(torch.where(mask[..., None], a, b) for a, b in zip(p, q))


def h_pt_scalar_mul(spec: CurveSpec, scalars: torch.Tensor, p):
    """Double-and-add over the 256 bits of (..., 32) canonical digit
    scalars, MSB first (the reference's pt_scalar_mul, ops/curve.py:178):
    each step doubles, adds p and keeps the sum where the bit is set.
    Steps above the batch's highest set bit double the identity into
    itself, so they are skipped."""
    bits = torch.stack([(scalars >> k) & 1 for k in range(8)],
                       dim=-1).flatten(-2).bool()          # (..., 256) LSB
    live = bits.flatten(0, -2).any(0) if bits.dim() > 1 else bits
    nz = live.nonzero()
    acc = h_identity(spec, scalars.shape[:-1], scalars.device)
    top = int(nz.max()) if nz.numel() else -1
    for i in range(top, -1, -1):
        acc = h_pt_double(spec, acc)
        acc = h_pt_select(bits[..., i], h_pt_add(spec, acc, p), acc)
    return acc


def _h(pt):
    return tuple(F.to_h16(c) for c in pt)


def _d(pt):
    return tuple(F.from_h16(c) for c in pt)


def identity(spec: CurveSpec, shape=(), device="cpu") -> Point:
    return _d(h_identity(spec, shape, device))


def pt_add(spec: CurveSpec, p: Point, q: Point) -> Point:
    return _d(h_pt_add(spec, _h(p), _h(q)))


def pt_add_mixed(spec: CurveSpec, p: Point, q_affine) -> Point:
    return _d(h_pt_add_mixed(spec, _h(p), _h(q_affine)))


def pt_double(spec: CurveSpec, p: Point) -> Point:
    return _d(h_pt_double(spec, _h(p)))


def pt_select(mask: torch.Tensor, p: Point, q: Point) -> Point:
    return h_pt_select(mask, p, q)


def pt_scalar_mul(spec: CurveSpec, scalars: torch.Tensor, p: Point) -> Point:
    """k * P for (..., 32) canonical digit scalars k (plain torch)."""
    return _d(h_pt_scalar_mul(spec, scalars, _h(p)))


def pt_neg(spec: CurveSpec, p: Point) -> Point:
    X, Y, Z = p
    return (X, F.neg(spec.base, Y), Z)


# ---------------------------------------------------------------------------
# Host conversions.
# ---------------------------------------------------------------------------


def pt_to_affine_host_canon(spec: CurveSpec, p) -> list:
    """CANONICAL-digit projective points (tuple of (n, 32)) -> affine int
    pairs, None for the identity."""
    f = spec.base
    X, Y, Z = (f.limbs_to_ints(np.asarray(
        c.cpu().numpy() if isinstance(c, torch.Tensor) else c)).ravel()
        for c in p)
    out = []
    for x, y, z in zip(X.tolist(), Y.tolist(), Z.tolist()):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, f.p - 2, f.p)
            out.append((x * zi % f.p, y * zi % f.p))
    return out


def pt_to_affine_host(spec: CurveSpec, p) -> list:
    """Montgomery projective points -> affine int pairs (None = identity)."""
    f = spec.base
    rinv = pow(f.r_mod_p, f.p - 2, f.p)
    X, Y, Z = ([v * rinv % f.p for v in f.limbs_to_ints(
        c.cpu().numpy()).ravel().tolist()] for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, f.p - 2, f.p)
            out.append((x * zi % f.p, y * zi % f.p))
    return out


def affine_to_mont(spec: CurveSpec, pts, device="cpu") -> Point:
    """Affine int pairs (None = identity) -> Montgomery projective digits."""
    f = spec.base
    n = len(pts)
    out = np.zeros((3, n, F.N_LIMBS), np.int32)
    for i, pt in enumerate(pts):
        if pt is None:
            out[1, i] = f.one_mont_limbs
        else:
            out[0, i] = F.int_to_limbs(f.to_mont_int(pt[0]))
            out[1, i] = F.int_to_limbs(f.to_mont_int(pt[1]))
            out[2, i] = f.one_mont_limbs
    t = torch.from_numpy(out).to(device)
    return (t[0], t[1], t[2])


# ---------------------------------------------------------------------------
# Host-side exact-integer oracle (affine; None = identity).
# ---------------------------------------------------------------------------


def host_add(spec: CurveSpec, p, q):
    pp = spec.base.p
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % pp == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * pow(2 * y1, pp - 2, pp) % pp
    else:
        lam = (y2 - y1) * pow(x2 - x1, pp - 2, pp) % pp
    x3 = (lam * lam - x1 - x2) % pp
    y3 = (lam * (x1 - x3) - y1) % pp
    return (x3, y3)


def _host_proj_add(spec: CurveSpec, P, Q):
    """RCB15 Algorithm 7 on host ints, projective; identity = (0, 1, 0)."""
    m = spec.base.p
    b3 = 3 * spec.b % m
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = X1 * X2 % m
    t1 = Y1 * Y2 % m
    t2 = Z1 * Z2 % m
    t3 = ((X1 + Y1) * (X2 + Y2) - t0 - t1) % m
    t4 = ((Y1 + Z1) * (Y2 + Z2) - t1 - t2) % m
    ty = ((X1 + Z1) * (X2 + Z2) - t0 - t2) % m
    x3 = 3 * t0 % m
    t2b = b3 * t2 % m
    z3 = (t1 + t2b) % m
    t1b = (t1 - t2b) % m
    yb = b3 * ty % m
    return ((t3 * t1b - t4 * yb) % m, (t1b * z3 + yb * x3) % m,
            (z3 * t4 + x3 * t3) % m)


def host_scalar_mul(spec: CurveSpec, k: int, p):
    """Host double-and-add in projective coordinates."""
    if p is None:
        return None
    k %= spec.scalar.p
    if k == 0:
        return None
    m = spec.base.p
    acc = (0, 1, 0)
    pp = (p[0], p[1], 1)
    while k:
        if k & 1:
            acc = _host_proj_add(spec, acc, pp)
        pp = _host_proj_add(spec, pp, pp)
        k >>= 1
    X, Y, Z = acc
    if Z == 0:
        return None
    zi = pow(Z, m - 2, m)
    return (X * zi % m, Y * zi % m)


def host_msm(spec: CurveSpec, scalars: Sequence[int], points):
    acc = None
    for k, p in zip(scalars, points):
        acc = host_add(spec, acc, host_scalar_mul(spec, int(k), p))
    return acc


def host_on_curve(spec: CurveSpec, p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + spec.b)) % spec.base.p == 0


# derive_generators splits keys of at least this many generators over
# worker processes, one per core (about 1.4 ms a Pasta point on one core).
POOL_MIN = 4096


def derive_generators(spec: CurveSpec, label: bytes,
                      n: int) -> List[Tuple[int, int]]:
    """n generators by hash-to-x and try-and-increment: x = SHA-512(
    "hotproofs_tpu/gen/" || curve || "/" || label || i || ctr) mod p, the
    smaller square root for y (the reference's derivation, unchanged:
    both packages must commit with the same key). A key of POOL_MIN or more
    is derived over the host's cores, with the same output."""
    procs = len(os.sched_getaffinity(0))
    if n >= POOL_MIN and procs > 1:
        return _derive_pooled(spec, label, n, procs)
    return H2C.derive_range(spec.name, spec.base.p, spec.b, label, 0, n)


def _derive_pooled(spec: CurveSpec, label: bytes, n: int,
                   procs: int) -> List[Tuple[int, int]]:
    """derive_generators over `procs` worker processes (hash_to_curve.py
    run as a script, one contiguous range of indices each), concatenated
    in order."""
    step = -(-n // procs)
    workers = [subprocess.Popen(
        [sys.executable, H2C.__file__, spec.name, str(spec.base.p),
         str(spec.b), label.hex(), str(a), str(min(n, a + step))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a in range(0, n, step)]
    out: List[Tuple[int, int]] = []
    try:
        for w in workers:
            text, err = w.communicate()
            if w.returncode != 0:
                raise RuntimeError(f"generator worker failed: {err[-2000:]}")
            out.extend((int(x, 16), int(y, 16)) for x, y in
                       (line.split() for line in text.splitlines()))
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    if len(out) != n:
        raise RuntimeError(f"generator workers gave {len(out)} of {n}")
    return out
