"""Prime-field arithmetic in plain PyTorch (port of
hotproofs_tpu/ops/field.py).

Public format, as in the reference: a field element is a (..., 32) int32
tensor of little-endian base-2^8 digits, Montgomery form with R = 2^256.
`FieldSpec` carries the same eight fields and constants as the reference's.

Inside this module a value is held as 16 "halves" of 16 bits in int64
(`h16`): a half product is < 2^32 and a column of 16 of them < 2^36, so a
schoolbook product and a word-serial Montgomery reduction stay exact in
int64 with no carry handling until the end. The CUDA kernels (csrc/) hold
the same value as 8 little-endian u32 words; for canonical digits that
repack is a byte view (`digits_to_words`).

Every op here is elementwise over the leading axes and runs on whatever
device its inputs live on; results are canonical, so they equal the
reference's bit for bit whatever the order of operations. The public
`mont_mul`, `to_mont` and `from_mont` go through ops/pallas_field.py: one
launch of the mont_mul kernel for tensors on the card, the half-word code
below for tensors on the CPU. The `h_*` functions are plain torch on
either device.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

N_LIMBS = 32
LIMB_BITS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1
N_H16 = 16
M16 = 0xFFFF


def int_to_limbs(x: int, n: int = N_LIMBS) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)],
                    dtype=np.int32)


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr.tolist()))


@dataclass(frozen=True)
class FieldSpec:
    """Precomputed constants for one prime field (same fields as the
    reference's FieldSpec, so either spec hashes and prints the same)."""

    name: str
    p: int
    p_limbs: np.ndarray = dc_field(repr=False, default=None)
    n0inv: int = 0              # -p^{-1} mod 2^8
    r_mod_p: int = 0            # R = 2^256 mod p
    r2_limbs: np.ndarray = dc_field(repr=False, default=None)  # R^2 mod p
    one_mont_limbs: np.ndarray = dc_field(repr=False, default=None)
    mu_limbs: np.ndarray = dc_field(repr=False, default=None)  # -p^{-1} mod R
    exp_p_minus_2_bits: tuple = dc_field(repr=False, default=())

    @staticmethod
    def make(name: str, p: int) -> "FieldSpec":
        big_r = 1 << (N_LIMBS * LIMB_BITS)
        r = big_r % p
        e = p - 2
        return FieldSpec(
            name=name, p=p,
            p_limbs=int_to_limbs(p),
            n0inv=(-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS),
            r_mod_p=r,
            r2_limbs=int_to_limbs(r * r % p),
            one_mont_limbs=int_to_limbs(r),
            mu_limbs=int_to_limbs((-pow(p, -1, big_r)) % big_r),
            exp_p_minus_2_bits=tuple((e >> i) & 1
                                     for i in range(e.bit_length())),
        )

    # -- host-side conversions ------------------------------------------
    def to_limbs(self, x: int) -> np.ndarray:
        return int_to_limbs(x % self.p)

    def batch_to_limbs(self, xs: Sequence[int]) -> np.ndarray:
        """(n, 32) canonical digits of ints reduced mod p (one byte
        string for the batch)."""
        if len(xs) == 0:
            return np.zeros((0, N_LIMBS), np.int32)
        p = self.p
        raw = b"".join((int(x) % p).to_bytes(N_LIMBS, "little") for x in xs)
        return np.frombuffer(raw, np.uint8).astype(np.int32).reshape(
            -1, N_LIMBS)

    def limbs_to_ints(self, arr) -> np.ndarray:
        arr = np.asarray(arr)
        flat = arr.reshape(-1, arr.shape[-1])
        if flat.size and flat.min() >= 0 and flat.max() <= LIMB_MASK:
            raw = flat.astype(np.uint8).tobytes()
            w = flat.shape[-1]
            vals = [int.from_bytes(raw[i:i + w], "little")
                    for i in range(0, len(raw), w)]
        else:       # digits outside a byte: sum them with their weights
            vals = [limbs_to_int(row) for row in flat]
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out.reshape(arr.shape[:-1])

    def to_mont_int(self, x: int) -> int:
        return x % self.p * self.r_mod_p % self.p


# ---------------------------------------------------------------------------
# Repacking between digits, u32 words and int64 halves.
# ---------------------------------------------------------------------------


def digits_to_words(d: torch.Tensor) -> torch.Tensor:
    """(..., 32) canonical int32 digits -> (..., 8) int32 holding the
    little-endian u32 words (a byte view: free for canonical digits)."""
    return d.to(torch.uint8).contiguous().view(torch.int32)


def words_to_digits(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 32) int32 digits."""
    return w.contiguous().view(torch.uint8).to(torch.int32)


def to_h16(d: torch.Tensor) -> torch.Tensor:
    """(..., 32) digits -> (..., 16) int64 halves."""
    d = d.to(torch.int64)
    return d[..., 0::2] | (d[..., 1::2] << 8)


def from_h16(h: torch.Tensor) -> torch.Tensor:
    """(..., 16) canonical int64 halves -> (..., 32) int32 digits."""
    return torch.stack([h & 0xFF, h >> 8], dim=-1).flatten(-2).to(torch.int32)


def words_to_h16(w: torch.Tensor) -> torch.Tensor:
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & M16, w >> 16], dim=-1).flatten(-2)


def h16_to_words(h: torch.Tensor) -> torch.Tensor:
    w = h[..., 0::2] | (h[..., 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def int_to_h16(x: int) -> list:
    return [(x >> (16 * i)) & M16 for i in range(N_H16)]


_CONSTS: Dict[Tuple[str, str], dict] = {}


def consts(spec: FieldSpec, device) -> dict:
    """Per-(field, device) constant halves."""
    key = (spec.name, str(torch.device(device)))
    if key not in _CONSTS:
        t = lambda v: torch.tensor(int_to_h16(v), dtype=torch.int64,
                                   device=device)
        _CONSTS[key] = {
            "p": t(spec.p),
            "p17": torch.tensor(int_to_h16(spec.p) + [0], dtype=torch.int64,
                                device=device),
            "one": t(spec.r_mod_p),
            "r2": t(spec.r_mod_p * spec.r_mod_p % spec.p),
            "unit": t(1),
            "n0inv": (-pow(spec.p, -1, 1 << 16)) % (1 << 16),
            "weights": torch.tensor([1 << i for i in range(N_H16 + 1)],
                                    dtype=torch.int64, device=device),
        }
    return _CONSTS[key]


# ---------------------------------------------------------------------------
# Core ops on int64 halves (internal).
# ---------------------------------------------------------------------------


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate signed carries through lazy halves IN PLACE; every half
    ends in [0, 2^16). Returns the (signed) carry out of the top half."""
    n = t.shape[-1]
    for i in range(n - 1):
        v = t[..., i]
        t[..., i + 1].add_(v >> 16)
        v.bitwise_and_(M16)
    top = t[..., n - 1]
    c = top >> 16
    top.bitwise_and_(M16)
    return c


def _cond_sub_p(spec: FieldSpec, r: torch.Tensor) -> torch.Tensor:
    """r (..., 17) normalized halves of a value < 2p -> (r mod p) halves."""
    c = consts(spec, r.device)
    d = r - c["p17"]
    # Lexicographic sign of r - p from the top: the weighted sum of the
    # per-half signs is dominated by the most significant nonzero half.
    ge = (torch.sign(d) * c["weights"]).sum(-1) >= 0
    _carry(d)
    return torch.where(ge[..., None], d, r)[..., :N_H16]


def _mont_reduce(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """Word-serial Montgomery reduction of lazy halves t (..., 33) whose
    value T < p * 2^256: returns T * 2^-256 mod p, canonical (..., 16)."""
    c = consts(spec, t.device)
    p16, n0 = c["p"], c["n0inv"]
    for i in range(N_H16):
        m = (t[..., i] * n0) & M16
        t[..., i:i + N_H16].add_(m[..., None] * p16)
        t[..., i + 1].add_(t[..., i] >> 16)
    r = t[..., N_H16:].clone()
    _carry(r)
    return _cond_sub_p(spec, r)


_DIAG: Dict[str, torch.Tensor] = {}


def _diag(device) -> torch.Tensor:
    key = str(torch.device(device))
    if key not in _DIAG:
        i = torch.arange(N_H16, device=device)
        _DIAG[key] = (i[:, None] + i[None, :]).flatten()
    return _DIAG[key]


def h_mont_mul(spec: FieldSpec, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p on canonical halves (broadcasting)."""
    prod = (a[..., :, None] * b[..., None, :]).flatten(-2)   # (..., 256)
    t = torch.zeros(prod.shape[:-1] + (2 * N_H16 + 1,), dtype=torch.int64,
                    device=prod.device)
    t.index_add_(-1, _diag(prod.device), prod)
    return _mont_reduce(spec, t)


def h_reduce_lazy(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """Lazy non-negative halves (..., 16), value < p * 2^256 (any sum of
    fewer than 2^40 canonical elements) -> value mod p, canonical."""
    c = consts(spec, t.device)
    wide = torch.zeros(t.shape[:-1] + (2 * N_H16 + 1,), dtype=torch.int64,
                       device=t.device)
    wide[..., :N_H16] = t
    x = _mont_reduce(spec, wide)            # T * R^-1
    return h_mont_mul(spec, x, c["r2"])     # T mod p


def h_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    s = torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1)
    _carry(s)
    return _cond_sub_p(spec, s)


def h_sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    borrow = _carry(d) < 0
    e = d + consts(spec, d.device)["p"]
    _carry(e)
    return torch.where(borrow[..., None], e, d)


def h_neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return h_sub(spec, torch.zeros_like(a), a)


def h_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inversion a^(p-2) of Montgomery halves (0 -> 0)."""
    acc = consts(spec, a.device)["one"].expand(a.shape).clone()
    for bit in reversed(spec.exp_p_minus_2_bits):   # MSB first
        acc = h_mont_mul(spec, acc, acc)
        if bit:
            acc = h_mont_mul(spec, acc, a)
    return acc


def h_to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return h_mont_mul(spec, a, consts(spec, a.device)["r2"])


def h_from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return h_mont_mul(spec, a, consts(spec, a.device)["unit"])


# ---------------------------------------------------------------------------
# Public ops on (..., 32) digits (the reference's API).
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a, b):
    return from_h16(h_add(spec, to_h16(a), to_h16(b)))


def sub(spec: FieldSpec, a, b):
    return from_h16(h_sub(spec, to_h16(a), to_h16(b)))


def neg(spec: FieldSpec, a):
    return from_h16(h_neg(spec, to_h16(a)))


def mont_mul_plain(spec: FieldSpec, a, b):
    """The half-word product on (..., 32) digits: what mont_mul computes
    for CPU tensors, and the plain version of the mont_mul kernel."""
    return from_h16(h_mont_mul(spec, to_h16(a), to_h16(b)))


def _pallas_field():
    # Imported at call time: ops/pallas_field.py imports this module.
    from . import pallas_field
    return pallas_field


def mont_mul(spec: FieldSpec, a, b):
    """a * b * 2^-256 mod p on (..., 32) int32 digits (broadcasting): one
    launch of the mont_mul kernel for tensors on the card, mont_mul_plain
    for tensors on the CPU (ops/pallas_field.py: mont_mul_em)."""
    return _pallas_field().mont_mul_em(spec, a, b)


def to_mont(spec: FieldSpec, a):
    pf = _pallas_field()
    return pf.mont_mul_em(spec, a, pf.const_digits(spec, "r2", a.device))


def from_mont(spec: FieldSpec, a):
    pf = _pallas_field()
    return pf.mont_mul_em(spec, a, pf.const_digits(spec, "unit", a.device))


def inv(spec: FieldSpec, a):
    """Inverse of Montgomery-form elements, Montgomery out (0 -> 0)."""
    return from_h16(h_inv(spec, to_h16(a)))


def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (N_LIMBS,), dtype=torch.int32,
                       device=device)


def from_ints(spec: FieldSpec, xs: Sequence[int], device="cpu",
              mont: bool = False) -> torch.Tensor:
    """Host ints -> (n, 32) digits (canonical, or Montgomery if mont)."""
    vals = [spec.to_mont_int(int(x)) if mont else int(x) % spec.p
            for x in xs]
    return torch.from_numpy(spec.batch_to_limbs(vals)).to(device)


def to_ints(spec: FieldSpec, t: torch.Tensor, mont: bool = False) -> list:
    """(..., 32) digits -> flat list of ints (converted out of Montgomery
    form on the device first if mont)."""
    if mont:
        t = from_mont(spec, t)
    return [int(v) for v in spec.limbs_to_ints(t.cpu().numpy()).ravel()]


# ---------------------------------------------------------------------------
# Field instances (same constants as hotproofs_tpu/ops/field.py).
# ---------------------------------------------------------------------------

PALLAS_P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
VESTA_P = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

pallas_base = FieldSpec.make("pallas_base", PALLAS_P)
pallas_scalar = FieldSpec.make("pallas_scalar", VESTA_P)
vesta_base = FieldSpec.make("vesta_base", VESTA_P)
vesta_scalar = FieldSpec.make("vesta_scalar", PALLAS_P)
bn254_base = FieldSpec.make("bn254_base", BN254_FQ)
bn254_scalar = FieldSpec.make("bn254_scalar", BN254_FR)
grumpkin_base = FieldSpec.make("grumpkin_base", BN254_FR)
grumpkin_scalar = FieldSpec.make("grumpkin_scalar", BN254_FQ)

FIELDS = {s.name: s for s in (
    pallas_base, pallas_scalar, vesta_base, vesta_scalar,
    bn254_base, bn254_scalar, grumpkin_base, grumpkin_scalar,
)}


def field_for(modulus: int) -> FieldSpec:
    for s in FIELDS.values():
        if s.p == modulus:
            return s
    raise KeyError(f"no FieldSpec for modulus {modulus}")
