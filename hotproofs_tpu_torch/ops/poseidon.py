"""Poseidon: parameters, the host permutation and sponge, and the batched
permutation on tensors (port of hotproofs_tpu/ops/poseidon.py).

Constants come from the Grain LFSR of the Poseidon paper and the MDS matrix
is the Cauchy matrix 1/(x_i + y_j), exactly as in the reference;
`native_ff.NativeSponge` and `native_ff.fold_point` read only the attributes
PoseidonSpec carries (field.p, t, r_full, r_partial, round_constants, mds).
The Fiat-Shamir transcript runs on the host (HostSponge, NativeSponge).

`permute` is the batched permutation on (..., t, 32) Montgomery digits: the
poseidon_permute kernel (csrc/poseidon.cu) for tensors on the card, its
plain torch version `permute_plain` for tensors on the CPU. Its constants
are `device_constants`, the reference's `_device_constants` as tensors.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import field as F
from . import pallas_field as PF
from .cuda_lib import launch, launches, lib, on_cuda, \
    ptr  # noqa: F401 (launches: callers read the counts here)

ALPHA = 5
R_FULL = 8
R_PARTIAL = 57  # 128-bit security for ~255-bit primes, alpha=5, t=3


def _grain_bits(p_bits: int, t: int, r_f: int, r_p: int):
    """Self-shrinking Grain LFSR bit stream per the Poseidon paper."""
    def enc(val, width):
        return [(val >> (width - 1 - i)) & 1 for i in range(width)]

    state = (enc(1, 2) + enc(0, 4) + enc(p_bits, 12) + enc(t, 12)
             + enc(r_f, 10) + enc(r_p, 10) + [1] * 30)
    assert len(state) == 80

    def clock():
        nb = (state[62] ^ state[51] ^ state[38] ^ state[23]
              ^ state[13] ^ state[0])
        state.pop(0)
        state.append(nb)
        return nb

    for _ in range(160):
        clock()
    while True:
        b1 = clock()
        b2 = clock()
        if b1:
            yield b2


@dataclass(frozen=True)
class PoseidonSpec:
    field: F.FieldSpec
    t: int
    r_full: int
    r_partial: int
    round_constants: Tuple[Tuple[int, ...], ...]  # (n_rounds, t)
    mds: Tuple[Tuple[int, ...], ...]              # (t, t)

    @property
    def n_rounds(self) -> int:
        return self.r_full + self.r_partial


@lru_cache(maxsize=None)
def make_spec(field_name: str, t: int = 3, r_full: int = R_FULL,
              r_partial: int = R_PARTIAL) -> PoseidonSpec:
    field = F.FIELDS[field_name]
    p = field.p
    n_bits = p.bit_length()
    bits = _grain_bits(n_bits, t, r_full, r_partial)

    def sample_field():
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | next(bits)
            if v < p:
                return v

    rc = tuple(tuple(sample_field() for _ in range(t))
               for _ in range(r_full + r_partial))
    mds = tuple(tuple(pow((x + y) % p, p - 2, p) for y in range(t, 2 * t))
                for x in range(t))
    return PoseidonSpec(field, t, r_full, r_partial, rc, mds)


def neptune_round_numbers(t: int, n_bits: int = 255, m: int = 128,
                          security_margin: bool = True) -> Tuple[int, int]:
    """(R_F, R_P) per neptune 13.0.0's round_numbers.rs search (minimum
    sbox count over even R_F under the statistical, interpolation and
    Groebner bounds, then R_F += 2, R_P *= 1.075)."""
    def secure(rf: int, rp: int) -> bool:
        rf_stat = 6.0 if m <= (n_bits - 3.0) * (t + 1.0) else 10.0
        rf_interp = 0.43 * m + math.log2(t) - rp
        rf_grob_1 = 0.21 * n_bits - rp
        rf_grob_2 = (0.14 * n_bits - 1.0 - rp) / (t - 1.0)
        return rf >= max(rf_stat, rf_interp, rf_grob_1, rf_grob_2)

    best = None
    for rf in range(2, 1001, 2):
        for rp in range(4, 1001):
            if secure(rf, rp):
                rf_f, rp_f = rf, rp
                if security_margin:
                    rf_f = rf + 2
                    rp_f = math.ceil(rp * 1.075)
                cost = t * rf_f + rp_f
                if best is None or cost < best[0]:
                    best = (cost, rf_f, rp_f)
                break
    assert best is not None
    return best[1], best[2]


def neptune_domain_tag(arity: int = None, const_len: int = None) -> int:
    """neptune `hash_type.rs` domain tags: Standard/MerkleTree(arity) =
    2^arity - 1; ConstantLength(l) = l * 2^64. Exactly one selector."""
    assert (arity is None) != (const_len is None)
    if arity is not None:
        return (1 << arity) - 1
    return const_len << 64


@lru_cache(maxsize=None)
def make_spec_neptune(field_name: str, arity: int = 2) -> PoseidonSpec:
    """neptune-parameterised spec: t = arity + 1, neptune's round numbers
    at n = 255 bits, the shared Grain constants and Cauchy MDS."""
    r_f, r_p = neptune_round_numbers(arity + 1, n_bits=255)
    return make_spec(field_name, arity + 1, r_f, r_p)


def spec_for(field_name: str) -> PoseidonSpec:
    """The transcript spec selected by HOTPROOFS_POSEIDON ("default" or
    "neptune"), as in the reference."""
    from ..utils.config import CONFIG
    if CONFIG.poseidon == "neptune":
        return make_spec_neptune(field_name, arity=2)
    return make_spec(field_name)


def host_permute(spec: PoseidonSpec, state: Sequence[int]) -> List[int]:
    p = spec.field.p
    s = [v % p for v in state]
    half = spec.r_full // 2
    for rnd in range(spec.n_rounds):
        s = [(v + c) % p for v, c in zip(s, spec.round_constants[rnd])]
        if rnd < half or rnd >= half + spec.r_partial:
            s = [pow(v, ALPHA, p) for v in s]
        else:
            s[0] = pow(s[0], ALPHA, p)
        s = [sum(m * v for m, v in zip(row, s)) % p for row in spec.mds]
    return s


# ---------------------------------------------------------------------------
# The batched permutation on (..., t, 32) Montgomery digits.
# ---------------------------------------------------------------------------

# The state widths the kernel is built for (csrc/poseidon.cu): 3, the
# transcript's, and 5 and 9, neptune's arities 4 and 8.
KERNEL_T = (3, 5, 9)

_DEV_CONSTS: Dict[tuple, tuple] = {}
_KERNEL_CONSTS: Dict[tuple, torch.Tensor] = {}


def _spec_key(spec: PoseidonSpec) -> tuple:
    return (spec.field.name, spec.t, spec.r_full, spec.r_partial)


def device_constants(spec: PoseidonSpec, device="cpu") -> tuple:
    """(round constants (R, t, 32), MDS (t, t, 32), full-round mask (R,)):
    the constants as Montgomery int32 digits and the mask as int32 (1 for
    a full round), the reference's _device_constants on `device`."""
    key = _spec_key(spec) + (str(torch.device(device)),)
    if key not in _DEV_CONSTS:
        fld = spec.field
        rc = np.stack([fld.batch_to_limbs([fld.to_mont_int(c) for c in row])
                       for row in spec.round_constants])
        mds = np.stack([fld.batch_to_limbs([fld.to_mont_int(m) for m in row])
                        for row in spec.mds])
        half = spec.r_full // 2
        mask = np.array([1 if (i < half or i >= half + spec.r_partial)
                         else 0 for i in range(spec.n_rounds)], np.int32)
        _DEV_CONSTS[key] = tuple(torch.from_numpy(a).to(device)
                                 for a in (rc, mds, mask))
    return _DEV_CONSTS[key]


def _sbox(fld: F.FieldSpec, x: torch.Tensor) -> torch.Tensor:
    x2 = F.h_mont_mul(fld, x, x)
    x4 = F.h_mont_mul(fld, x2, x2)
    return F.h_mont_mul(fld, x4, x)


def permute_plain(spec: PoseidonSpec, state: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the permutation on (..., t, 32) Montgomery
    digits (the half-word field code of ops/field.py), in the reference's
    round order: add the round's constants, x^5 on every lane in a full
    round and on lane 0 in a partial one, multiply by the MDS matrix."""
    fld = spec.field
    rc, mds, mask = device_constants(spec, state.device)
    rc, mds = F.to_h16(rc), F.to_h16(mds)
    s = F.to_h16(state)
    for rnd, full in enumerate(mask.tolist()):
        s = F.h_add(fld, s, rc[rnd])
        if full:
            s = _sbox(fld, s)
        else:
            s = torch.cat([_sbox(fld, s[..., :1, :]), s[..., 1:, :]], dim=-2)
        prod = F.h_mont_mul(fld, mds, s[..., None, :, :])   # (..., t, t, 16)
        acc = prod[..., 0, :]
        for j in range(1, spec.t):
            acc = F.h_add(fld, acc, prod[..., j, :])
        s = acc
    return F.from_h16(s)


def _kernel_consts(spec: PoseidonSpec, device) -> torch.Tensor:
    """The round constants then the MDS matrix as Montgomery words, one
    buffer on the card (what every thread of poseidon_permute reads)."""
    key = _spec_key(spec) + (str(device),)
    if key not in _KERNEL_CONSTS:
        rc, mds, _ = device_constants(spec, device)
        _KERNEL_CONSTS[key] = torch.cat([F.digits_to_words(rc).flatten(),
                                         F.digits_to_words(mds).flatten()])
    return _KERNEL_CONSTS[key]


def permute(spec: PoseidonSpec, state: torch.Tensor) -> torch.Tensor:
    """The permutation of every state of (..., t, 32) int32 Montgomery
    digits (canonical: digits 0..255, values below p): one launch of the
    poseidon_permute kernel for a tensor on the card (t in KERNEL_T),
    permute_plain for a tensor on the CPU."""
    if state.dtype != torch.int32:
        raise TypeError(f"poseidon permute: want int32, got {state.dtype}")
    if state.dim() < 2 or tuple(state.shape[-2:]) != (spec.t, F.N_LIMBS):
        raise ValueError(f"poseidon permute: want (..., {spec.t}, "
                         f"{F.N_LIMBS}) digits, got {tuple(state.shape)}")
    if not on_cuda("poseidon permute", state):
        return permute_plain(spec, state)
    if spec.t not in KERNEL_T:
        raise ValueError(f"poseidon permute: the kernel is built for t in "
                         f"{KERNEL_T}, not t = {spec.t}")
    x = state.contiguous()
    if x.data_ptr() % 16:                 # the kernel's 16-byte loads
        x = x.clone()
    out = torch.empty_like(x)
    n = x[..., 0, 0].numel()
    if n:
        launch("poseidon_permute", lib().hp_poseidon_permute,
               PF.consts_arg(spec.field), ptr(_kernel_consts(spec, x.device)),
               spec.t, spec.r_full, spec.r_partial, ptr(x), ptr(out),
               ctypes.c_longlong(n), device=x.device)
    return out


class HostSponge:
    """Duplex sponge (rate t-1, capacity 1) over exact ints: state starts
    [domain_tag, 0, ...]; absorb adds into the rate lanes and permutes after
    each full rate block; squeeze pads with a permute, permutes, returns
    lane 1."""

    def __init__(self, spec: PoseidonSpec, domain_tag: int):
        self.spec = spec
        self.p = spec.field.p
        self.state = [domain_tag % self.p] + [0] * (spec.t - 1)
        self._absorbed = 0

    def absorb(self, vals: Sequence[int]):
        rate = self.spec.t - 1
        for v in vals:
            lane = 1 + (self._absorbed % rate)
            self.state[lane] = (self.state[lane] + v) % self.p
            self._absorbed += 1
            if self._absorbed % rate == 0:
                self.state = host_permute(self.spec, self.state)

    def squeeze(self) -> int:
        if self._absorbed % (self.spec.t - 1) != 0:
            self.state = host_permute(self.spec, self.state)
            self._absorbed = 0
        self.state = host_permute(self.spec, self.state)
        return self.state[1]
