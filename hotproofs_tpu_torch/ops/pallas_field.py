"""The batched Montgomery multiply on Hopper, with its staged and partial
forms (port of hotproofs_tpu/ops/pallas_field.py and of the kernels of the
TPU tools bench_pallas_bisect.py and bench_pallas_parts.py).

  K5   mont_mul        (replaces _mont_mul_kernel / mont_mul_lm,
                        pallas_field.py:267, 296, and mont_mul_em, :320)
  K10  mont_mul_stage  (replaces k1..k5, tools/bench_pallas_bisect.py:45-73)
  K11a mont_mul_part   (replaces k_conv, k_conv3, k_norm,
                        tools/bench_pallas_parts.py:46-62)
  K11b conv_mma        (replaces conv_mxu / k_conv_mxu,
                        tools/bench_pallas_parts.py:85, 74)

The kernels are CUDA C++ in csrc/mont.cu and csrc/conv_mma.cu (what bounds
each and how it is laid out is noted there). K5 is the kernel behind the
public field.mont_mul, to_mont and from_mont; the other three exist to time
the product's pieces (tools/field_mul.py).

A field element is the reference's 32 base-2^8 int32 digits, element-major
(..., 32) or limb-major (32, N); mont_mul_words takes (N, 8) u32 words.
Every operand must be canonical: digits in 0..255 and the value below p
(the CIOS product needs a * b < p * 2^256). Nothing checks that on the card.

Beside each wrapper is its plain torch version and a launch count. The
plain versions of the stages and parts work digit by digit, as the TPU
kernels did, and so are independent of the kernels' word arithmetic. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import numpy as np
import torch

from . import field as F
from .cuda_lib import check_input, launch, launches, lib, on_cuda, \
    ptr  # noqa: F401 (launches: callers read the counts here)

L = F.N_LIMBS            # 32 digits
NW = 8                   # u32 words per field element
EM, LM, WORDS = 0, 1, 2  # csrc/mont.cuh: Layout
STAGES = (1, 2, 3, 4, 5)
PARTS = ("conv", "conv3", "norm")   # csrc/mont.cuh: Part, in this order

_CONSTS: Dict[str, ctypes.Array] = {}
_DIGITS: Dict[Tuple[str, str, str], torch.Tensor] = {}


def field_consts_words(spec: F.FieldSpec) -> np.ndarray:
    """The csrc `FieldConsts` pack: p, mu = -p^-1 mod 2^256 and
    -p^-1 mod 2^32, as 17 little-endian u32 words."""
    words = lambda v: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(NW)]
    mu = F.limbs_to_int(spec.mu_limbs)
    return np.asarray(words(spec.p) + words(mu) + [mu & 0xFFFFFFFF],
                      np.uint32)


def consts_arg(spec: F.FieldSpec) -> ctypes.Array:
    """field_consts_words as the ctypes array a launcher takes."""
    if spec.name not in _CONSTS:
        w = field_consts_words(spec)
        _CONSTS[spec.name] = (ctypes.c_uint32 * len(w))(*w.tolist())
    return _CONSTS[spec.name]


def const_digits(spec: F.FieldSpec, which: str, device) -> torch.Tensor:
    """(32,) int32 digits of a field constant on `device`: "r2" (R^2 mod p,
    the to_mont factor), "unit" (1, the from_mont factor), "p" or "mu"."""
    key = (spec.name, which, str(torch.device(device)))
    if key not in _DIGITS:
        limbs = {"r2": spec.r2_limbs, "unit": F.int_to_limbs(1),
                 "p": spec.p_limbs, "mu": spec.mu_limbs}[which]
        _DIGITS[key] = torch.from_numpy(np.asarray(limbs, np.int32)).to(
            device)
    return _DIGITS[key]


# ---------------------------------------------------------------------------
# K5: the batched Montgomery product.
# ---------------------------------------------------------------------------


def _aligned(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor must be 16-byte aligned")


def _mont_mul_launch(spec, a, na, b, nb, out, n, layout) -> None:
    if n:
        launch("mont_mul", lib().hp_mont_mul, consts_arg(spec), ptr(a), na,
               ptr(b), nb, ptr(out), n, layout, device=out.device)


def mont_mul_em_plain(spec: F.FieldSpec, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K5 on (..., 32) digits (broadcasting): the
    half-word product of ops/field.py."""
    return F.mont_mul_plain(spec, a, b)


def _operand(t: torch.Tensor, shape) -> Tuple[torch.Tensor, int]:
    """t broadcast to `shape` as the kernel reads it: a contiguous tensor
    and its element count. A tensor that is the trailing block of `shape`
    (a constant, or one row block repeated along the leading axes) stays
    as small as it is, and the kernel indexes it modulo its count; any
    other broadcast is written out."""
    core = tuple(t.shape)
    while len(core) > 1 and core[0] == 1:
        core = core[1:]
    if core == tuple(shape[len(shape) - len(core):]):
        t = t.reshape(core)
    else:
        t = t.expand(shape)
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t, t.numel() // L


def mont_mul_em(spec: F.FieldSpec, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """K5 on element-major digits: a * b * 2^-256 mod p for (..., 32) int32
    operands that broadcast against each other, any number of elements,
    any strides. Both must be canonical (digits 0..255, value < p)."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"mont_mul_em {name}: want int32, got {t.dtype}")
        if t.dim() < 1 or t.shape[-1] != L:
            raise ValueError(f"mont_mul_em {name}: want (..., {L}) digits, "
                             f"got {tuple(t.shape)}")
    # (the common cases first: broadcast_shapes alone costs the host more
    # than the kernel runs)
    shape = a.shape if a.shape == b.shape or b.dim() == 1 else \
        torch.broadcast_shapes(a.shape, b.shape)
    if not on_cuda("mont_mul_em", a, b):
        return mont_mul_em_plain(spec, a, b)
    (a, na), (b, nb) = _operand(a, shape), _operand(b, shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    _mont_mul_launch(spec, a, na, b, nb, out, math.prod(shape[:-1]), EM)
    return out


def mont_mul_lm_plain(spec: F.FieldSpec, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K5 on limb-major (32, N) digits."""
    return mont_mul_em_plain(spec, a.T, b.T).T.contiguous()


def _check_lm(name: str, a: torch.Tensor, b: torch.Tensor) -> int:
    """Both (32, N) int32, contiguous; returns N."""
    if a.dim() != 2 or a.shape[0] != L:
        raise ValueError(f"{name}: want limb-major (32, N) digits, got "
                         f"{tuple(a.shape)}")
    check_input(f"{name} a", a, a.shape)
    check_input(f"{name} b", b, a.shape)
    return a.shape[1]


def mont_mul_lm(spec: F.FieldSpec, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """K5 on limb-major digits: (32, N) x (32, N) -> (32, N), any N."""
    n = _check_lm("mont_mul_lm", a, b)
    if not on_cuda("mont_mul_lm", a, b):
        return mont_mul_lm_plain(spec, a, b)
    out = torch.empty_like(a)
    _mont_mul_launch(spec, a, n, b, n, out, n, LM)
    return out


def mont_mul_words_plain(spec: F.FieldSpec, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K5 on (N, 8) words."""
    return F.h16_to_words(F.h_mont_mul(spec, F.words_to_h16(a),
                                       F.words_to_h16(b)))


def mont_mul_words(spec: F.FieldSpec, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K5 on words: (N, 8) x (N, 8) int32 (holding u32) -> (N, 8)."""
    if a.dim() != 2 or a.shape[1] != NW:
        raise ValueError(f"mont_mul_words: want (N, {NW}) words, got "
                         f"{tuple(a.shape)}")
    check_input("mont_mul_words a", a, a.shape)
    check_input("mont_mul_words b", b, a.shape)
    if not on_cuda("mont_mul_words", a, b):
        return mont_mul_words_plain(spec, a, b)
    _aligned("mont_mul_words", a, b)
    out = torch.empty_like(a)
    n = a.shape[0]
    _mont_mul_launch(spec, a, n, b, n, out, n, WORDS)
    return out


# ---------------------------------------------------------------------------
# Digit-serial pieces of the plain stages and parts: (rows, N) int64 digit
# tensors, limbs along axis 0, as the TPU kernels held them.
# ---------------------------------------------------------------------------


def _conv(a: torch.Tensor, b: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Lazy columns of the digit convolution: a (rows_a, N) with b (32, N)
    or a constant column (32, 1) -> (out_rows, N)."""
    acc = torch.zeros((out_rows, a.shape[1]), dtype=torch.int64,
                      device=a.device)
    for j in range(min(a.shape[0], out_rows)):
        hi = min(j + L, out_rows)
        acc[j:hi] += a[j:j + 1] * b[:hi - j]
    return acc


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Exact carry propagation over the rows; the carry out of the top row
    is dropped."""
    t = t.clone()
    for k in range(t.shape[0] - 1):
        t[k + 1] += t[k] >> 8
        t[k] &= 0xFF
    t[-1] &= 0xFF
    return t


def _cond_sub(x: torch.Tensor, p_col: torch.Tensor) -> torch.Tensor:
    """x - p where x >= p, else x: canonical digit rows x (rows, N), p_col
    (rows, 1)."""
    d = x - p_col
    borrow = torch.zeros_like(d[0])
    for k in range(d.shape[0]):
        d[k] -= borrow
        borrow = (d[k] < 0).to(torch.int64)
        d[k] &= 0xFF
    return torch.where(borrow[None] == 0, d, x)


def _col(spec: F.FieldSpec, which: str, device, rows: int = L) -> torch.Tensor:
    c = const_digits(spec, which, device).to(torch.int64)[:, None]
    return torch.nn.functional.pad(c, (0, 0, 0, rows - L))


# ---------------------------------------------------------------------------
# K10: the five staged prefixes.
# ---------------------------------------------------------------------------


def mont_mul_stage_plain(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor,
                         stage: int) -> torch.Tensor:
    """Plain torch version of K10: the all-digit staged product (the
    reference's mont_mul_rows, legacy branch) cut after `stage`."""
    dev = a.device
    a, b = a.to(torch.int64), b.to(torch.int64)
    t = _carry(_conv(a, b, 2 * L))                        # exact T
    if stage == 1:
        return t[:L].to(torch.int32)
    m = _carry(_conv(t[:L], _col(spec, "mu", dev), L))    # T mu mod R
    if stage == 2:
        return m.to(torch.int32)
    u = t + _conv(m, _col(spec, "p", dev), 2 * L)         # lazy, R | u
    if stage == 3:
        return u[:L].to(torch.int32)
    res = _carry(torch.nn.functional.pad(u, (0, 0, 0, 1)))[L:]   # (33, N)
    if stage == 4:
        return res[:L].to(torch.int32)
    return _cond_sub(res, _col(spec, "p", dev, L + 1))[:L].to(torch.int32)


def mont_mul_stage(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor,
                   stage: int) -> torch.Tensor:
    """K10 on limb-major (32, N) digits -> (32, N) int32: the staged product
    T = a b; m = T mu mod R; U = T + m p; U / R; conditional subtract, cut
    after `stage`: 1 the digits of T mod R, 2 those of m, 3 the low 32 lazy
    columns of U, 4 the low 32 digits of U / R, 5 the product."""
    if stage not in STAGES:
        raise ValueError(f"mont_mul_stage: stage {stage!r} not in {STAGES}")
    n = _check_lm("mont_mul_stage", a, b)
    if not on_cuda("mont_mul_stage", a, b):
        return mont_mul_stage_plain(spec, a, b, stage)
    out = torch.empty_like(a)
    if n:
        launch("mont_mul_stage", lib().hp_mont_mul_stage, consts_arg(spec),
               ptr(a), ptr(b), ptr(out), n, stage, device=a.device)
    return out


# ---------------------------------------------------------------------------
# K11a: the three parts.
# ---------------------------------------------------------------------------


def mont_mul_part_plain(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor,
                        part: str) -> torch.Tensor:
    """Plain torch version of K11a (see mont_mul_part)."""
    dev = a.device
    a, b = a.to(torch.int64), b.to(torch.int64)
    if part == "conv":
        out = _conv(a, b, 2 * L)[:L] & 0xFF
    elif part == "conv3":
        t = _conv(a, b, 2 * L)
        m = _conv(t[:L] & 0xFF, _col(spec, "mu", dev), L)
        out = (t + _conv(m & 0xFF, _col(spec, "p", dev), 2 * L))[:L]
    else:
        t = _carry(torch.nn.functional.pad(a * 255 + b, (0, 0, 0, L)))
        out = _cond_sub(t[:L + 1], _col(spec, "p", dev, L + 1))[:L]
    return out.to(torch.int32)


def mont_mul_part(spec: F.FieldSpec, a: torch.Tensor, b: torch.Tensor,
                  part: str) -> torch.Tensor:
    """K11a on limb-major (32, N) digits -> (32, N) int32. part "conv": the
    low 32 columns of the digit convolution, & 0xFF; "conv3": three chained
    convolutions with & 0xFF masks and no carries, t = a b, m = (t & 0xFF)
    mu, out = t + (m & 0xFF) p (low 32 columns each); "norm": the exact
    carry of the columns 255 a_k + b_k, then the conditional subtract of p
    over 33 digits (low 32 digits)."""
    if part not in PARTS:
        raise ValueError(f"mont_mul_part: part {part!r} not in {PARTS}")
    n = _check_lm("mont_mul_part", a, b)
    if not on_cuda("mont_mul_part", a, b):
        return mont_mul_part_plain(spec, a, b, part)
    out = torch.empty_like(a)
    if n:
        launch("mont_mul_part", lib().hp_mont_mul_part, consts_arg(spec),
               ptr(a), ptr(b), ptr(out), n, PARTS.index(part),
               device=a.device)
    return out


# ---------------------------------------------------------------------------
# K11b: the convolution on the tensor cores.
# ---------------------------------------------------------------------------


def conv_mma_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K11b, in the kernel's formulation: per element
    col = T_b a, T_b the lower-triangular Toeplitz matrix of b's bytes
    (T_b[c][j] = b_{c-j}, 0 for j > c), on the low byte of every digit (the
    kernel's u8 operands)."""
    n = a.shape[1]
    idx = torch.arange(L, device=a.device)
    d = idx[:, None] - idx[None, :]
    bz = torch.cat([b & 0xFF, torch.zeros((1, n), dtype=b.dtype,
                                          device=b.device)])
    T = bz[torch.where(d >= 0, d, L)]                    # (32, 32, n)
    return (T * (a & 0xFF)[None]).sum(dim=1, dtype=torch.int32)


def conv_mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K11b on limb-major (32, N) digits -> (32, N) int32: the low 32 lazy
    columns sum_{j+k=c} a_j b_k of the digit convolution (no mask, no
    carry), computed per element as the Toeplitz matrix of b's bytes times
    a's bytes on the tensor cores (csrc/conv_mma.cuh). & 0xFF gives the
    "conv" part."""
    n = _check_lm("conv_mma", a, b)
    if not on_cuda("conv_mma", a, b):
        return conv_mma_plain(a, b)
    out = torch.empty_like(a)
    if n:
        launch("conv_mma", lib().hp_conv_mma, ptr(a), ptr(b), ptr(out), n,
               device=a.device)
    return out
