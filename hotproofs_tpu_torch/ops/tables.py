"""Spartan's matrix tables on Hopper (nova/spartan.py: preprocess_H).

For every row x of the three matrices M of a shape, H_M[x] = sum_y M[x, y]
G_y over the commitment key's generators: the tables the verifier commits
to L through, so that it never reads the matrices.

  h_tables  (replaces the reference's host loop, hotproofs_tpu/nova/
             spartan.py:427-493, one native fold_point a nonzero; kernel in
             csrc/tables.cu, where its design and what bounds it are noted)

It reads the key's own prepared bases (16^w G, lane-major, pedersen.py:
bases_lm) and adds, for each nonzero value v, one point per nonzero
radix-16 digit of min(v, p - v), negated where p - v is the shorter. Its
plain torch version below runs the same adds in the same order, so the two
agree bit for bit in projective form. The wrapper takes the plain version
only for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from . import curve as C
from . import field as F
from . import msm_pallas as MP
from .cuda_lib import check_input as _check_input, launch as _launch, lib, \
    on_cuda as _on_cuda, ptr as _ptr

NW = MP.NW
WINDOWS = 64          # radix-16 windows of a 256-bit value
HALVES = 2            # a row's nonzeros alternate between two half-warps


@dataclass
class TableCSR:
    """The three matrices stacked into R = 3m rows, row-sorted (the
    kernel's inputs; csrc/tables.cuh holds the layouts)."""

    row_ptr: torch.Tensor   # (R + 1,) int32
    order: torch.Tensor     # (R,) int32: the rows, longest first
    cols: torch.Tensor      # (nnz,) int32
    mag: torch.Tensor       # (nnz, 8) int32 words of min(v, p - v)
    neg: torch.Tensor       # (nnz,) int32: 1 where mag = p - v

    @property
    def rows(self) -> int:
        return self.order.shape[0]


def _less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b for (n, 16) int64 halves of canonical values."""
    res = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    d = torch.sign(a - b)
    for i in range(F.N_H16 - 1, -1, -1):
        res = torch.where(res == 0, d[:, i], res)
    return res < 0


def table_csr(fspec: F.FieldSpec, mats: Sequence[Tuple[torch.Tensor,
                                                        torch.Tensor,
                                                        torch.Tensor]],
              m: int) -> TableCSR:
    """mats: each matrix's row-sorted (rows, cols, Montgomery h16 values)
    on one device, rows < m -> the stacked CSR, matrix i at rows [i m,
    (i + 1) m)."""
    rows = torch.cat([r + i * m for i, (r, _, _) in enumerate(mats)])
    cols = torch.cat([c for _, c, _ in mats])
    v = F.to_h16(F.from_mont(fspec, F.from_h16(torch.cat(
        [x for _, _, x in mats]))))
    pv = F.h_neg(fspec, v)
    neg = _less(pv, v)
    mag = F.h16_to_words(torch.where(neg[:, None], pv, v))
    R = len(mats) * m
    counts = torch.bincount(rows, minlength=R)
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    order = torch.argsort(counts, descending=True, stable=True)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return TableCSR(row_ptr=i32(row_ptr), order=i32(order), cols=i32(cols),
                    mag=i32(mag), neg=i32(neg))


def _digits(mag: torch.Tensor) -> torch.Tensor:
    """(nnz, 8) words -> (nnz, 64) radix-16 digits, window w of word w / 8
    at bit 4 (w % 8)."""
    w = mag.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(0, 32, 4, device=mag.device)
    return ((w[:, :, None] >> sh) & 15).reshape(mag.shape[0], WINDOWS)


def h_tables_plain(spec: C.CurveSpec, csr: TableCSR, bases_lm: torch.Tensor,
                   lpw: int) -> torch.Tensor:
    """Plain torch version of h_tables, in the kernel's order: bucket
    (row, half, digit value) mixed-adds its (nonzero, window) entries from
    the identity in the order of the nonzero, then the window, all buckets
    a step at once; msm_wsum_plain sums v * B_v of each half (K3's lane
    schedule at 15 slots), and the first half takes the second by acc_add.
    -> (R, 3, 8) projective words."""
    R, dev = csr.rows, csr.cols.device
    B = bases_lm.shape[1]
    nb = R * HALVES * MP.NBUCKET
    start = csr.row_ptr.to(torch.int64)
    counts = start[1:] - start[:-1]
    row = torch.repeat_interleave(torch.arange(R, device=dev), counts)
    half = (torch.arange(row.shape[0], device=dev) - start[row]) % HALVES
    dig = _digits(csr.mag)
    kk, ww = dig.nonzero(as_tuple=True)        # k ascending, then w
    bucket = (row[kk] * HALVES + half[kk]) * MP.NBUCKET + dig[kk, ww] - 1
    srt = torch.argsort(bucket, stable=True)
    kk, ww, bucket = kk[srt], ww[srt], bucket[srt]
    per = torch.bincount(bucket, minlength=nb)
    pos = torch.arange(bucket.shape[0], device=dev) - \
        (torch.cumsum(per, 0) - per)[bucket]
    col = csr.cols[kk].to(torch.int64)
    base = bases_lm[ww * lpw + col // B, col % B]            # (E, 2, 8)
    bx, by = F.words_to_h16(base[:, 0]), F.words_to_h16(base[:, 1])
    by = torch.where(csr.neg[kk].bool()[:, None], F.h_neg(spec.base, by), by)
    acc = C.h_identity(spec, (nb,), dev)
    for s in range(int(per.max()) if nb else 0):
        sel = pos == s
        b = bucket[sel]
        new = C.h_pt_add_mixed(spec, tuple(c[b] for c in acc),
                               (bx[sel], by[sel]))
        for c, n in zip(acc, new):
            c[b] = n
    sums = MP.msm_wsum_plain(spec, MP._proj_words(acc).reshape(
        R * HALVES, MP.NBUCKET, 3, NW)).reshape(R, HALVES, 3, NW)
    h = [tuple(F.words_to_h16(sums[:, i, c]) for c in range(3))
         for i in range(HALVES)]
    return MP._proj_words(MP._acc_add(spec, h[0], h[1])).contiguous()


def h_tables(spec: C.CurveSpec, csr: TableCSR, bases_lm: torch.Tensor,
             lpw: int) -> torch.Tensor:
    """The tables of csr's R rows over the key's lane-major bases
    (n_lanes, B, 2, 8) of plan(n, 256) with lpw lanes a window (every
    column < n): (R, 3, 8) projective Montgomery words, the identity for a
    row without nonzeros (one launch)."""
    R, nnz = csr.rows, csr.cols.shape[0]
    L, B = bases_lm.shape[:2]
    _check_input("h_tables row_ptr", csr.row_ptr, (R + 1,))
    _check_input("h_tables order", csr.order, (R,))
    _check_input("h_tables cols", csr.cols, (nnz,))
    _check_input("h_tables mag", csr.mag, (nnz, NW))
    _check_input("h_tables neg", csr.neg, (nnz,))
    _check_input("h_tables bases_lm", bases_lm, (L, B, 2, NW))
    if L != WINDOWS * lpw:
        raise ValueError(f"h_tables: {L} lanes are not {WINDOWS} windows of "
                         f"{lpw}")
    if not _on_cuda("h_tables", csr.row_ptr, csr.order, csr.cols, csr.mag,
                    csr.neg, bases_lm):
        return h_tables_plain(spec, csr, bases_lm, lpw)
    out = torch.empty((R, 3, NW), dtype=torch.int32, device=bases_lm.device)
    if R:
        _launch("h_tables", lib().hp_h_tables, MP._consts_arg(spec),
                _ptr(csr.row_ptr), _ptr(csr.order), _ptr(csr.cols),
                _ptr(csr.mag), _ptr(csr.neg), _ptr(bases_lm), _ptr(out), R,
                B, lpw, device=bases_lm.device)
    return out


def table_work(csr: TableCSR) -> Tuple[int, int, int]:
    """(mixed adds, complete adds, base points) the tables' data needs: a
    mixed add per nonzero digit; a complete add per distinct digit value of
    a row beyond its first (the least that joins its buckets, their weights
    left out); the distinct (window, column) bases those digits read."""
    dig = _digits(csr.mag)
    kk, ww = dig.nonzero(as_tuple=True)
    start = csr.row_ptr.to(torch.int64)
    row = torch.repeat_interleave(torch.arange(csr.rows,
                                               device=dig.device),
                                  start[1:] - start[:-1])
    vals = torch.unique(row[kk] * 16 + dig[kk, ww])
    rows_live = torch.unique(vals // 16).shape[0]
    bases = torch.unique(ww * (1 << 31) + csr.cols[kk].to(torch.int64))
    return kk.shape[0], vals.shape[0] - rows_live, bases.shape[0]
