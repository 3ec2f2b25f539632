"""Spartan's matrix tables on Hopper (nova/spartan.py: preprocess_H).

For every row x of the three matrices M of a shape, H_M[x] = sum_y M[x, y]
G_y over the commitment key's generators: the tables the verifier commits
to L through, so that it never reads the matrices.

  h_tables  (replaces the reference's host loop, hotproofs_tpu/nova/
             spartan.py:427-493, one native fold_point a nonzero; kernel in
             csrc/tables.cu, where its design and what bounds it are noted)

It reads the key's own prepared bases (16^w G, lane-major, pedersen.py:
bases_lm) and adds, for each nonzero value v, one point per nonzero
radix-16 digit of min(v, p - v), negated where p - v is the shorter. A row
is one warp; its 32 lanes are shared out over the row's digit values by
lane_alloc, so that each lane walks about as many digits as the others.
Its plain torch version below runs the same adds in the same order, so the
two agree bit for bit in projective form. The wrapper takes the plain
version only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises.
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
LANES = 32            # one warp a row


@dataclass
class TableCSR:
    """The three matrices stacked into R = 3m rows, row-sorted (the
    kernel's inputs; csrc/tables.cuh holds the layouts)."""

    row_ptr: torch.Tensor   # (R + 1,) int32
    order: torch.Tensor     # (R,) int32: the rows, longest walk first
    alloc: torch.Tensor     # (R, 4) int32: byte v - 1 = lanes of value v
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
    i32 = lambda t: t.to(torch.int32).contiguous()
    n = value_counts(i32(row_ptr), mag)
    a = lane_alloc(n)
    order = torch.argsort(row_walk(n, a), descending=True, stable=True)
    packed = (a.to(torch.int64) << (8 * (torch.arange(
        16, device=a.device) % 4))).reshape(R, 4, 4).sum(dim=2)
    return TableCSR(row_ptr=i32(row_ptr), order=i32(order),
                    alloc=i32(packed), cols=i32(cols),
                    mag=i32(mag), neg=i32(neg))


def value_counts(row_ptr: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """(R, 16) int64: the digits of each value 1..15 in each row (column
    v - 1; column 15 is 0), one word of the values at a time."""
    R = row_ptr.shape[0] - 1
    start = row_ptr.to(torch.int64)
    row = torch.repeat_interleave(torch.arange(R, device=mag.device),
                                  start[1:] - start[:-1])
    out = torch.zeros(R * 16, dtype=torch.int64, device=mag.device)
    sh = torch.arange(0, 32, 4, device=mag.device)
    for i in range(NW):
        d = (mag[:, i].to(torch.int64)[:, None] >> sh) & 15      # (nnz, 8)
        out.index_add_(0, (row[:, None] * 16 + d).reshape(-1),
                       torch.ones(d.numel(), dtype=torch.int64,
                                  device=mag.device))
    out = out.reshape(R, 16)
    return torch.cat([out[:, 1:], torch.zeros_like(out[:, :1])], dim=1)


def row_walk(n: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(R,) the mixed adds of each row's busiest lane: max_v ceil(n_v /
    a_v) for (R, 16) digit counts n and lanes a."""
    return (-(-n // a.clamp(min=1))).amax(dim=1)


def lane_alloc(n: torch.Tensor) -> torch.Tensor:
    """(R, 16) digit counts -> (R, 16) lanes a value: one lane for each
    value the row holds, then each spare lane of the 32 in turn to the
    value of the most adds a lane (ceil(n_v / a_v); the lower value on a
    tie), never more lanes than digits, while that is more than 1."""
    a = (n > 0).to(torch.int64)
    rows = torch.arange(n.shape[0], device=n.device)
    rank = torch.arange(16, 0, -1, device=n.device)      # lower v first
    for _ in range(LANES):
        steps = -(-n // a.clamp(min=1))
        key = torch.where(a < n, steps * 32 + rank, torch.zeros_like(n))
        best, v = key.max(dim=1)
        ok = (a.sum(dim=1) < LANES) & (best >= 2 * 32)
        if not bool(ok.any()):
            break
        a[rows[ok], v[ok]] += 1
    return a


def _digits(mag: torch.Tensor) -> torch.Tensor:
    """(nnz, 8) words -> (nnz, 64) radix-16 digits, window w of word w / 8
    at bit 4 (w % 8)."""
    w = mag.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(0, 32, 4, device=mag.device)
    return ((w[:, :, None] >> sh) & 15).reshape(mag.shape[0], WINDOWS)


def lane_map(alloc: torch.Tensor):
    """(R, 4) packed alloc -> per (row, lane) (R, 32) value (0 idle), part
    and parts, and (R, 16) a and s (each value's first lane): the lane map
    of csrc/tables.cuh's table_lane_map."""
    R = alloc.shape[0]
    sh = 8 * (torch.arange(16, device=alloc.device) % 4)
    a = (alloc.to(torch.int64)[:, torch.arange(16, device=alloc.device) // 4]
         >> sh) & 0xFF                                     # (R, 16)
    ends = torch.cumsum(a, dim=1)
    s = ends - a
    lane = torch.arange(LANES, device=alloc.device).expand(R, LANES)
    vi = torch.searchsorted(ends, lane.contiguous(), right=True)   # v - 1
    live = vi < 16
    vi = vi.clamp(max=15)
    part = lane - torch.gather(s, 1, vi)
    parts = torch.gather(a, 1, vi)
    live &= part < parts
    value = torch.where(live, vi + 1, torch.zeros_like(vi))
    return value, part, parts, a, s


def h_tables_plain(spec: C.CurveSpec, csr: TableCSR, bases_lm: torch.Tensor,
                   lpw: int) -> torch.Tensor:
    """Plain torch version of h_tables, in the kernel's order: lane (v,
    part) of a row mixed-adds from the identity the row's matches i of
    value v (its (nonzero, window) entries in the order of the nonzero,
    then the window) with i % a_v = part, all lanes a step at once; then
    the halving trees over each value's parts (acc_add), value v's sum as
    slot v - 1, and msm_wsum_plain's v * B_v over the 15 slots (K3's lane
    schedule). -> (R, 3, 8) projective words."""
    R, dev = csr.rows, csr.cols.device
    B = bases_lm.shape[1]
    value, part, parts, a, s = lane_map(csr.alloc)
    start = csr.row_ptr.to(torch.int64)
    counts = start[1:] - start[:-1]
    row = torch.repeat_interleave(torch.arange(R, device=dev), counts)
    dig = _digits(csr.mag)
    kk, ww = dig.nonzero(as_tuple=True)        # k ascending, then w
    r, v = row[kk], dig[kk, ww]
    key = r * 16 + v - 1
    srt = torch.argsort(key, stable=True)
    kk, ww, r, key = kk[srt], ww[srt], r[srt], key[srt]
    per = torch.bincount(key, minlength=R * 16)
    i = torch.arange(key.shape[0], device=dev) - \
        (torch.cumsum(per, 0) - per)[key]      # match index within (r, v)
    av, sv = a.reshape(-1)[key], s.reshape(-1)[key]
    bucket = r * LANES + sv + i % av
    pos = i // av
    col = csr.cols[kk].to(torch.int64)
    base = bases_lm[ww * lpw + col // B, col % B]            # (E, 2, 8)
    bx, by = F.words_to_h16(base[:, 0]), F.words_to_h16(base[:, 1])
    by = torch.where(csr.neg[kk].bool()[:, None], F.h_neg(spec.base, by), by)
    nb = R * LANES
    acc = C.h_identity(spec, (nb,), dev)
    for step in range(int(pos.max()) + 1 if pos.numel() else 0):
        sel = pos == step
        b = bucket[sel]
        new = C.h_pt_add_mixed(spec, tuple(c[b] for c in acc),
                               (bx[sel], by[sel]))
        for c, n in zip(acc, new):
            c[b] = n
    flat = torch.arange(nb, device=dev)
    off = 1
    while off < LANES:
        take = ((value > 0) & (part % (2 * off) == 0)
                & (part + off < parts)).reshape(-1)
        if bool(take.any()):
            d = flat[take]
            new = MP._acc_add(spec, tuple(c[d] for c in acc),
                              tuple(c[d + off] for c in acc))
            for c, n in zip(acc, new):
                c[d] = n
        off *= 2
    head = (torch.arange(R, device=dev)[:, None] * LANES + s)[:, :MP.NBUCKET]
    slots = MP._proj_words(tuple(c[head.reshape(-1)] for c in acc))
    ident = MP._proj_words(C.h_identity(spec, (1,), dev))
    slots = torch.where((a[:, :MP.NBUCKET] > 0).reshape(-1, 1, 1), slots,
                        ident).reshape(R, MP.NBUCKET, 3, NW)
    return MP.msm_wsum_plain(spec, slots.contiguous()).contiguous()


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
    _check_input("h_tables alloc", csr.alloc, (R, 4))
    _check_input("h_tables cols", csr.cols, (nnz,))
    _check_input("h_tables mag", csr.mag, (nnz, NW))
    _check_input("h_tables neg", csr.neg, (nnz,))
    _check_input("h_tables bases_lm", bases_lm, (L, B, 2, NW))
    if L != WINDOWS * lpw:
        raise ValueError(f"h_tables: {L} lanes are not {WINDOWS} windows of "
                         f"{lpw}")
    if not _on_cuda("h_tables", csr.row_ptr, csr.order, csr.alloc, csr.cols,
                    csr.mag, csr.neg, bases_lm):
        return h_tables_plain(spec, csr, bases_lm, lpw)
    out = torch.empty((R, 3, NW), dtype=torch.int32, device=bases_lm.device)
    if R:
        _launch("h_tables", lib().hp_h_tables, MP._consts_arg(spec, True),
                _ptr(csr.row_ptr), _ptr(csr.order), _ptr(csr.alloc),
                _ptr(csr.cols), _ptr(csr.mag), _ptr(csr.neg),
                _ptr(bases_lm), _ptr(out), R, B, lpw,
                device=bases_lm.device)
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


def table_steps(csr: TableCSR) -> Tuple[int, int]:
    """(walk, join) warp-steps of the kernel's lane map on csr's rows: a
    row's walk runs as many mixed adds as its busiest lane (row_walk); its
    join runs a level of complete adds wherever some lane adds two points
    that are not the identity: ceil(log2 max_v a_v) levels of the parts'
    trees (every lane holds a digit), then the suffix scan and halving
    tree of K3's schedule over the 15 value sums, where a sum is the
    identity iff the row has no digit of that value."""
    n = value_counts(csr.row_ptr, csr.mag)
    _, _, _, a, _ = lane_map(csr.alloc)
    walk = int(row_walk(n, a).sum())
    amax = a.amax(dim=1)
    seg = torch.zeros_like(amax)
    off = 1
    while bool((amax > off).any()):
        seg += (amax > off).to(seg.dtype)
        off *= 2
    live = torch.cat([n[:, :MP.NBUCKET] > 0, torch.zeros_like(
        n[:, :1], dtype=torch.bool)], dim=1)               # (R, 16)
    join = int(seg.sum())
    v = torch.arange(16, device=n.device)
    off = 1
    while off < 16:                          # T_v = B_v + ... + B_15
        o = torch.roll(live, -off, dims=1) & (v + off < 16)
        join += int((live & o).any(dim=1).sum())
        live = live | o
        off *= 2
    off = 8
    while off:                               # the sum of the T_v
        o = torch.roll(live, -off, dims=1) & (v < off)
        join += int((live & o).any(dim=1).sum())
        live = torch.where(v < off, live | o, live)
        off //= 2
    return walk, join
