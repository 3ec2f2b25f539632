"""Fixed-base MSM and its key preparation on Hopper (port of
hotproofs_tpu/ops/msm_pallas.py, with ops/msm.py's n_windows4,
scale_points16 and _digits4).

Design (as in the reference): radix-16 digits; the window weight 16^w lives
in pre-scaled affine bases prepared once per key; all windows flatten into
one lane axis, lane l = w * lpw + c holding points [c*B, (c+1)*B) of window
w. J MSMs over one shared base array run as one chain of three kernels:

  K1 msm_bucket  (replaces _bucket_kernel, msm_pallas.py:210)
  K2 msm_merge   (replaces _merge_kernel,  msm_pallas.py:288)
  K3 msm_wsum    (replaces _wsum_kernel,   msm_pallas.py:358; a warp's
                  lanes scan and sum a job's slots, 8 dependent adds at
                  S = 15 where the serial suffix sum chains 30)

and the bases come out of

  K4 to_affine   (replaces batch_inv_mont_lm + mont_mul_lm as composed by
                  scaled_affine_device, msm_pallas.py:156-170; Montgomery's
                  batch inversion, one Fermat chain per block of
                  AFFINE_BLOCK points, where the TPU inverted every point)

The bucket-design path (tools/msm_designs.py) adds three alternatives to
K1, each followed by K2 and K3 over its own slot count S:

  msm_chain          (replaces pure_chain_call, tools/exp_bucket2.py:30, and
                      pure_call, tools/profile_msm_phases.py:139; each lane
                      H sub-chains on H threads, joined by a shuffle tree)
  msm_bucket_tsplit  (replaces bucket_tsplit_call, tools/exp_tsplit.py:37)
  msm_bucket_signed  (replaces bucket_signed_call,
                      tools/exp_signed_msm.py:65)

The last two run K1's sorted walk (csrc/msm.cuh: bucket_walk) over a step
range of each lane and over signed digits.

Bases that are not a key's (Spartan's matrix tables are points of their
own) come through msm_var, with the kernel of csrc/points.cu:

  K5 scale16  (replaces the reference's scale_points16, ops/msm.py:62: the
               windows 16^w P of projective points, one thread a point,
               Jacobian doublings between stored windows; scale_points16,
               the key preparation, goes through it too)

then K4 to_affine and K1-K3; a base at the identity gets the scalar 0.

The kernels are CUDA C++ in csrc/msm.cu, csrc/msm_designs.cu and
csrc/points.cu (what bounds each and how it is laid out is noted there).
Beside each wrapper is its plain torch version, the same per-lane
algorithm in the same order, so the two agree bit for bit in projective
form, and a launch count. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises.

What bounds the two kernels of the chain that do the work, and what their
design does about it:
  * K1 is bound by the latency of each lane's dependent mixed adds, and a
    warp lasts as long as its busiest lane. It sorts each lane's nonzero
    steps by digit and walks them with one accumulator in registers, so a
    warp runs as many adds as its busiest lane has nonzero digits. The
    lanes of a warp then stand at different steps, so it reads a
    lane-major copy of the bases (lane_major; the key keeps one) and
    stores its buckets in one pass at the end. Its output equals
    msm_bucket_plain's, which adds every bucket's bases in step order all
    the same.
  * K2 is bound by the latency of the dependent complete adds of its
    trees. It gives each (job, slot) merge_group(J, S, n_lanes) threads so
    that the card holds about MERGE_TARGET_THREADS in all, skips every add
    with the identity on one side (most buckets of the prover's W commits
    are empty), reduces with warp shuffles, and where a slot spans several
    blocks the last of them sums their partials in index order.
    msm_merge_plain follows that order and those skips.
  * K3 is bound by the latency of its dependent complete adds. A job's S
    slots sit on G = wsum_group(S) lanes of a warp: a suffix scan over
    log2 G shuffle levels, then a halving tree over log2 G more, with the
    same identity skips; msm_wsum_plain follows that order.
  * K4 is bound, after the batch trick, by the latency of one Fermat
    chain a block (all blocks run theirs at once). Its output is the
    field's unique inverse times X and Y, so it equals the Fermat form of
    to_affine_words_plain bit for bit.

Kernel layouts (int32 tensors holding u32 words):
  digits  (J, B, n_lanes)         bases   (B, 2, 8, n_lanes)
  bases_lm (n_lanes, B, 2, 8): the lane-major copy (lane_major) that K1,
           the t-split and the signed kernel read
  buckets (J, S, 3, 8, n_lanes)   reduced (J, S, 3, 8)      sums (J, 3, 8)
with S = 15 slots for K1 and the t-split (whose H sets sit on the lane
axis, H * n_lanes lanes), 8 for the signed digits and 1 for the chain.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import curve as C
from . import field as F
from .cuda_lib import check_input as _check_input, launch as _launch, \
    launches, lib, on_cuda as _on_cuda, ptr as _ptr, \
    reset_launches  # noqa: F401 (launches, reset_launches: callers read them here)

RADIX_BITS = 4
NBUCKET = 15          # digit values 1..15; digit 0 is skipped
NSIGNED = 8           # signed-digit magnitudes 1..8 (csrc/msm_designs.cuh)
NW = 8                # u32 words per field element
# Launch constants of K1 and K2, twins of csrc/msm.cuh's (a test holds
# them equal).
BUCKET_LANES = 128          # lanes (threads) per K1 block
BUCKET_MAX_STEPS = 64       # the largest B K1 takes
MERGE_THREADS = 128         # threads per K2 block
MERGE_TARGET_THREADS = 132 * 512   # K2 threads per launch: 512 per H100 SM
WSUM_THREADS = 128          # threads per K3 block
WSUM_MAX_SLOTS = 32         # K3: a job's slots fit one warp
AFFINE_THREADS = 256        # K4: threads per block, points per thread and
AFFINE_PER_THREAD = 16      # points per block (one Fermat chain each)
AFFINE_BLOCK = AFFINE_THREADS * AFFINE_PER_THREAD
# msm_chain: the threads that chain_split fills the card with, 8 warps an
# SM of an H100's 132, where the lean add's SM cycles a warp-step stop
# falling (3,715 at 8 warps, 3,671 at 16, 3,643 at 32; tools/add_cost.py
# on an H100), and the most sub-chains a lane.
CHAIN_TARGET_THREADS = 132 * 256
CHAIN_MAX_SPLIT = 32        # a lane's sub-chains stay in one warp

# ---------------------------------------------------------------------------
# Plan, digits and base layout.
# ---------------------------------------------------------------------------


def n_windows4(max_bits: int) -> int:
    return (max_bits + RADIX_BITS - 1) // RADIX_BITS


def plan(m: int, max_bits: int,
         b: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(B, lanes_per_window, windows, n_lanes) for an m-point MSM.

    B points per lane: 64 keeps the merge at a quarter of the bucket work
    and gives the comm_T MSM 16k lanes (threads); small m shrinks B so each
    window still has >= 16 lanes. A given b is taken as it is (the designs
    tool times other B)."""
    w4 = n_windows4(max_bits)
    if b is None:
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
    return _lanes_tm(digits4(scalars, w4), m, b, lpw, w4)


def _lanes_tm(d: torch.Tensor, m: int, b: int, lpw: int,
              w4: int) -> torch.Tensor:
    """(J, W4, m) per-window digits -> the (J, B, n_lanes) kernel layout."""
    J = d.shape[0]
    pad = lpw * b - m
    if pad:
        d = torch.nn.functional.pad(d, (0, pad))
    d = d.reshape(J, w4, lpw, b).permute(0, 3, 1, 2)
    return d.reshape(J, b, w4 * lpw).to(torch.int32).contiguous()


def bases_tm(xa: torch.Tensor, ya: torch.Tensor, m: int, max_bits: int,
             b: Optional[int] = None) -> torch.Tensor:
    """Affine Montgomery (W4', m, 32) digit arrays (W4' >= the plan's
    windows) -> (B, 2, 8, n_lanes) kernel layout of plan(m, max_bits, b).
    Padding points are zero; their digits are always 0, so no kernel ever
    reads them."""
    w4 = n_windows4(max_bits)
    return _bases_tm_words(F.digits_to_words(xa[:w4, :m]),
                           F.digits_to_words(ya[:w4, :m]), m, max_bits, b)


def _bases_tm_words(xw: torch.Tensor, yw: torch.Tensor, m: int,
                    max_bits: int, b: Optional[int] = None) -> torch.Tensor:
    """bases_tm on affine (W4', m, 8) words."""
    b, lpw, w4, n_lanes = plan(m, max_bits, b)

    def one(a):
        w = a[:w4, :m]                                     # (W4, m, 8)
        pad = lpw * b - m
        if pad:
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        return w.reshape(w4, lpw, b, NW).permute(2, 3, 0, 1).reshape(
            b, NW, n_lanes)

    return torch.stack([one(xw), one(yw)], dim=1).contiguous()


def lane_major(bases: torch.Tensor) -> torch.Tensor:
    """(B, 2, 8, n_lanes) bases -> K1's lane-major copy (n_lanes, B, 2, 8):
    a lane's B points contiguous, 64 bytes each."""
    return bases.permute(3, 0, 1, 2).contiguous()


_CONSTS: Dict[Tuple[str, bool], ctypes.Array] = {}


def consts_words(spec: C.CurveSpec) -> np.ndarray:
    """The csrc `Consts` pack: p, one (R mod p), p - 2, 3b (Montgomery),
    -p^-1 mod 2^32, as 33 little-endian u32 words."""
    f = spec.base
    words = lambda v: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(NW)]
    return np.asarray(words(f.p) + words(f.r_mod_p) + words(f.p - 2)
                      + words(f.to_mont_int(3 * spec.b))
                      + [(-pow(f.p, -1, 1 << 32)) % (1 << 32)], np.uint32)


def _consts_arg(spec: C.CurveSpec, lean: bool = False) -> ctypes.Array:
    key = (spec.name, lean)
    if key not in _CONSTS:
        w = lean_consts_words(spec) if lean else consts_words(spec)
        _CONSTS[key] = (ctypes.c_uint32 * len(w))(*w.tolist())
    return _CONSTS[key]


def b3_small(spec: C.CurveSpec) -> int:
    """3b as a signed integer of least magnitude: 15 on Pallas and Vesta,
    9 on BN254, -51 on Grumpkin (its b is -17)."""
    k = 3 * spec.b % spec.base.p
    return k - spec.base.p if k > spec.base.p // 2 else k


def lean_consts_words(spec: C.CurveSpec) -> np.ndarray:
    """The csrc `LeanConsts` pack (field_lean.cuh): consts_words, then 3b
    as a small signed integer (two's complement), which the lean field
    backend multiplies by with modular additions."""
    return np.concatenate([consts_words(spec), np.asarray(
        [b3_small(spec) % (1 << 32)], np.uint32)])


def _proj_words(pt) -> torch.Tensor:
    """h16 projective tuple with coordinates (..., 16) -> (..., 3, 8)
    words."""
    return torch.stack([F.h16_to_words(c) for c in pt], dim=-2)


# ---------------------------------------------------------------------------
# K1: bucket accumulation.
# ---------------------------------------------------------------------------


def _buckets_plain(spec: C.CurveSpec, digits: torch.Tensor,
                   bases: torch.Tensor, nslots: int,
                   signed: bool) -> torch.Tensor:
    """All (job, lane) pairs step through their B bases together; each
    gathers the bucket its digit's magnitude picks (1..nslots; 0 skips),
    mixed-adds the base (y negated where a signed digit's bit 4 is set),
    and scatters it back. -> (J, nslots, 3, 8, L)."""
    J, B, L = digits.shape
    bx = F.words_to_h16(bases[:, 0].transpose(1, 2))       # (B, L, 16)
    by = F.words_to_h16(bases[:, 1].transpose(1, 2))
    bk = C.h_identity(spec, (J, L, nslots), digits.device)
    for t in range(B):
        e = digits[:, t, :].to(torch.int64)                # (J, L)
        d = e & 15 if signed else e
        live = (d > 0) & (d <= nslots)
        if not bool(live.any()):
            continue
        idx = (d - 1).clamp(0, nslots - 1)[..., None, None].expand(
            J, L, 1, F.N_H16)
        cur = tuple(c.gather(2, idx).squeeze(2) for c in bk)
        y = by[t][None]
        if signed:
            y = torch.where(((e >> 4) & 1).bool()[..., None],
                            F.h_neg(spec.base, y), y)
        new = C.h_pt_add_mixed(spec, cur, (bx[t][None], y))
        new = C.h_pt_select(live, new, cur)
        for c, n in zip(bk, new):
            c.scatter_(2, idx, n[:, :, None, :])
    # (J, L, S, 16) x3 -> (J, S, 3, 8, L)
    return _proj_words(bk).permute(0, 2, 3, 4, 1).contiguous()


def msm_bucket_plain(spec: C.CurveSpec, digits: torch.Tensor,
                     bases: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1 (15 buckets per lane)."""
    return _buckets_plain(spec, digits, bases, NBUCKET, signed=False)


def _walk_inputs(name: str, digits: torch.Tensor,
                 bases: torch.Tensor) -> Tuple[int, int, int]:
    """Check a walk kernel's (J, B, n_lanes) digits and (B, 2, 8, n_lanes)
    bases, B <= BUCKET_MAX_STEPS; -> (J, B, n_lanes)."""
    J, B, L = digits.shape
    _check_input(f"{name} digits", digits, (J, B, L))
    _check_input(f"{name} bases", bases, (B, 2, NW, L))
    if B > BUCKET_MAX_STEPS:
        raise ValueError(f"{name}: B = {B} > {BUCKET_MAX_STEPS} steps")
    return J, B, L


def _walk_bases_lm(name: str, digits: torch.Tensor, bases: torch.Tensor,
                   bases_lm: Optional[torch.Tensor]) -> torch.Tensor:
    """The lane-major copy a walk kernel reads: bases_lm, checked, or
    lane_major(bases) made here."""
    _, B, L = digits.shape
    lm = lane_major(bases) if bases_lm is None else bases_lm
    _check_input(f"{name} bases_lm", lm, (L, B, 2, NW))
    _on_cuda(name, digits, lm)
    return lm


def msm_bucket(spec: C.CurveSpec, digits: torch.Tensor, bases: torch.Tensor,
               bases_lm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: (J, B, n_lanes) digits x (B, 2, 8, n_lanes) bases -> per-lane
    buckets (J, 15, 3, 8, n_lanes); B <= BUCKET_MAX_STEPS. The kernel
    reads bases_lm = lane_major(bases), made here if not given."""
    J, B, L = _walk_inputs("msm_bucket", digits, bases)
    if not _on_cuda("msm_bucket", digits, bases):
        return msm_bucket_plain(spec, digits, bases)
    lm = _walk_bases_lm("msm_bucket", digits, bases, bases_lm)
    out = torch.empty((J, NBUCKET, 3, NW, L), dtype=torch.int32,
                      device=digits.device)
    if J * L:
        _launch("msm_bucket", lib().hp_msm_bucket, _consts_arg(spec),
                _ptr(digits), _ptr(lm), _ptr(out), J, B, L,
                device=digits.device)
    return out


# ---------------------------------------------------------------------------
# K2: lane merge.
# ---------------------------------------------------------------------------


def merge_group(J: int, S: int, n_lanes: int) -> int:
    """K2's threads per (job, slot), G, as csrc/msm.cuh computes it: the
    largest power of two >= 32 with J * S * G <= MERGE_TARGET_THREADS,
    capped at the lanes rounded up to a power of two and at
    MERGE_THREADS^2. Above MERGE_THREADS a slot spans G / MERGE_THREADS
    blocks."""
    want = MERGE_TARGET_THREADS // (J * S) if J * S else 0
    g = 32
    while g * 2 <= want:
        g *= 2
    cap = 32
    while cap < n_lanes:
        cap *= 2
    return min(g, cap, MERGE_THREADS * MERGE_THREADS)


def _acc_add(spec: C.CurveSpec, acc, q):
    """csrc acc_add as selects: q with Z = 0 leaves acc, acc with Z = 0
    takes q, else the complete add (computed only where it is taken)."""
    q_id = (q[2] == 0).all(-1)
    acc_id = (acc[2] == 0).all(-1)
    out = C.h_pt_select(q_id, acc, C.h_pt_select(acc_id, q, acc))
    idx = (~q_id & ~acc_id).nonzero(as_tuple=True)
    if idx[0].numel():
        new = C.h_pt_add(spec, tuple(a[idx] for a in acc),
                         tuple(b[idx] for b in q))
        for o, n in zip(out, new):
            o[idx] = n
    return out


def _halve(spec: C.CurveSpec, acc):
    """Halving tree over axis -2 (a power of two): entry i < n/2 takes
    entry i + n/2 until one is left. -> axis -2 dropped."""
    n = acc[0].shape[-2]
    while n > 1:
        n //= 2
        acc = _acc_add(spec, tuple(a[..., :n, :] for a in acc),
                       tuple(a[..., n:2 * n, :] for a in acc))
    return tuple(a[..., 0, :] for a in acc)


def _group_sum(spec: C.CurveSpec, acc):
    """K2's group tree over (..., n, 16) accumulators, n = 32 * nw: halving
    within each warp of 32, then over the nw warp sums."""
    lanes = tuple(a.reshape(*a.shape[:-2], -1, 32, a.shape[-1])
                  for a in acc)
    return _halve(spec, _halve(spec, lanes))


def msm_merge_plain(spec: C.CurveSpec, buckets: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K2, in the kernel's order: thread g of the G
    = merge_group(J, S, L) of a (job, slot) sums lanes g, g + G, ...; the
    G sums take the group tree, or, for G > MERGE_THREADS, each block's
    MERGE_THREADS do and the P block sums, padded with the identity to
    MERGE_THREADS, take it once more. Every add skips the identity on
    either side."""
    J, S, _, _, L = buckets.shape
    G = merge_group(J, S, L)
    pts = tuple(F.words_to_h16(buckets[:, :, c].transpose(2, 3))
                for c in range(3))                         # (J, S, L, 16)
    acc = C.h_identity(spec, (J, S, G), buckets.device)
    for lo in range(0, L, G):
        w = min(G, L - lo)
        new = _acc_add(spec, tuple(a[:, :, :w] for a in acc),
                       tuple(p[:, :, lo:lo + w] for p in pts))
        acc = tuple(torch.cat([n, a[:, :, w:]], dim=2)
                    for n, a in zip(new, acc))
    if G > MERGE_THREADS:
        P = G // MERGE_THREADS
        part = _group_sum(spec, tuple(
            a.reshape(J, S, P, MERGE_THREADS, -1) for a in acc))
        pad = C.h_identity(spec, (J, S, MERGE_THREADS - P), buckets.device)
        acc = tuple(torch.cat([a, b], dim=2) for a, b in zip(part, pad))
    return _proj_words(_group_sum(spec, acc)).contiguous()


def msm_merge(spec: C.CurveSpec, buckets: torch.Tensor) -> torch.Tensor:
    """K2: buckets (J, S, 3, 8, n_lanes) -> reduced (J, S, 3, 8); S is read
    from the shape (15 for msm_bucket, 8 for the signed digits)."""
    if buckets.dim() != 5:
        raise ValueError(f"msm_merge: want (J, S, 3, {NW}, n_lanes), got "
                         f"{tuple(buckets.shape)}")
    J, S, _, _, L = buckets.shape
    _check_input("msm_merge buckets", buckets, (J, S, 3, NW, L))
    if not _on_cuda("msm_merge", buckets):
        return msm_merge_plain(spec, buckets)
    dev = buckets.device
    out = torch.empty((J, S, 3, NW), dtype=torch.int32, device=dev)
    if J * S:
        P = merge_group(J, S, L) // MERGE_THREADS
        partials = torch.empty((J, S, P, 3, NW) if P > 1 else (1,),
                               dtype=torch.int32, device=dev)
        tickets = torch.zeros((J * S if P > 1 else 1,), dtype=torch.int32,
                              device=dev)
        _launch("msm_merge", lib().hp_msm_merge, _consts_arg(spec),
                _ptr(buckets), _ptr(out), _ptr(partials), _ptr(tickets), J,
                S, L, device=dev)
    return out


# ---------------------------------------------------------------------------
# K3: weighted bucket sum.
# ---------------------------------------------------------------------------


def wsum_group(S: int) -> int:
    """K3's lanes per job, G, as csrc/msm.cuh computes it: the least power
    of two >= S (16 at S = 15, 8 at S = 8)."""
    g = 1
    while g < S:
        g *= 2
    return g


def wsum_depth(S: int) -> int:
    """K3's critical path in dependent complete adds: log2 G levels of the
    suffix scan and log2 G of the tree (the serial suffix sum: 2S)."""
    return 2 * (wsum_group(S).bit_length() - 1)


def msm_wsum_plain(spec: C.CurveSpec, reduced: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K3, in the kernel's order: slot v - 1 of each
    job on lane v - 1 of G = wsum_group(S), the identity on lanes >= S;
    an inclusive suffix scan (at offset 1, 2, ..., G / 2 lane v takes lane
    v + off where that is < G), then the halving tree. Every add skips the
    identity on either side."""
    J, S = reduced.shape[:2]
    G = wsum_group(S)
    pts = tuple(F.words_to_h16(reduced[:, :, c]) for c in range(3))
    pad = C.h_identity(spec, (J, G - S), reduced.device)
    acc = tuple(torch.cat([p, i], dim=1) for p, i in zip(pts, pad))
    off = 1
    while off < G:
        new = _acc_add(spec, tuple(a[:, :G - off] for a in acc),
                       tuple(a[:, off:] for a in acc))
        acc = tuple(torch.cat([n, a[:, G - off:]], dim=1)
                    for n, a in zip(new, acc))
        off *= 2
    return _proj_words(_halve(spec, acc)).contiguous()


def msm_wsum(spec: C.CurveSpec, reduced: torch.Tensor) -> torch.Tensor:
    """K3: reduced (J, S, 3, 8) -> sum_{v=1..S} v * B_v as (J, 3, 8);
    S <= WSUM_MAX_SLOTS."""
    if reduced.dim() != 4:
        raise ValueError(f"msm_wsum: want (J, S, 3, {NW}), got "
                         f"{tuple(reduced.shape)}")
    J, S = reduced.shape[:2]
    _check_input("msm_wsum reduced", reduced, (J, S, 3, NW))
    if S > WSUM_MAX_SLOTS:
        raise ValueError(f"msm_wsum: S = {S} > {WSUM_MAX_SLOTS} slots")
    if not _on_cuda("msm_wsum", reduced):
        return msm_wsum_plain(spec, reduced)
    out = torch.empty((J, 3, NW), dtype=torch.int32, device=reduced.device)
    if J:
        _launch("msm_wsum", lib().hp_msm_wsum, _consts_arg(spec),
                _ptr(reduced), _ptr(out), J, S, device=reduced.device)
    return out


# ---------------------------------------------------------------------------
# K4: projective -> affine (key preparation).
# ---------------------------------------------------------------------------


def to_affine_words_plain(spec: C.CurveSpec, X, Y, Z):
    """Plain torch version of K4 on (N, 8) words: Fermat z^-1 (0 -> 0),
    then x * z^-1 and y * z^-1. The kernel's batch inversion reaches the
    same unique inverse, so the two agree bit for bit."""
    f = spec.base
    zinv = F.h_inv(f, F.words_to_h16(Z))
    return (F.h16_to_words(F.h_mont_mul(f, F.words_to_h16(X), zinv)),
            F.h16_to_words(F.h_mont_mul(f, F.words_to_h16(Y), zinv)))


def to_affine_words(spec: C.CurveSpec, X: torch.Tensor, Y: torch.Tensor,
                    Z: torch.Tensor):
    """K4 on (N, 8) Montgomery words -> affine (x, y) (N, 8) words (one
    launch; the kernel keeps its running products in x meanwhile)."""
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
             m: int, max_bits: int, b: Optional[int] = None,
             bases_lm: Optional[torch.Tensor] = None) -> C.Point:
    """J MSMs over one shared base array through K1 -> K2 -> K3.

    scalars: (J, m, 32) canonical digits, each < 2^max_bits; bases: the
    (B, 2, 8, n_lanes) layout of bases_tm(m, max_bits, b), and bases_lm
    its lane_major copy if the caller keeps one. Returns projective
    Montgomery (J, 32) x3."""
    b, lpw, w4, _ = plan(m, max_bits, b)
    d = digits_tm(scalars, m, b, lpw, w4)
    s = msm_wsum(spec, msm_merge(spec, msm_bucket(spec, d, bases, bases_lm)))
    dig = F.words_to_digits(s)                             # (J, 3, 32)
    return (dig[:, 0], dig[:, 1], dig[:, 2])


def scale_points16(spec: C.CurveSpec, points: C.Point,
                   windows: int) -> C.Point:
    """(m, 32) x3 projective Montgomery points -> (W4, m, 32) x3 holding
    16^w * P (through scale16)."""
    s = scale16(spec, point_words(points), windows)
    return tuple(F.words_to_digits(s[:, :, c]) for c in range(3))


# ---------------------------------------------------------------------------
# Variable bases (csrc/points.cu): scale16, and the MSM over projective
# points that are not the key's (nova/spartan.py's preprocessed tables).
# ---------------------------------------------------------------------------


def point_words(points: C.Point) -> torch.Tensor:
    """(n, 32) x3 projective Montgomery digits -> (n, 3, 8) words."""
    return torch.stack([F.digits_to_words(c) for c in points],
                       dim=-2).contiguous()


def words_point(w: torch.Tensor) -> C.Point:
    """(..., 3, 8) words -> (..., 32) x3 projective Montgomery digits."""
    return tuple(F.words_to_digits(w[..., c, :]) for c in range(3))


def _jac_double(spec: C.CurveSpec, X, Y, Z):
    """dbl-2009-l (a = 0) on h16 Jacobian coordinates, as csrc/points.cuh:
    jac_double: A = X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C), E = 3A,
    X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ."""
    f = spec.base
    mul = lambda a, b: F.h_mont_mul(f, a, b)
    add = lambda a, b: F.h_add(f, a, b)
    sub = lambda a, b: F.h_sub(f, a, b)
    m = mul(torch.stack([X, Y, Y]), torch.stack([X, Y, Z]))
    A, B, YZ = m[0], m[1], m[2]
    XB = add(X, B)
    E = add(add(A, A), A)
    m = mul(torch.stack([B, XB, E]), torch.stack([B, XB, E]))
    Cc, S, Fe = m[0], m[1], m[2]
    D = sub(sub(S, A), Cc)
    D = add(D, D)
    X3 = sub(Fe, add(D, D))
    C8 = add(Cc, Cc)
    C8 = add(C8, C8)
    C8 = add(C8, C8)
    Y3 = sub(mul(E, sub(D, X3)), C8)
    return X3, Y3, add(YZ, YZ)


def scale16_plain(spec: C.CurveSpec, pts: torch.Tensor,
                  windows: int) -> torch.Tensor:
    """Plain torch version of scale16, in the kernel's formulas: the point
    enters Jacobian form once, (XZ, YZ^2, Z); 4 Jacobian doublings a
    window; each window stored as (XZ, Y, Z^3), and as (0 : 1 : 0) where
    Z = 0. All values are canonical, so the words equal the kernel's."""
    f = spec.base
    mul = lambda a, b: F.h_mont_mul(f, a, b)
    X, Y, Z = (F.words_to_h16(pts[:, c]) for c in range(3))
    z2 = mul(Z, Z)
    X, Y = mul(X, Z), mul(Y, z2)
    one = torch.tensor(F.int_to_h16(f.r_mod_p), dtype=Z.dtype,
                       device=Z.device).expand_as(Z)
    out = []
    for w in range(windows):
        z2 = mul(Z, Z)
        inf = (Z == 0).all(-1, keepdim=True)
        out.append(_proj_words((mul(X, Z), torch.where(inf, one, Y),
                                mul(z2, Z))))
        if w + 1 < windows:
            for _ in range(RADIX_BITS):
                X, Y, Z = _jac_double(spec, X, Y, Z)
    return torch.stack(out)


def scale16(spec: C.CurveSpec, pts: torch.Tensor,
            windows: int) -> torch.Tensor:
    """(n, 3, 8) projective Montgomery words -> (W4, n, 3, 8) holding
    16^w * P_i at [w, i], W4 = windows (one thread a point, csrc/points.cu:
    Jacobian doublings on the lean field backend). The identity stays the
    identity, (0 : 1 : 0)."""
    n = pts.shape[0]
    _check_input("scale16 points", pts, (n, 3, NW))
    if not _on_cuda("scale16", pts):
        return scale16_plain(spec, pts, windows)
    out = torch.empty((windows, n, 3, NW), dtype=torch.int32,
                      device=pts.device)
    if n and windows:
        _launch("scale16", lib().hp_scale16, _consts_arg(spec, True),
                _ptr(pts), _ptr(out), n, windows, device=pts.device)
    return out


def var_bases(spec: C.CurveSpec, pts: torch.Tensor, max_bits: int):
    """MSM bases of plan(m, max_bits) for (m, 3, 8) projective words:
    scale16, to_affine on words, bases_tm. -> (bases, live): live (m,) is
    False where a point is the identity (Z = 0); its affine base comes out
    (0, 0), and msm_var gives it the scalar 0, as bases_tm's padding, so
    no mixed add ever reads it."""
    m = pts.shape[0]
    w4 = n_windows4(max_bits)
    s = scale16(spec, pts, w4)
    xa, ya = to_affine_words(spec, *(s[:, :, c].reshape(-1, NW).contiguous()
                                     for c in range(3)))
    live = (pts[:, 2] != 0).any(-1)
    return (_bases_tm_words(xa.reshape(w4, m, NW), ya.reshape(w4, m, NW),
                            m, max_bits), live)


def msm_var(spec: C.CurveSpec, scalars: torch.Tensor, kept,
            max_bits: int) -> C.Point:
    """J MSMs over points that are not the key's: (J, m, 32) canonical
    scalars over kept = var_bases(spec, points, max_bits) -> projective
    Montgomery (J, 32) x3. An identity point gets the scalar 0."""
    bases, live = kept
    sc = scalars * live[None, :, None].to(scalars.dtype)
    return msm_many(spec, sc, bases, live.shape[0], max_bits)


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


# ---------------------------------------------------------------------------
# Bucket designs (tools/msm_designs.py): alternatives to K1, each followed
# by K2 and K3 over its own slot count. Kernels in csrc/msm_designs.cu.
# ---------------------------------------------------------------------------


def chain_split(J: int, n_lanes: int, B: int) -> int:
    """msm_chain's H for J jobs of n_lanes lanes of B steps: the largest
    power of two up to CHAIN_MAX_SPLIT that divides B and keeps J *
    n_lanes * H threads within CHAIN_TARGET_THREADS; 1 where one thread a
    lane fills that already."""
    H = 1
    while (2 * H <= CHAIN_MAX_SPLIT and B % (2 * H) == 0
           and J * n_lanes * 2 * H <= CHAIN_TARGET_THREADS):
        H *= 2
    return H


def _chain_h(name: str, J: int, n_lanes: int, B: int,
             H: Optional[int]) -> int:
    H = chain_split(J, n_lanes, B) if H is None else H
    if H < 1 or H > CHAIN_MAX_SPLIT or H & (H - 1) or B % H:
        raise ValueError(f"{name}: H = {H} must be a power of two up to "
                         f"{CHAIN_MAX_SPLIT} that divides B = {B}")
    return H


def msm_chain_plain(spec: C.CurveSpec, bases: torch.Tensor, J: int,
                    H: Optional[int] = None) -> torch.Tensor:
    """Plain torch version of msm_chain, in the kernel's order: sub-chain h
    of lane l mixed-adds its B / H bases in order from the identity, all
    (h, l) a step at once; then the halving tree, h < off taking h + off
    (acc_add) for off = H/2, ..., 1. No digit is read, so the J jobs hold
    the same lane sums: computed once and repeated."""
    B, _, _, L = bases.shape
    H = _chain_h("msm_chain", J, L, B, H)
    steps = B // H
    part = lambda c: F.words_to_h16(c.transpose(1, 2)).reshape(
        H, steps, L, -1).transpose(0, 1).reshape(steps, H * L, -1)
    bx, by = part(bases[:, 0]), part(bases[:, 1])      # (steps, H L, 16)
    acc = C.h_identity(spec, (H * L,), bases.device)
    for t in range(steps):
        acc = C.h_pt_add_mixed(spec, acc, (bx[t], by[t]))
    parts = [tuple(c[h * L:(h + 1) * L] for c in acc) for h in range(H)]
    off = H // 2
    while off:
        for h in range(off):
            parts[h] = _acc_add(spec, parts[h], parts[h + off])
        off //= 2
    out = _proj_words(parts[0]).permute(1, 2, 0)           # (3, 8, L)
    return out[None].expand(J, 3, NW, L).contiguous()


def msm_chain(spec: C.CurveSpec, bases: torch.Tensor, J: int,
              H: Optional[int] = None) -> torch.Tensor:
    """The bucket kernel's add chain without buckets: (B, 2, 8, n_lanes)
    bases -> (J, 3, 8, n_lanes), lane l of every job = the sum of its B
    bases (padding points included), chained as H sub-chains of B / H
    adds on H threads and joined (H = chain_split(J, n_lanes, B) if not
    given; H = 1 is msm_bucket's thread map). Wrong as an MSM by design: a
    ceiling for msm_bucket at the same thread count."""
    B, _, _, L = bases.shape
    _check_input("msm_chain bases", bases, (B, 2, NW, L))
    H = _chain_h("msm_chain", J, L, B, H)
    if not _on_cuda("msm_chain", bases):
        return msm_chain_plain(spec, bases, J, H)
    out = torch.empty((J, 3, NW, L), dtype=torch.int32, device=bases.device)
    if J * L:
        _launch("msm_chain", lib().hp_msm_chain, _consts_arg(spec, True),
                _ptr(bases), _ptr(out), J, B, L, H, device=bases.device)
    return out


def tsplit_layout(digits: torch.Tensor, bases: torch.Tensor, H: int):
    """The t-split as a lane layout: lane h * n_lanes + l of the result
    holds steps [h B/H, (h+1) B/H) of lane l. -> digits (J, B/H, H n_lanes)
    and bases (B/H, 2, 8, H n_lanes)."""
    J, B, L = digits.shape
    d = digits.reshape(J, H, B // H, L).permute(0, 2, 1, 3)
    b = bases.reshape(H, B // H, 2, NW, L).permute(1, 2, 3, 0, 4)
    return (d.reshape(J, B // H, H * L).contiguous(),
            b.reshape(B // H, 2, NW, H * L).contiguous())


def msm_bucket_tsplit_plain(spec: C.CurveSpec, digits: torch.Tensor,
                            bases: torch.Tensor, H: int) -> torch.Tensor:
    """Plain torch version of msm_bucket_tsplit: K1's plain version over
    the t-split lane layout (each set sees its steps in the kernel's
    order)."""
    return msm_bucket_plain(spec, *tsplit_layout(digits, bases, H))


def msm_bucket_tsplit(spec: C.CurveSpec, digits: torch.Tensor,
                      bases: torch.Tensor, H: int,
                      bases_lm: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K1 with H bucket sets per lane over disjoint step ranges: (J, B,
    n_lanes) digits x (B, 2, 8, n_lanes) bases -> (J, 15, 3, 8, H n_lanes),
    set h of lane l at lane h * n_lanes + l (K2 sums it like any lane);
    B <= BUCKET_MAX_STEPS. The kernel runs K1's sorted walk over each
    set's steps and reads bases_lm = lane_major(bases), made here if not
    given."""
    J, B, L = _walk_inputs("msm_bucket_tsplit", digits, bases)
    if H < 1 or B % H:
        raise ValueError(f"msm_bucket_tsplit: H = {H} must divide B = {B}")
    if not _on_cuda("msm_bucket_tsplit", digits, bases):
        return msm_bucket_tsplit_plain(spec, digits, bases, H)
    lm = _walk_bases_lm("msm_bucket_tsplit", digits, bases, bases_lm)
    out = torch.empty((J, NBUCKET, 3, NW, H * L), dtype=torch.int32,
                      device=digits.device)
    if J * L:
        _launch("msm_bucket_tsplit", lib().hp_msm_bucket_tsplit,
                _consts_arg(spec), _ptr(digits), _ptr(lm), _ptr(out), J, B,
                L, H, device=digits.device)
    return out


def signed_bits(max_bits: int) -> int:
    """Bit width whose windows hold a signed recode of scalars < 2^max_bits
    (canonical, so < 2^255): the top window's digit must be <= 7 before
    the carry, so a width that fills its top window gets one more window
    (40 -> 44); 256-bit scalars already leave room."""
    return min(RADIX_BITS * n_windows4(max_bits + 1), 256)


def signed_digits_tm(scalars: torch.Tensor, m: int, b: int, lpw: int,
                     w4: int) -> torch.Tensor:
    """(J, m, 32) canonical scalars -> (J, B, n_lanes) signed radix-16
    digits mag | (neg << 4), mag in 0..8, sum_w 16^w (-1)^neg mag equal to
    the scalar: the carry scan of the TPU experiment's signed_recode
    (tools/exp_signed_msm.py:39), in digits_tm's layout. w4 windows must
    absorb the last carry (see signed_bits)."""
    d = digits4(scalars, w4).to(torch.int64)               # (J, W4, m)
    carry = torch.zeros_like(d[:, 0])
    enc = []
    for w in range(w4):
        dp = d[:, w] + carry
        carry = (dp >= 9).to(torch.int64)
        enc.append(torch.where(carry.bool(), 16 - dp, dp) | (carry << 4))
    if bool(carry.any()):
        raise ValueError(f"signed_digits_tm: {w4} windows leave a carry; "
                         "use plan(m, signed_bits(max_bits))")
    return _lanes_tm(torch.stack(enc, dim=1), m, b, lpw, w4)


def msm_bucket_signed_plain(spec: C.CurveSpec, digits: torch.Tensor,
                            bases: torch.Tensor) -> torch.Tensor:
    """Plain torch version of msm_bucket_signed (8 buckets per lane)."""
    return _buckets_plain(spec, digits, bases, NSIGNED, signed=True)


def msm_bucket_signed(spec: C.CurveSpec, digits: torch.Tensor,
                      bases: torch.Tensor,
                      bases_lm: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K1 on signed digits: (J, B, n_lanes) signed_digits_tm x (B, 2, 8,
    n_lanes) bases -> (J, 8, 3, 8, n_lanes) buckets for magnitudes 1..8;
    B <= BUCKET_MAX_STEPS. The kernel runs K1's sorted walk keyed on the
    magnitude and reads bases_lm = lane_major(bases), made here if not
    given."""
    J, B, L = _walk_inputs("msm_bucket_signed", digits, bases)
    if not _on_cuda("msm_bucket_signed", digits, bases):
        return msm_bucket_signed_plain(spec, digits, bases)
    lm = _walk_bases_lm("msm_bucket_signed", digits, bases, bases_lm)
    out = torch.empty((J, NSIGNED, 3, NW, L), dtype=torch.int32,
                      device=digits.device)
    if J * L:
        _launch("msm_bucket_signed", lib().hp_msm_bucket_signed,
                _consts_arg(spec), _ptr(digits), _ptr(lm), _ptr(out), J,
                B, L, device=digits.device)
    return out
