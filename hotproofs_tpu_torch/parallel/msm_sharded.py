"""Sharded MSM and batched witness commitments over a device mesh (port
of hotproofs_tpu/parallel/msm_sharded.py, on torch.distributed:
parallel/mesh.py).

Curve addition is not an arithmetic all-reduce, so the reduction is the
reference's: the D partial projective points are all-gathered (as int32
digits) and every rank adds them in rank order from the identity. D is
small; the cost is one collective.

  * msm_sharded: one large MSM with its points split along the `msm` axis;
    each rank runs the port's msm_many (the MSM kernels) on its
    contiguous slice of the points and scalars.
  * batch_commit_sharded: many independent commitments split along the
    `step` axis, each rank committing its contiguous block of jobs
    (CommitmentKey.commit_many_mesh).
"""

from __future__ import annotations

import torch

from ..nova.pedersen import CommitmentKey
from ..ops import curve as C
from ..ops import msm_pallas as MP
from . import mesh as M


def _slice_bases(ck_or_bases, n: int, m: int, r: int, max_bits: int):
    """(spec, bases, bases_lm) of points [r m, r m + m) of the first n,
    zero past n (their scalars are zero, so no kernel reads them)."""
    w4 = MP.n_windows4(max_bits)
    if isinstance(ck_or_bases, CommitmentKey):
        key = ("shard", n, m, r, w4)
        cached = ck_or_bases._bases.get(key)
        if cached is not None:
            return (ck_or_bases.spec,) + cached
        spec = ck_or_bases.spec
        xa, ya = ck_or_bases.scaled_affine(n, max_bits)
    else:
        spec, xa, ya = ck_or_bases
    a, b = min(r * m, n), min(r * m + m, n)
    pad = lambda t: torch.nn.functional.pad(t[:w4, a:b],
                                            (0, 0, 0, m - (b - a)))
    bases = MP.bases_tm(pad(xa), pad(ya), m, max_bits)
    out = (bases, MP.lane_major(bases))
    if isinstance(ck_or_bases, CommitmentKey):
        ck_or_bases._bases[key] = out
    return (spec,) + out


def msm_sharded(ck_or_bases, mesh, scalars: torch.Tensor,
                max_bits: int = 256, axis: str = "msm") -> C.Point:
    """One MSM (or J of them over the same points) with the N points split
    across the mesh axis.

    ck_or_bases: a CommitmentKey (its first N generators) or (spec, xa, ya)
    with xa, ya the (W4, N, 32) affine Montgomery 16^w-scaled bases
    (CommitmentKey.scaled_affine's form). scalars: (N, 32) or (J, N, 32)
    canonical digits on the mesh's device. N is padded with zero scalars
    to a multiple of the axis size D; rank r takes the contiguous slice
    [r N'/D, (r+1) N'/D). Returns the projective Montgomery point(s),
    (32,) x3 or (J, 32) x3, the same on every rank (compare as affine)."""
    one = scalars.dim() == 2
    sc = scalars[None] if one else scalars
    J, n = sc.shape[0], sc.shape[1]
    D, r = mesh.get_group(axis).size(), mesh.get_local_rank(axis)
    m = -(-n // D)
    spec, bases, lm = _slice_bases(ck_or_bases, n, m, r, max_bits)
    part = sc[:, min(r * m, n):min(r * m + m, n)]
    if part.shape[1] < m:
        part = torch.nn.functional.pad(part, (0, 0, 0, m - part.shape[1]))
    pt = MP.msm_many(spec, part.contiguous(), bases, m, max_bits,
                     bases_lm=lm)
    acc = C.identity(spec, (J,), sc.device)
    for g in M.gather_points(pt, mesh, axis):
        acc = C.pt_add(spec, acc, (g[0], g[1], g[2]))
    return tuple(c[0] for c in acc) if one else acc


def batch_commit_sharded(ck: CommitmentKey, mesh, scalars: torch.Tensor,
                         max_bits: int = 40, axis: str = "step") -> C.Point:
    """Independent commitments of (S, N, 32) canonical scalars, S split in
    contiguous blocks across the mesh axis (S must divide by its size);
    returns all S points, (S, 32) x3 in job order, on every rank."""
    return ck.commit_many_mesh(scalars, mesh, max_bits, axis=axis)
