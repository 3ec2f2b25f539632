"""Carry keys and state from the JAX package into the port.

Each function takes the reference's host arrays (numpy, or anything
np.asarray accepts) and returns the port's tensors on a given device, so a
test can run both packages on identical keys, bases and shapes. Nothing here
imports jax: the reference objects are read only through their attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nova.ivc import IVCProof
from ..nova.pedersen import CommitmentKey
from ..nova.r1cs import ShapeDevice, SparseMat
from ..ops import curve as C
from ..ops import field as F


def tensor(a, device="cpu") -> torch.Tensor:
    """A reference int32 array (digits, or any int array) -> tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).astype(np.int32))).to(device)


def gens_affine(a, device="cpu") -> torch.Tensor:
    """CommitmentKey.gens_affine (n, 2, 32) Montgomery digits -> tensor."""
    a = np.asarray(a)
    assert a.ndim == 3 and a.shape[1:] == (2, F.N_LIMBS), a.shape
    return tensor(a, device)


def commitment_key(ref_ck, device="cpu") -> CommitmentKey:
    """The reference's CommitmentKey -> the port's, same generators."""
    spec = C.CURVES[ref_ck.spec.name]
    return CommitmentKey(spec, int(ref_ck.n),
                         np.asarray(ref_ck.gens_affine, np.int32),
                         ref_ck.label, torch.device(device))


def scaled_bases(xa, ya, device="cpu"):
    """Pre-scaled affine bases (W4, m, 32) x, y (e.g. from the reference's
    scaled_affine_host or scaled_affine_device) -> tensors."""
    return tensor(xa, device), tensor(ya, device)


def shape(ref_shape, device="cpu") -> ShapeDevice:
    """The reference's ShapeDevice (A/B/C as sorted COO) -> the port's,
    with the same numpy arrays (so the pp digests agree)."""
    mats = [SparseMat(*(np.asarray(getattr(m, f)) for f in (
        "rows", "cols", "vals_mont")), int(m.n_cons))
        for m in (ref_shape.A, ref_shape.B, ref_shape.C)]
    return ShapeDevice(F.field_for(ref_shape.field.p), int(ref_shape.n_cons),
                       int(ref_shape.n_vars), int(ref_shape.n_io), *mats,
                       device=device)


def ivc_proof(d: dict) -> IVCProof:
    """An IVCProof dict (the reference's to_dict()) -> the port's proof."""
    return IVCProof.from_dict(d)
