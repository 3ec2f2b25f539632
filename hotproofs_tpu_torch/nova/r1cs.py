"""R1CS shapes on the device: sparse matrices, SpMV, relaxed satisfaction
(port of hotproofs_tpu/nova/r1cs.py).

`SparseMat` keeps the reference's exact numpy arrays (COO sorted by row,
values in Montgomery digits), because the pp digest hashes their bytes
(nova/ivc.py); `ShapeDevice` adds a copy of each matrix on its device for
the plain torch SpMV: one stacked Montgomery product per nonzero, a lazy
integer row sum (index_add_) and one modular reduction per row.

Column convention (the DSL's): col 0 is the constant-1 / relaxed u slot,
cols 1..n_io the public IO X, then the witness W; z = (u, X, W).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict

import numpy as np
import torch

from ..circuits.dsl import R1CS
from ..ops import field as F


@dataclass(frozen=True)
class SparseMat:
    """COO entries sorted by row (the arrays the pp digest hashes)."""

    rows: np.ndarray        # (nnz,) int32
    cols: np.ndarray        # (nnz,) int32
    vals_mont: np.ndarray   # (nnz, 32) int32, Montgomery form
    n_cons: int


def _mat_from_coo(spec: F.FieldSpec, rows, cols, vals, n_cons) -> SparseMat:
    order = np.argsort(rows, kind="stable")
    # A circuit's coefficients repeat (1, -1, powers of two): convert each
    # distinct value once.
    ints = [int(v) for v in vals[order]]
    mont = {v: spec.to_mont_int(v) for v in set(ints)}
    vals_mont = spec.batch_to_limbs([mont[v] for v in ints])
    return SparseMat(rows[order].astype(np.int32),
                     cols[order].astype(np.int32), vals_mont, n_cons)


@dataclass
class DeviceMat:
    rows: torch.Tensor     # (nnz,) int64
    cols: torch.Tensor     # (nnz,) int64
    vals: torch.Tensor     # (nnz, 16) int64 halves, Montgomery
    n_cons: int

    @staticmethod
    def from_sparse(mat: SparseMat, device) -> "DeviceMat":
        return DeviceMat(
            rows=torch.from_numpy(mat.rows.astype(np.int64)).to(device),
            cols=torch.from_numpy(mat.cols.astype(np.int64)).to(device),
            vals=F.to_h16(torch.from_numpy(mat.vals_mont)).to(device),
            n_cons=mat.n_cons)


@dataclass
class ShapeDevice:
    """One circuit's constraint system, with its matrices on `device`."""

    field: F.FieldSpec
    n_cons: int
    n_vars: int   # total columns (1 + n_io + n_wit)
    n_io: int
    A: SparseMat
    B: SparseMat
    C: SparseMat
    device: torch.device = dc_field(default=torch.device("cpu"))
    dev: Dict[str, DeviceMat] = dc_field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        for name in ("A", "B", "C"):
            self.dev[name] = DeviceMat.from_sparse(getattr(self, name),
                                                   self.device)

    @property
    def n_wit(self) -> int:
        return self.n_vars - 1 - self.n_io

    @staticmethod
    def from_dsl(r1cs: R1CS, device="cpu") -> "ShapeDevice":
        spec = F.field_for(r1cs.modulus)
        mats = [_mat_from_coo(spec, rows, cols, vals, r1cs.n_constraints)
                for rows, cols, vals in (r1cs.A, r1cs.B, r1cs.C)]
        return ShapeDevice(spec, r1cs.n_constraints, r1cs.n_signals,
                           r1cs.n_io, *mats, device=device)


def spmv(spec: F.FieldSpec, mat: DeviceMat,
         z_mont: torch.Tensor) -> torch.Tensor:
    """(..., n_vars, 32) Montgomery z -> (..., n_cons, 32) Montgomery M z."""
    z = F.to_h16(z_mont)
    prod = F.h_mont_mul(spec, mat.vals, z[..., mat.cols, :])
    acc = torch.zeros(prod.shape[:-2] + (mat.n_cons, F.N_H16),
                      dtype=torch.int64, device=prod.device)
    acc.index_add_(acc.dim() - 2, mat.rows, prod)
    return F.from_h16(F.h_reduce_lazy(spec, acc))


def matvec_all(shape: ShapeDevice, z_mont: torch.Tensor):
    """(Az, Bz, Cz) for one z vector or a batch of them."""
    return tuple(spmv(shape.field, shape.dev[n], z_mont)
                 for n in ("A", "B", "C"))


def relaxed_satisfied(shape: ShapeDevice, u_mont: torch.Tensor,
                      x_mont: torch.Tensor, w_mont: torch.Tensor,
                      e_mont: torch.Tensor) -> bool:
    """Az o Bz == u * Cz + E for z = (u, X, W), all Montgomery digits."""
    spec = shape.field
    z = torch.cat([u_mont[None], x_mont, w_mont], dim=0)
    az, bz, cz = matvec_all(shape, z)
    lhs = F.mont_mul(spec, az, bz)
    rhs = F.add(spec, F.mont_mul(spec, u_mont[None], cz), e_mont)
    return bool(torch.equal(lhs, rhs))
